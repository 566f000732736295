"""Sharding tests on the virtual 8-device CPU mesh (SURVEY.md §3.2, §6.8)."""

import numpy as np
import jax
import pytest

from gf3x import ModemConfig, Modem
from gf3x.parallel import make_mesh, shard_batch, sharded_decode, sharded_pipeline_step

TINY = ModemConfig(
    n_fft=256, cp=64, bin_lo=8, bin_hi=100,
    pilot_spacing=8, n_known_symbols=2, n_data_symbols=12,
    chirp_duration=0.02, fec="ldpc", ldpc_z=24, ldpc_iters=5,
).validate()


@pytest.fixture(scope="module")
def modem():
    return Modem(TINY)


def test_mesh_has_8_devices():
    mesh = make_mesh()
    assert mesh.devices.size == 8


def test_sharded_pipeline_step_exact(modem):
    mesh = make_mesh()
    step = sharded_pipeline_step(modem, mesh)
    rng = np.random.default_rng(0)
    B = 16
    info = rng.integers(0, 2, size=(B, TINY.payload_bits_per_frame), dtype=np.uint8)
    ber, ok, bits = step(info, jax.random.PRNGKey(1), 25.0)
    assert float(ber) == 0.0
    assert bool(ok)
    assert np.array_equal(np.asarray(bits), info)


def test_sharded_sync_decode_matches_unsharded(modem):
    mesh = make_mesh()
    rng = np.random.default_rng(1)
    B = 8
    info = rng.integers(0, 2, size=(B, TINY.payload_bits_per_frame), dtype=np.uint8)
    wav = np.asarray(jax.jit(modem.modulate_frames)(info))
    T = wav.shape[-1] + 400
    rx = np.zeros((B, T), np.float32)
    for i in range(B):
        rx[i, 100 + i: 100 + i + wav.shape[-1]] = 0.7 * wav[i]
    rx += rng.standard_normal(rx.shape).astype(np.float32) * 1e-4

    dec = sharded_decode(modem, mesh)
    bits_s, diag_s = dec(shard_batch(rx, mesh))
    bits_u, diag_u = jax.jit(modem.demodulate)(rx)
    assert np.array_equal(np.asarray(bits_s), np.asarray(bits_u))
    assert np.array_equal(np.asarray(bits_s), info)
    assert np.array_equal(np.asarray(diag_s.sync_start), np.asarray(diag_u.sync_start))


def test_ldpc_kernel_under_shard_map():
    """The LDPC kernel's `pallas_call` traced INSIDE `shard_map` over the
    batch axis (the default sharded route): the interpreter stands in for
    the GPU compile on the CPU mesh (chip_smoke.py --four runs it compiled
    on cards); what this pins is that the kernel traces under shard_map
    with per-shard local shapes and returns shard-exact values."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from gf3x.fec.ldpc import LdpcCode

    code = LdpcCode(24, "1/2")
    mesh = make_mesh()
    n = mesh.devices.size
    rng = np.random.default_rng(3)
    u = rng.integers(0, 2, size=(n, code.k), dtype=np.uint8)
    y = (1.0 - 2.0 * code.encode(u)) + rng.normal(0, 0.6, (n, code.n))
    llr = jnp.asarray((2 * y / 0.36).astype(np.float32))

    def run(l):
        return code.decode_jax(l, 12, backend="triton", interpret=True,
                               with_diag=True)

    bits_u, it_u, unsat_u = jax.jit(run)(llr)
    sharded = jax.jit(jax.shard_map(
        run, mesh=mesh, in_specs=P("dp", None),
        out_specs=(P("dp", None), P("dp"), P("dp")), check_vma=False))
    bits_s, it_s, unsat_s = sharded(llr)
    assert np.array_equal(np.asarray(bits_s), np.asarray(bits_u))
    assert np.array_equal(np.asarray(it_s), np.asarray(it_u))
    assert np.array_equal(np.asarray(unsat_s), np.asarray(unsat_u))
    assert np.array_equal(np.asarray(bits_u), u)


def test_sharded_decode_seq_axis_matches(modem):
    """The GSPMD sample-axis route (seq_axis='sp'): decodes with the XLA
    min-sum, bit-exact vs the unsharded receiver."""
    mesh2 = make_mesh(axes=("dp", "sp"), shape=(4, 2))
    rng = np.random.default_rng(5)
    B = 8
    info = rng.integers(0, 2, size=(B, TINY.payload_bits_per_frame), dtype=np.uint8)
    wav = np.asarray(jax.jit(modem.modulate_frames)(info))
    T = wav.shape[-1] + 256
    rx = np.zeros((B, T), np.float32)
    rx[:, 64: 64 + wav.shape[-1]] = 0.7 * wav
    bits_s, _ = sharded_decode(modem, mesh2, seq_axis="sp")(rx)
    assert np.array_equal(np.asarray(bits_s), info)


def test_graft_entry_dryrun():
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import __graft_entry__ as ge
    ge.dryrun_multichip(8)
    fn, args = ge.entry()
    out = jax.eval_shape(fn, *args)  # jittable + shapes resolve
    assert out[0].shape[0] == args[0].shape[0]
