"""Multi-device scaling (SURVEY.md §3.2, §6.8).

The reference is single-process NumPy with no distribution; the analog here
is pure data parallelism over independent frames: shard the frame batch
across devices and let XLA insert whatever collectives result gathering
needs.

TWO sharding routes, chosen by what they must compose with:

- **`shard_map` over the batch axes (default)** — the production route.
  Frames are embarrassingly parallel, so each device runs the COMPLETE
  single-device receiver on its local batch shard; the only collectives
  are the scalar `psum` reductions of the pipeline step's metrics. Inside
  `shard_map` the LDPC kernel (a Pallas custom call, which GSPMD cannot
  partition) sees per-shard LOCAL shapes.

- **GSPMD with the sample axis sharded (`seq_axis=...`)** — the
  long-recording analog (SURVEY.md §6.7): a single recording too large for
  one device is sharded along TIME over a second mesh axis, and GSPMD
  inserts the FFT-side collectives. Sequential DSP over a sharded sample
  axis cannot be expressed per-shard, so this route decodes with a modem
  whose LDPC runs the XLA min-sum: plain partitionable HLO, where the
  kernel's custom call would make GSPMD replicate its batch.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "shard_batch", "sharded_decode", "sharded_pipeline_step"]


def make_mesh(
    n_devices: Optional[int] = None,
    axes: tuple[str, ...] = ("dp",),
    shape: Optional[tuple[int, ...]] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a device mesh. Defaults: 1-D 'dp' axis over all local devices."""
    devs = list(devices if devices is not None else jax.devices())
    if n_devices is not None:
        devs = devs[:n_devices]
    if shape is None:
        shape = (len(devs),) if len(axes) == 1 else None
        if shape is None:
            raise ValueError("shape required for multi-axis meshes")
    arr = np.asarray(devs).reshape(shape)
    return Mesh(arr, axes)


def shard_batch(x, mesh: Mesh, axis: str = "dp"):
    """Place a host batch onto the mesh, sharded over its leading axis."""
    spec = P(axis, *([None] * (np.ndim(x) - 1)))
    return jax.device_put(x, NamedSharding(mesh, spec))


def _flat_shard_index(axes: tuple[str, ...], mesh: Mesh):
    """Row-major flat shard index over the given mesh axes (traced int32)."""
    idx = jax.lax.axis_index(axes[0])
    for a in axes[1:]:
        idx = idx * mesh.shape[a] + jax.lax.axis_index(a)
    return idx


def sharded_decode(modem, mesh: Mesh, seq_axis: Optional[str] = None):
    """Compile `modem.demodulate` sharded over the mesh. Returns
    f(rx) -> (bits, diag). rx: (B, T) float32, B divisible by the product
    of the batch axes' sizes.

    Default (`seq_axis=None`): `shard_map` over ALL mesh axes — each shard
    runs the complete receiver (LDPC kernel included, on local shapes) on
    its B/n_shards frames; zero cross-device collectives.

    `seq_axis='sp'`: GSPMD route — batch over the remaining axes, SAMPLES
    over `seq_axis` (recordings larger than one device's memory), decoded
    by a copy of the modem whose LDPC is the XLA min-sum.
    """
    if seq_axis is None:
        axes = tuple(mesh.axis_names)
        # check_vma off: the receiver's internals (LDPC while_loop carries
        # etc.) carry no varying-axis annotations, and none are needed —
        # everything inside is per-shard local
        fn = jax.shard_map(
            modem.demodulate, mesh=mesh,
            in_specs=P(axes, None), out_specs=P(axes), check_vma=False)
        return jax.jit(fn)

    from ..models import Modem

    xla_modem = Modem(modem.cfg, max_delay=modem.max_delay,
                      ldpc_backend="xla")
    batch_axes = tuple(a for a in mesh.axis_names if a != seq_axis)
    in_spec = P(batch_axes if batch_axes else None, seq_axis)
    out_spec = P(batch_axes if batch_axes else None)
    return jax.jit(
        xla_modem.demodulate,
        in_shardings=NamedSharding(mesh, in_spec),
        out_shardings=NamedSharding(mesh, out_spec),
    )


def sharded_pipeline_step(modem, mesh: Mesh, margin: int = 512):
    """The full framework step, sharded via `shard_map`: encode a bit
    batch, impair it on device (per-row random delay + AWGN via a jax
    PRNG), decode — SYNC INCLUDED (the most bandwidth-interesting stage
    under sharding) — and `psum`-reduce the pre-FEC BER across shards: the
    modem-domain analog of a distributed "training step" (SURVEY.md §6.3:
    channel impairments are the fault-injection loop). Each shard runs the
    single-device receiver on its local frames, and only the scalar
    metrics cross devices.

    Returns f(info_bits (B, payload_bits) u8, key, snr_db) ->
    (ber scalar, bits_ok scalar, decoded bits (B, payload_bits)).
    """
    from jax import numpy as jnp

    axes = tuple(mesh.axis_names)

    def local_step(info_bits, key, snr_db):
        # distinct noise per shard: fold the flat shard index into the key
        key = jax.random.fold_in(key, _flat_shard_index(axes, mesh))
        wav = modem.modulate_frames(info_bits)              # (b, frame_len)
        kd, kn = jax.random.split(key)
        pad = jnp.pad(wav, [(0, 0)] * (wav.ndim - 1) + [(0, margin)])
        delays = jax.random.randint(kd, wav.shape[:-1], 0, margin)
        rx = jax.vmap(lambda r, d: jnp.roll(r, d, axis=-1))(pad, delays)
        p = jnp.mean(rx**2, axis=-1, keepdims=True)
        nvar = p / (10.0 ** (snr_db / 10.0))
        rx = rx + jax.random.normal(kn, rx.shape, rx.dtype) * jnp.sqrt(nvar)
        bits, diag = modem.demodulate(rx)                   # chirp sync included
        nerr = jnp.sum((bits != info_bits).astype(jnp.float32))
        sync_err = jnp.max(jnp.abs(diag.sync_start - delays))
        bad = ((~jnp.all(bits == info_bits))
               | (sync_err > modem.cfg.cp // 4)).astype(jnp.int32)
        # scalar collectives only: total errors / bits / violations
        nerr = jax.lax.psum(nerr, axes)
        ntot = jax.lax.psum(jnp.float32(bits.size), axes)
        nbad = jax.lax.psum(bad, axes)
        return nerr / ntot, nbad == 0, bits

    return jax.jit(jax.shard_map(
        local_step, mesh=mesh,
        in_specs=(P(axes, None), P(), P()),
        out_specs=(P(), P(), P(axes, None)),
        check_vma=False,
    ))
