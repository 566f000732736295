"""The Triton LDPC kernel (`gf3x.ops.pallas.ldpc_minsum`) against its
references, the XLA min-sum and the NumPy twin.

On the CPU the kernel runs in the Pallas interpreter (its logic, padding and
per-codeword early exit), and its lowering to Triton for a CUDA GPU is
checked without a GPU; the compiled kernel on the card is covered by the
`gpu`-marked test here and by chip_smoke.py."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gf3x.fec.codes import RATES
from gf3x.fec.ldpc import LdpcCode
from gf3x.ops.pallas.ldpc_minsum import minsum_totals


def _llrs(code, B, sigma, seed):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, size=(B, code.k), dtype=np.uint8)
    y = (1.0 - 2.0 * code.encode(u)) + rng.normal(0, sigma, (B, code.n))
    return u, (2 * y / sigma**2).astype(np.float32)


def _lam(code, llr):
    return jnp.asarray(llr.reshape(llr.shape[0], 24, code.z))


@pytest.mark.parametrize("early_exit", [True, False])
@pytest.mark.parametrize("rate", RATES)
def test_kernel_matches_xla_and_numpy(rate, early_exit):
    """Interpret-mode kernel ≡ `_minsum_xla` (totals, per-codeword passes,
    unsat) ≡ the NumPy twin (bits), at every rate, with and without the
    early exit, on LLRs noisy enough that the codewords converge at
    different passes or not at all."""
    code = LdpcCode(24, rate)
    u, llr = _llrs(code, 5, 0.7, 4)
    iters = 12
    tot, it, unsat = minsum_totals(_lam(code, llr), code.z, iters,
                                   early_exit, rate, True)
    xtot, xit, xunsat = code._minsum_xla(_lam(code, llr), iters, early_exit)
    np.testing.assert_array_equal(np.asarray(tot), np.asarray(xtot))
    np.testing.assert_array_equal(np.asarray(it), np.asarray(xit))
    np.testing.assert_array_equal(np.asarray(unsat), np.asarray(xunsat))
    nb, n_it = code.decode(llr.astype(np.float64), iters, early_exit)
    kb = (np.asarray(tot).reshape(5, code.n) < 0)[:, : code.k]
    np.testing.assert_array_equal(kb, nb)
    assert int(np.max(np.asarray(it))) == n_it


@pytest.mark.parametrize("B,z", [(1, 24), (3, 24), (2, 40)])
def test_kernel_padding(B, z):
    """A single codeword, an odd batch, and a z whose lanes pad from 40 to
    64: pad lanes are masked, so bits and passes equal the XLA min-sum."""
    code = LdpcCode(z)
    u, llr = _llrs(code, B, 0.6, 7 + B)
    tot, it, unsat = minsum_totals(_lam(code, llr), z, 10, True, "1/2", True)
    xtot, xit, xunsat = code._minsum_xla(_lam(code, llr), 10, True)
    assert tot.shape == (B, 24, z) and it.shape == (B,) and unsat.shape == (B,)
    np.testing.assert_array_equal(np.asarray(tot), np.asarray(xtot))
    np.testing.assert_array_equal(np.asarray(it), np.asarray(xit))
    kb = (np.asarray(tot).reshape(B, code.n) < 0)[:, : code.k]
    np.testing.assert_array_equal(kb, u)


def test_straggler_holds_back_only_itself():
    """One undecodable codeword in a batch: the others' bits and pass counts
    equal those of the batch without it, and only the straggler runs the
    whole budget and stays unsatisfied."""
    code = LdpcCode(24)
    u, llr = _llrs(code, 4, 0.55, 21)
    rng = np.random.default_rng(5)
    bad = rng.normal(0, 1.0, (1, code.n)).astype(np.float32)
    both = np.concatenate([llr[:2], bad, llr[2:]])
    iters = 15
    bits_b, it_b, un_b = code.decode_jax(jnp.asarray(both), iters,
                                         backend="triton", interpret=True,
                                         with_diag=True)
    bits_c, it_c, un_c = code.decode_jax(jnp.asarray(llr), iters,
                                         backend="triton", interpret=True,
                                         with_diag=True)
    keep = [0, 1, 3, 4]
    np.testing.assert_array_equal(np.asarray(bits_b)[keep], np.asarray(bits_c))
    np.testing.assert_array_equal(np.asarray(it_b)[keep], np.asarray(it_c))
    assert int(it_b[2]) == iters and bool(un_b[2])
    assert int(np.max(np.asarray(it_c))) < iters and not np.asarray(un_c).any()
    np.testing.assert_array_equal(np.asarray(bits_c), u)


def _lowered_text(fn, x, platform):
    return jax.jit(fn).trace(x).lower(lowering_platforms=(platform,)).as_text()


@pytest.mark.parametrize("platform,kernel", [("cpu", False), ("cuda", True)])
def test_default_backend_follows_lowering_platform(platform, kernel):
    """backend=None lowers the Triton kernel for a CUDA GPU and the XLA
    min-sum for the CPU — decided per lowering platform, not per host."""
    code = LdpcCode(24)
    x = jnp.zeros((2, code.n), jnp.float32)
    text = _lowered_text(lambda l: code.decode_jax(l, 5), x, platform)
    assert ("__gpu$xla.gpu.triton" in text) == kernel


def test_kernel_refused_off_gpu_outside_interpret():
    code = LdpcCode(24)
    x = jnp.zeros((2, code.n), jnp.float32)
    with pytest.raises(ValueError, match="interpret"):
        jax.jit(lambda l: code.decode_jax(l, 5, backend="triton"))(x)
    with pytest.raises(ValueError, match="unknown LDPC backend"):
        code.decode_jax(x, 5, backend="pallas")


@pytest.mark.parametrize("rate", RATES)
def test_kernel_lowers_to_triton_at_bench_geometry(rate):
    """The kernel's Pallas → Triton lowering at the production lifting
    factor (z = 96, 4096 codewords), checked on the CPU: unsupported
    operations or shapes in the kernel body fail here, not on the card."""
    code = LdpcCode(96, rate)
    x = jax.ShapeDtypeStruct((4096, 24, 96), jnp.float32)
    text = _lowered_text(
        lambda l: minsum_totals(l, 96, 25, True, rate), x, "cuda")
    assert "__gpu$xla.gpu.triton" in text and "ldpc_minsum" in text
    assert code.n == 24 * 96


@pytest.mark.gpu
def test_compiled_kernel_matches_xla_on_gpu(gpu):
    """On the card: the compiled kernel's bits equal the XLA min-sum's and
    its totals agree to FMA rounding."""
    code = LdpcCode(96)
    u, llr = _llrs(code, 256, 0.8, 9)
    kb, kit, _ = code.decode_jax(jnp.asarray(llr), 25, backend="triton",
                                 with_diag=True)
    xb, xit, _ = code.decode_jax(jnp.asarray(llr), 25, backend="xla",
                                 with_diag=True)
    np.testing.assert_array_equal(np.asarray(kb), np.asarray(xb))
    np.testing.assert_array_equal(np.asarray(kit), np.asarray(xit))
