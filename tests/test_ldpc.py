"""LDPC codec tests (SURVEY.md §5 unit level: "LDPC encode/decode round-trip
at zero noise and near-threshold")."""

import numpy as np
import jax.numpy as jnp
import pytest

from gf3x.fec.ldpc import LdpcCode


@pytest.mark.parametrize("z", [32, 64, 96])
def test_construction_valid(z):
    code = LdpcCode(z)
    rng = np.random.default_rng(z)
    u = rng.integers(0, 2, size=(4, code.k), dtype=np.uint8)
    c = code.encode(u)
    assert c.shape == (4, code.n)
    assert np.array_equal(c[:, : code.k], u)          # systematic
    assert (code.check(c) == 0).all()                 # H·cᵀ = 0


def test_decode_zero_noise():
    code = LdpcCode(32)
    rng = np.random.default_rng(2)
    u = rng.integers(0, 2, size=(4, code.k), dtype=np.uint8)
    llr = (1.0 - 2.0 * code.encode(u)) * 8.0
    bits, _ = code.decode(llr, iters=5)
    assert np.array_equal(bits, u)


def test_decode_corrects_near_threshold():
    """Raw channel BER of a few % must decode clean (rate-1/2 margin)."""
    code = LdpcCode(32)
    rng = np.random.default_rng(3)
    u = rng.integers(0, 2, size=(16, code.k), dtype=np.uint8)
    c = code.encode(u)
    sigma = np.sqrt(1.0 / (2 * 10 ** (1.5 / 10)))
    y = (1.0 - 2.0 * c) + rng.normal(0, sigma, c.shape)
    raw_ber = np.mean((y < 0) != (c == 1))
    assert 0.01 < raw_ber < 0.10                      # the test is meaningful
    bits, _ = code.decode(2 * y / sigma**2, iters=30)
    assert np.array_equal(bits, u)


def test_jax_matches_numpy():
    """Same message schedule ⇒ bit-identical decodes at f32-safe LLRs."""
    code = LdpcCode(32)
    rng = np.random.default_rng(4)
    u = rng.integers(0, 2, size=(8, code.k), dtype=np.uint8)
    c = code.encode(u)
    sigma = 0.6
    y = (1.0 - 2.0 * c) + rng.normal(0, sigma, c.shape)
    llr = (2 * y / sigma**2).astype(np.float32)
    nb, _ = code.decode(llr.astype(np.float64), iters=20)
    jb = np.asarray(code.decode_jax(jnp.asarray(llr), 20))
    assert np.array_equal(jb, nb)
    assert np.array_equal(np.asarray(code.encode_jax(jnp.asarray(u))), c)


def test_batched_leading_dims():
    code = LdpcCode(32)
    rng = np.random.default_rng(5)
    u = rng.integers(0, 2, size=(2, 3, code.k), dtype=np.uint8)
    c = np.asarray(code.encode_jax(jnp.asarray(u)))
    assert c.shape == (2, 3, code.n)
    llr = ((1.0 - 2.0 * c) * 6.0).astype(np.float32)
    bits = np.asarray(code.decode_jax(jnp.asarray(llr), 5))
    assert bits.shape == (2, 3, code.k)
    assert np.array_equal(bits, u)


@pytest.mark.slow  # 84 s: cross-product breadth; per-backend parity also
# covered by tests/test_ldpc_kernel.py and chip_smoke.py on the card
def test_early_exit_matches_across_backends_and_batchings():
    """Early termination must be (a) faster — fewer message passes than the
    budget, (b) batch-independent — the per-codeword freeze rule makes each
    codeword's decode equal to decoding it alone, (c) bit-identical across
    the NumPy / XLA / Triton-kernel backends."""
    code = LdpcCode(32)
    rng = np.random.default_rng(11)
    B = 128
    u = rng.integers(0, 2, size=(B, code.k), dtype=np.uint8)
    c = code.encode(u)
    # mix of easy and hard lanes so freeze times differ wildly
    sigma = np.where(np.arange(B)[:, None] % 2 == 0, 0.4, 0.72)
    y = (1.0 - 2.0 * c) + rng.normal(0, 1.0, c.shape) * sigma
    llr = (2 * y / sigma**2).astype(np.float32)

    nb, it_run = code.decode(llr.astype(np.float64), iters=30)
    assert it_run < 30                       # actually terminated early
    assert np.array_equal(nb, u)

    jb, jit, junsat = code.decode_jax(jnp.asarray(llr), 30, backend="xla",
                                      with_diag=True)
    assert np.array_equal(np.asarray(jb), nb)
    assert int(np.max(np.asarray(jit))) == it_run
    assert not np.asarray(junsat).any()

    # the kernel's logic via the Pallas interpreter: same bits, same
    # per-codeword pass counts
    kb, kit, kunsat = code.decode_jax(jnp.asarray(llr), 30, backend="triton",
                                      interpret=True, with_diag=True)
    assert np.array_equal(np.asarray(kb), nb)
    assert np.array_equal(np.asarray(kit), np.asarray(jit))
    assert not np.asarray(kunsat).any()

    # batch-independence: each codeword alone decodes to the same bits
    for i in (0, 1, 63):
        solo, _ = code.decode(llr[i:i + 1].astype(np.float64), iters=30)
        assert np.array_equal(solo[0], nb[i])

    # early exit and the fixed-iteration schedule agree here (converged
    # lanes hold a valid codeword; unconverged lanes run the full budget)
    nb_fixed, it_fixed = code.decode(llr.astype(np.float64), iters=30,
                                     early_exit=False)
    assert it_fixed == 30
    assert np.array_equal(nb_fixed, nb)


def test_layered_converges_faster_than_flooding_budget():
    """Convergence-speed regression guard for the layered schedule: at a
    near-threshold operating point the batch converges well inside the
    iteration budget the flooding schedule needed (~20 at 2.0 dB Eb/N0)."""
    code = LdpcCode(96)
    rng = np.random.default_rng(20)
    sigma = float(np.sqrt(1.0 / (2 * 0.5 * 10 ** (2.0 / 10))))
    u = rng.integers(0, 2, (64, code.k), dtype=np.uint8)
    c = code.encode(u)
    y = (1.0 - 2.0 * c) + rng.normal(0, sigma, c.shape)
    llr = (2 * y / sigma**2).astype(np.float32)
    bits, it_run = code.decode(llr, 25)
    assert np.array_equal(bits, u)
    assert it_run <= 14, f"layered convergence regressed: {it_run} iterations"
