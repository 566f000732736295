"""Multi-rate QC-LDPC family (rates 2/3, 3/4, 5/6 alongside 1/2).

All rates share n = 24z (24 block columns — the frame geometry and the
fused receive tail's LDPC ingest layout are rate-invariant); only
k = (24 − m_b)·z changes. Validity is construction-enforced (H·cᵀ = 0,
full-rank parity part, 4-cycle-free lifts at z₀) per the empty-reference
protocol of SURVEY.md §0; decode quality is gated by near-threshold
correction and the preset e2e tests.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from gf3x.fec.codes import RATES, _count_4cycles, base_matrix, block_rows
from gf3x.fec.ldpc import LdpcCode

NONHALF = [r for r in RATES if r != "1/2"]


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("z", [32, 96])
def test_construction_valid(rate, z):
    code = LdpcCode(z, rate)
    assert code.n == 24 * z
    assert code.k == (24 - block_rows(rate)) * z
    rng = np.random.default_rng(z)
    u = rng.integers(0, 2, size=(4, code.k), dtype=np.uint8)
    c = code.encode(u)
    assert np.array_equal(c[:, : code.k], u)          # systematic
    assert (code.check(c) == 0).all()                 # H·cᵀ = 0


@pytest.mark.parametrize("rate", RATES)
def test_girth_at_design_lift(rate):
    """The designed (and transcribed) base matrices lift 4-cycle-free at
    z₀ = 96 — girth ≥ 6, the minimum for min-sum to be trustworthy."""
    assert _count_4cycles(base_matrix(rate), 96) == 0


# per-rate Eb/N0 (dB) with decode margin: higher code rates need more SNR
_EBN0 = {"2/3": 3.2, "3/4": 4.0, "5/6": 5.2}


@pytest.mark.parametrize("rate", NONHALF)
def test_corrects_near_threshold(rate):
    """A few-percent raw channel BER must decode clean at each rate's
    operating Eb/N0 (the multi-rate analog of the rate-1/2 test)."""
    code = LdpcCode(32, rate)
    R = code.k / code.n
    rng = np.random.default_rng(hash(rate) % 2**32)
    u = rng.integers(0, 2, size=(16, code.k), dtype=np.uint8)
    c = code.encode(u)
    sigma = float(np.sqrt(1.0 / (2 * R * 10 ** (_EBN0[rate] / 10))))
    y = (1.0 - 2.0 * c) + rng.normal(0, sigma, c.shape)
    raw_ber = np.mean((y < 0) != (c == 1))
    assert 0.005 < raw_ber < 0.10                     # the test is meaningful
    bits, _ = code.decode(2 * y / sigma**2, iters=40)
    assert np.array_equal(bits, u)


@pytest.mark.parametrize("rate", [
    pytest.param("2/3", marks=pytest.mark.slow),   # 56 s
    "3/4",                                          # production multi-rate
    pytest.param("5/6", marks=pytest.mark.slow),   # 68 s
])  # slow tier re-runs all rates; kernel parity per rate: test_ldpc_kernel
def test_backends_bit_identical(rate):
    """NumPy golden ≡ XLA ≡ Triton kernel (interpret) ≡ C++ at every rate,
    on noisy LLRs with early exit (shared freeze rule)."""
    code = LdpcCode(32, rate)
    rng = np.random.default_rng(17)
    u = rng.integers(0, 2, size=(8, code.k), dtype=np.uint8)
    c = code.encode(u)
    sigma = 0.55
    y = (1.0 - 2.0 * c) + rng.normal(0, sigma, c.shape)
    llr = (2 * y / sigma**2).astype(np.float32)

    nb, it_np = code.decode(llr.astype(np.float64), iters=20)
    xb = np.asarray(code.decode_jax(jnp.asarray(llr), 20, backend="xla"))
    assert np.array_equal(xb, nb)

    # the GPU kernel's logic via the Pallas interpreter
    pb = np.asarray(code.decode_jax(jnp.asarray(llr), 20, backend="triton",
                                    interpret=True))
    assert np.array_equal(pb, nb)

    native = pytest.importorskip("gf3x.native")
    if native.available():
        cb, _ = native.NativeLdpc(32, rate=rate).decode(llr, iters=20)
        assert np.array_equal(cb, nb)


def test_rate_orders_capacity():
    """k strictly increases with rate at fixed z (more payload per frame)."""
    ks = [LdpcCode(64, r).k for r in ("1/2", "2/3", "3/4", "5/6")]
    assert ks == sorted(set(ks))


def test_encode_jax_matches_numpy_all_rates():
    for rate in NONHALF:
        code = LdpcCode(32, rate)
        rng = np.random.default_rng(23)
        u = rng.integers(0, 2, size=(4, code.k), dtype=np.uint8)
        assert np.array_equal(np.asarray(code.encode_jax(jnp.asarray(u))),
                              code.encode(u))
