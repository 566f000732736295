"""Native C++ LDPC codec: build, correctness, and cross-parity with the
JAX decoder (the independent-oracle role of the genre's C `ldpc` library,
SURVEY.md §3.1)."""

import numpy as np
import jax.numpy as jnp
import pytest

from gf3x.fec.ldpc import LdpcCode

native = pytest.importorskip("gf3x.native")
if not native.available():
    pytest.skip("native toolchain unavailable", allow_module_level=True)


@pytest.fixture(scope="module")
def pair():
    return LdpcCode(32), native.NativeLdpc(32)


def test_native_encode_matches_python(pair):
    code, nat = pair
    rng = np.random.default_rng(0)
    u = rng.integers(0, 2, size=(8, code.k), dtype=np.uint8)
    assert np.array_equal(nat.encode(u), code.encode(u))


def test_native_decode_zero_noise(pair):
    code, nat = pair
    rng = np.random.default_rng(1)
    u = rng.integers(0, 2, size=(4, code.k), dtype=np.uint8)
    llr = ((1.0 - 2.0 * code.encode(u)) * 8.0).astype(np.float32)
    bits, ok = nat.decode(llr, iters=5)
    assert ok == 4
    assert np.array_equal(bits, u)


def test_native_corrects_and_matches_jax(pair):
    """Same float32 schedule ⇒ the C++ and JAX decoders agree bit-for-bit."""
    code, nat = pair
    rng = np.random.default_rng(2)
    u = rng.integers(0, 2, size=(16, code.k), dtype=np.uint8)
    c = code.encode(u)
    sigma = 0.72
    y = (1.0 - 2.0 * c) + rng.normal(0, sigma, c.shape)
    llr = (2 * y / sigma**2).astype(np.float32)
    nb, ok = nat.decode(llr, iters=20)
    jb = np.asarray(code.decode_jax(jnp.asarray(llr), 20, backend="xla"))
    assert np.array_equal(nb, jb)
    assert np.array_equal(nb, u)
    assert ok == 16


def test_native_reports_failures(pair):
    _, nat = pair
    rng = np.random.default_rng(3)
    junk = rng.standard_normal((4, nat.n)).astype(np.float32)
    _, ok = nat.decode(junk, iters=5)
    assert ok < 4
