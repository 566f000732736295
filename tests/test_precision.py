"""Precision of the float32 linear algebra on the decode path.

On a GPU a float32 matmul at default precision may run in TF32 (a 10-bit
mantissa, an error floor near −60 dB) — which would reach Ĥ, the clock
estimate and the LLRs. These tests pin the precision each product is
lowered with and check the float32 results against float64."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gf3x import GF3_STANDARD
from gf3x.config import layout
from gf3x.ops.chanest import denoise_projection, estimate_channel, isi_profile
from gf3x.ops.ofdm import ofdm_dft
from gf3x.ops.sfo import sc_clock_offset

CFG = GF3_STANDARD
U = CFG.n_used


def _db(err, ref):
    return 10 * np.log10(np.sum(np.abs(err) ** 2) / np.sum(np.abs(ref) ** 2))


def _rand_c(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def test_demod_dft_floor_against_float64():
    """The used-band demod DFT (an rfft) stays ≥ 80 dB under the signal
    against a float64 DFT of the same float32 symbols — the gate chip_smoke
    applies on the card."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((8, 5, CFG.n_fft)).astype(np.float32)
    Y = np.asarray(jax.jit(lambda s: ofdm_dft(CFG, s))(jnp.asarray(x)))
    n = np.arange(CFG.n_fft)[:, None]
    k = np.arange(CFG.bin_lo, CFG.bin_hi + 1)[None, :]
    ref = x.astype(np.float64) @ (np.exp(-2j * np.pi * n * k / CFG.n_fft)
                                  / CFG.ofdm_scale)
    assert _db(Y - ref, ref) <= -80.0


def test_h_projection_against_float64():
    """The denoised Ĥ (tap projection at pinned precision) against the same
    projection in float64."""
    rng = np.random.default_rng(2)
    K = CFG.n_known_symbols
    X = layout(CFG).known_syms
    H_true = _rand_c(rng, (4, U))
    known = (H_true[:, None, :] * X[None] + 0.01 * _rand_c(rng, (4, K, U)))
    H, _ = jax.jit(lambda y: estimate_channel(CFG, y))(jnp.asarray(known))
    # float64 twin of the same estimate: LS mean, bulk-delay ramp, project
    H_ls = np.mean(known.astype(np.complex128) / X, axis=-2)
    kk = np.arange(CFG.bin_lo, CFG.bin_hi + 1)
    a = np.angle(np.sum(H_ls[:, 1:] * np.conj(H_ls[:, :-1]), axis=-1))
    s_hat = np.round(-a * CFG.n_fft / (2 * np.pi))
    r0 = (s_hat - CFG.est_taps // 4)[:, None]
    ramp = np.exp(2j * np.pi * kk * r0 / CFG.n_fft)
    P = denoise_projection(CFG).astype(np.complex128)
    ref = ((H_ls * ramp) @ P.T) * np.conj(ramp)
    assert _db(np.asarray(H) - ref, ref) <= -90.0


def _sc_offset(w):
    return sc_clock_offset(CFG, w)


def _isi(h):
    return isi_profile(CFG, h, jnp.ones(h.shape[:-1], jnp.float32))[0]


def _est(y):
    return estimate_channel(CFG, y)[0]


def _warped_dft(s):
    return ofdm_dft(CFG, s, jnp.float32(1e-4))


@pytest.mark.parametrize("fn,shape,dtype", [
    (_est, (2, CFG.n_known_symbols, U), np.complex64),   # Ĥ tap projection
    (_isi, (2, U), np.complex64),                         # ISI operator
    (_sc_offset, (2, CFG.n_fft), np.float32),             # SC clock DFT
    (_warped_dft, (2, 3, CFG.n_fft), np.float32),         # δ-warped demod
], ids=["h_projection", "isi_operator", "sc_clock_dft", "warped_dft"])
def test_decode_path_matmuls_pinned_highest(fn, shape, dtype):
    """Every dot these stages lower to carries HIGHEST precision, so no
    platform default (TF32 on a GPU) can apply."""
    text = jax.jit(fn).lower(jax.ShapeDtypeStruct(shape, dtype)).as_text()
    dots = [ln for ln in text.splitlines() if "dot_general" in ln]
    assert dots, "no matmul found"
    assert all("HIGHEST" in ln for ln in dots), dots
