"""OFDM layer (reference L3, SURVEY.md §2): batched real-FFT mod/demod + CP.

The reference's per-symbol IFFT loop (hot loop #1, SURVEY.md §4.1) becomes a
single batched `jnp.fft.irfft` over all symbols of all frames — one XLA FFT
over a (batch·symbols, n_fft) array (BASELINE.json north-star: "becomes a
batched XLA FFT path"). Hermitian symmetry for a real waveform is implicit
in the rfft/irfft pair. The FFTs run in full float32; only the clock-offset
demod, whose δ-warped tones have no FFT form, is a matmul (at HIGHEST
precision, so no reduced-precision pass reaches the LLRs).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..config import ModemConfig

__all__ = ["ofdm_modulate", "ofdm_demodulate", "ofdm_dft"]


def ofdm_modulate(cfg: ModemConfig, sym_bins: jnp.ndarray) -> jnp.ndarray:
    """(..., S, n_used) complex64 bin values → (..., S·(N+CP)) float32 samples.

    The used bins are a contiguous range [bin_lo, bin_hi], so spectrum
    placement is a zero-pad (concat), never a scatter. Inverse real FFT,
    symbol-RMS scaling, CP prepend, flatten.
    """
    *lead, S, _ = sym_bins.shape
    pad = [(0, 0)] * (len(lead) + 1) + [(cfg.bin_lo, cfg.n_bins - cfg.bin_hi - 1)]
    spec = jnp.pad(sym_bins.astype(jnp.complex64), pad)
    x = jnp.fft.irfft(spec, cfg.n_fft, axis=-1).astype(jnp.float32) * jnp.float32(cfg.ofdm_scale)
    with_cp = jnp.concatenate([x[..., -cfg.cp:], x], axis=-1)
    return with_cp.reshape(*lead, S * cfg.symbol_len)


def ofdm_demodulate(cfg: ModemConfig, samples: jnp.ndarray,
                    delta: jnp.ndarray | None = None) -> jnp.ndarray:
    """(..., S·(N+CP)) float32 samples → (..., S, n_used) complex64 bins.

    The reference's per-symbol FFT loop (hot loop #3, SURVEY.md §4.2) as one
    batched rfft with the CP stripped by reshape+slice; used-bin extraction
    is a contiguous slice.

    `delta` (traced SCALAR, fractional clock offset) enables the
    SFO-corrected demod: with a TX/RX clock-rate offset δ the received
    waveform is the transmitted one resampled by (1+δ), so bin k's tone sits
    at frequency k·(1+δ) on the RX sampling grid. Instead of resampling
    (a per-element gather), the used-band DFT matrix itself is warped to
    those frequencies: a matmul demod with the cos/sin tables built on
    device from δ. Exact to f32 phase rounding; the
    residual per-symbol phase ramps (window drift) are absorbed by the
    standard pilot tracking downstream.
    """
    *lead, T = samples.shape
    S = T // cfg.symbol_len
    sym = samples.reshape(*lead, S, cfg.symbol_len)[..., cfg.cp:]
    return ofdm_dft(cfg, sym, delta)


def ofdm_dft(cfg: ModemConfig, sym: jnp.ndarray,
             delta: jnp.ndarray | None = None) -> jnp.ndarray:
    """Used-band DFT of already CP-stripped symbols: (..., S, n_fft) float32
    → (..., S, n_used) complex64. The tail of `ofdm_demodulate`; the frame
    cut (`ops.sync.cut_symbols`) emits symbols in this layout directly."""
    if delta is not None:
        n = jnp.arange(cfg.n_fft, dtype=jnp.float32)[:, None]
        k = jnp.arange(cfg.bin_lo, cfg.bin_hi + 1, dtype=jnp.float32)[None, :]
        th = jnp.float32(2.0 * np.pi / cfg.n_fft) * n * k * (1.0 + delta)
        C, Sm = jnp.cos(th), jnp.sin(th)
        inv = jnp.float32(1.0 / cfg.ofdm_scale)
        hi = jax.lax.Precision.HIGHEST
        xr = sym.astype(jnp.float32)
        re = jnp.matmul(xr, C, precision=hi,
                        preferred_element_type=jnp.float32) * inv
        im = -jnp.matmul(xr, Sm, precision=hi,
                         preferred_element_type=jnp.float32) * inv
        return jax.lax.complex(re, im)
    spec = jnp.fft.rfft(sym, cfg.n_fft, axis=-1) / np.float32(cfg.ofdm_scale)
    return spec[..., cfg.bin_lo: cfg.bin_hi + 1].astype(jnp.complex64)
