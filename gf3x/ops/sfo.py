"""Sampling-clock offset (SFO) estimation — reference L4/L5 robustness
(SURVEY.md:133 "fractional CFO from ∠P", :399 `CFO = ∠P/(πT_half)`).

The acoustic channel has no carrier, so the genre's "carrier frequency
offset" manifests as a CLOCK-RATE offset between the TX DAC and RX ADC
(what `gf3x.channel.resample_sfo` simulates): the received waveform is the
transmitted one resampled by (1 + δ). Two estimators, coarse → fine:

1. `sc_clock_offset` — the Schmidl–Cox adaptation: the SC symbol's two
   identical halves arrive with a relative time shift τ = δ·(N/2) samples.
   For the real passband signal ∠P of the raw sample product is 0/π, so the
   phase is read in the frequency domain instead: each occupied half-grid
   bin q sees Y₂[q] = Y₁[q]·e^{jθ q} with θ ∝ τ — a per-bin phase SLOPE,
   estimated unwrap-free from adjacent-bin increments (the complex-domain
   equivalent of ∠P/(πT_half), per-bin). Unambiguous to |δ| ≈ ±1/n_fft
   (≈ ±980 ppm at N=1024) and usable far beyond the plain receiver's
   tolerance — the coarse stage of the correction loop.

2. `slope_clock_offset` — the fine estimator: per-symbol pilot phase slopes
   (rad/bin) are each 2π·(window shift)/N, and under SFO the shift grows
   linearly with symbol position — a closed-form regression of slope vs
   symbol index over the whole frame (baseline D·symbol_len samples, ~50×
   the SC half-symbol baseline).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..config import ModemConfig, layout

__all__ = ["sc_clock_offset", "slope_clock_offset", "SLOPE_PPM_RANGE",
           "auto_retry_needed", "prefer_retry"]

#: |δ| (in ppm) beyond which the per-symbol pilot-slope fit starts aliasing
#: on GF3-like geometry — measured: accurate to ~±400 ppm, collapses ~±600.
#: Used as the "switch to the correction loop" threshold.
SLOPE_PPM_RANGE = 350.0


def auto_retry_needed(crc_ok: bool, clock_ppm) -> bool:
    """The sfo='auto' retry trigger, shared by every decode path (Modem,
    streaming windows, golden twin — one definition so the policy cannot
    fork): retry through the correction loop when the plain decode failed
    CRC or reported a clock offset beyond the plain receiver's reliable
    range. `clock_ppm` may be a scalar or a per-row array (host side)."""
    if not crc_ok:
        return True
    return float(np.max(np.abs(np.asarray(clock_ppm)))) > SLOPE_PPM_RANGE


def prefer_retry(plain_crc_ok: bool, retry_crc_ok: bool) -> bool:
    """Keep the corrected decode unless it failed while the plain one
    succeeded (the shared merge rule of the sfo='auto' policy)."""
    return bool(retry_crc_ok) or not plain_crc_ok


@functools.lru_cache(maxsize=None)
def _sc_half_tables(cfg: ModemConfig):
    """Host DFT tables of the SC symbol's occupied bins on the HALF grid.

    Full-grid even bin k (the only bins the SC symbol occupies — config
    Layout.sc_sym) is bin q = k/2 of an (N/2)-point transform of one half.
    The analysis windows are GUARDED: length half − 2·guard, skipping
    `guard` samples at each end, so the half-periodicity the estimator
    relies on survives ±guard samples of window misalignment (the chirp
    MF start shifts by ~δ·6700 samples on a warped chirp — LFM
    delay/Doppler coupling — which otherwise biased the estimate ~3×).
    Returns (C (L, nq), S (L, nq), q (nq,), guard) hosts.
    """
    lay = layout(cfg)
    half = cfg.n_fft // 2
    guard = half // 4
    L = half - 2 * guard
    used = lay.used_bins
    q = (used[(used % 2) == 0] // 2).astype(np.float64)          # (nq,)
    n = np.arange(L, dtype=np.float64)[:, None]
    th = 2.0 * np.pi * n * q[None, :] / half
    return (np.cos(th).astype(np.float32), np.sin(th).astype(np.float32),
            q.astype(np.float32), guard)


def sc_clock_offset(cfg: ModemConfig, sc_win: jnp.ndarray,
                    pool: bool = False) -> jnp.ndarray:
    """Coarse SFO from the SC symbol window. sc_win (..., n_fft) → δ̂ (...,).

    δ̂ is the fractional clock offset (δ̂·1e6 = ppm). Sign convention matches
    `gf3x.channel.resample_sfo`: positive δ ⇒ the RX clock runs slow, the
    waveform is compressed and per-bin phase advances. Accuracy ~±10% of δ
    plus a noise floor of ~±100 ppm at 18 dB SNR — a coarse stage whose
    residual lands inside `slope_clock_offset`'s range.

    `pool=True` coherently sums the per-bin correlation ρ across ALL
    leading axes before the phase extraction → one scalar δ̂. For
    repeated receptions of a frame through the SAME physical clock pair
    (HARQ chase combining) the ρ phases align across receptions, so
    pooling buys the full √R estimator-SNR gain — per-reception estimates
    at deep-below-cliff SNR fail nonlinearly (sign flips), which no
    after-the-fact median can repair.
    """
    C, S, q, guard = _sc_half_tables(cfg)
    half = cfg.n_fft // 2
    L = half - 2 * guard
    h1 = sc_win[..., guard: guard + L]
    h2 = sc_win[..., guard + half: guard + half + L]
    Cj, Sj = jnp.asarray(C), jnp.asarray(S)
    # Y = Σ_n h[n]·e^{-2πiqn/half} as two real matmuls per half, at
    # HIGHEST: a default-precision float32 matmul may run in TF32 on a GPU
    def dft(h, W):
        return jnp.matmul(h, W, precision=jax.lax.Precision.HIGHEST)

    y1 = jax.lax.complex(dft(h1, Cj), -dft(h1, Sj))
    y2 = jax.lax.complex(dft(h2, Cj), -dft(h2, Sj))
    rho = jnp.conj(y1) * y2                                      # (..., nq)
    if pool:
        rho = jnp.sum(rho.reshape(-1, rho.shape[-1]), axis=0)    # (nq,)
    # unwrap-free phase slope over q: coarse from adjacent increments
    # (occupied q are 1 apart: full-grid even bins are 2 apart), refined on
    # a quarter-band baseline — the same ladder idea as pilot tracking
    inc = rho[..., 1:] * jnp.conj(rho[..., :-1])
    dq = np.float32(np.mean(np.diff(q)))
    a = jnp.angle(jnp.sum(inc, axis=-1)) / dq                    # rad per q
    nq = q.shape[0]
    Q = max(2, nq // 4)
    qj = jnp.asarray(q)
    zd = rho * jnp.exp(-1j * a[..., None] * qj)
    corr = jnp.sum(zd[..., Q:] * jnp.conj(zd[..., :-Q]), axis=-1)
    base = np.float32(np.mean(q[Q:] - q[:-Q]))
    a = a + jnp.angle(corr) / base
    # phase slope a = 2πτ/half  (shift theorem on the half grid), τ = δ·half
    tau = a * np.float32(half / (2.0 * np.pi))
    return tau / np.float32(half)


def slope_clock_offset(cfg: ModemConfig, slopes: jnp.ndarray) -> jnp.ndarray:
    """Fine SFO from per-symbol pilot phase slopes (..., D) rad/bin → (...,).

    slope_d = 2π·shift_d/N with shift_d = shift₀ + δ·symbol_len·d: a
    closed-form least-squares line through (d, slope_d) gives δ̂.
    """
    D = cfg.n_data_symbols
    if D < 2:
        # a single point fixes no line — report 0 rather than 0/0 NaN
        return jnp.zeros(slopes.shape[:-1], jnp.float32)
    d = jnp.arange(D, dtype=jnp.float32)
    dc = d - jnp.mean(d)
    a = jnp.sum(dc * slopes, axis=-1) / jnp.sum(dc * dc)         # rad/bin per sym
    return a * np.float32(cfg.n_fft / (2.0 * np.pi * cfg.symbol_len))



