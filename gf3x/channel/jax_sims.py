"""Device-side channel impairments (jnp mirrors of `gf3x.channel.sims`).

Used by the on-device BER sweep (config 3, BASELINE.json:9) and the sharded
pipeline step: the whole sweep — modulate → impair → demodulate → count —
runs as one XLA program with (snr, trial) batch axes, so the channel
simulator must be jittable (SURVEY.md §6.3: impairments are the framework's
fault injection).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["awgn", "apply_fir", "delay", "clip"]


def awgn(key, x: jnp.ndarray, snr_db: jnp.ndarray) -> jnp.ndarray:
    """Add white Gaussian noise at snr_db relative to x's mean power.
    snr_db may carry leading batch axes broadcastable against x's."""
    p = jnp.mean(x**2, axis=-1, keepdims=True)
    nvar = p / (10.0 ** (jnp.asarray(snr_db)[..., None] / 10.0))
    return x + jax.random.normal(key, x.shape, x.dtype) * jnp.sqrt(nvar)


def apply_fir(x: jnp.ndarray, h: jnp.ndarray) -> jnp.ndarray:
    """Multipath: convolve (..., T) with impulse response h (L,), same-length
    output (truncated to T; the tail past the recording is lost anyway)."""
    T = x.shape[-1]
    n = T + h.shape[-1] - 1
    nfft = 1 << (n - 1).bit_length()
    X = jnp.fft.rfft(x, nfft, axis=-1)
    Hf = jnp.fft.rfft(h, nfft)
    y = jnp.fft.irfft(X * Hf, nfft, axis=-1)
    return y[..., :T].astype(x.dtype)


def delay(x: jnp.ndarray, n: int) -> jnp.ndarray:
    """Static delay by n samples (length preserved)."""
    pad = [(0, 0)] * (x.ndim - 1) + [(n, 0)]
    return jnp.pad(x, pad)[..., : x.shape[-1]]


def clip(x: jnp.ndarray, limit: float = 1.0) -> jnp.ndarray:
    return jnp.clip(x, -limit, limit)
