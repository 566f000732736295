"""BER-vs-SNR sweep harness — driver benchmark config 3 (BASELINE.json:9).

The reference's nested `for snr: for trial:` Python loops (SURVEY.md §4.5)
become one jitted program with (n_snr, n_trials) leading batch axes: every
SNR point and trial demodulates in parallel on the chip. Pre-FEC and
post-FEC BER come out of the same pass.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..channel.jax_sims import apply_fir, awgn, delay
from ..config import ModemConfig

__all__ = ["ber_sweep"]


def ber_sweep(
    modem,
    snrs_db,
    n_trials: int = 16,
    key=None,
    fir: Optional[np.ndarray] = None,
    delay_samples: int = 0,
):
    """Run the sweep → dict of numpy arrays.

    modem: gf3x.Modem. snrs_db: (S,) grid. Each (snr, trial) cell carries an
    independent random payload through modulate → [FIR] → delay → AWGN →
    demodulate_at → compare. Returns pre-FEC BER (S,), post-FEC BER (S,)
    (equal to pre-FEC when fec='none'), and frame error rate (S,).
    """
    cfg: ModemConfig = modem.cfg
    key = key if key is not None else jax.random.PRNGKey(0)
    snrs = jnp.asarray(np.asarray(snrs_db, dtype=np.float32))
    S, N = snrs.shape[0], n_trials

    kbits, knoise = jax.random.split(key)
    info = jax.random.bernoulli(
        kbits, 0.5, (S, N, cfg.payload_bits_per_frame)
    ).astype(jnp.uint8)

    @jax.jit
    def run(info, key):
        wav = modem.modulate_frames(info)                     # (S, N, T)
        if fir is not None:
            wav = apply_fir(wav, jnp.asarray(np.asarray(fir, np.float32)))
        if delay_samples:
            # room for the delayed frame: delay() preserves length, so the
            # recording must grow or the frame tail silently truncates
            wav = jnp.pad(wav, [(0, 0)] * (wav.ndim - 1) + [(0, delay_samples)])
            wav = delay(wav, delay_samples)
        rx = awgn(key, wav, snrs[:, None])
        start = jnp.full(rx.shape[:-1], delay_samples, jnp.int32)
        # one demod pass feeds both BER flavors: hard LLR decisions give the
        # pre-FEC channel-bit errors, the FEC decode of the SAME LLRs gives
        # the post-FEC errors (previously two full FFT/EQ/demap passes).
        # The comparison runs in the coded-STREAM domain: scramble and
        # interleave are position bijections, so the error count is
        # identical in either domain.
        lead = rx.shape[:-1]
        llr, _ = modem._demod_at(rx, start)
        bits, _, _, _ = modem._payload_bits(llr, lead)
        post = jnp.mean((bits != info).astype(jnp.float32), axis=(1, 2))
        fer = jnp.mean(
            jnp.any(bits != info, axis=-1).astype(jnp.float32), axis=-1)

        # pre-FEC: coded stream bits vs hard demapper decisions
        sllr = modem.coded_stream_llr(llr, lead)
        coded = modem._fec_coded_bits(info)
        pre = jnp.mean(((sllr < 0).astype(jnp.uint8) != coded).astype(jnp.float32),
                       axis=(1, 2))
        return pre, post, fer

    pre, post, fer = run(info, knoise)
    return {
        "snr_db": np.asarray(snrs),
        "ber_pre_fec": np.asarray(pre),
        "ber_post_fec": np.asarray(post),
        "fer": np.asarray(fer),
        "n_trials": N,
        "bits_per_point": N * cfg.payload_bits_per_frame,
    }
