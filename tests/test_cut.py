"""The frame cut (`gf3x.ops.sync.gather_cut` / `cut_symbols`) and the
bounded matched filter against plain NumPy slicing and correlation."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gf3x.ops.sync import cut_symbols, matched_filter, max_cut_start

S, N_FFT, SYM_LEN, CP, BODY_OFF, SC_OFF = 3, 64, 80, 16, 96, 20
NEED = BODY_OFF + S * SYM_LEN


def _numpy_cut(rx, starts, block):
    """The documented semantics, in NumPy: a window of whole blocks from
    floor(start/block)·block over the recording's whole-block prefix, zeros
    past it, at most two blocks of overrun; returns (syms, scw, roll)."""
    B, T = rx.shape
    nb = -(-(NEED + block) // block)
    nf = T // block
    prefix = np.zeros((B, max(nf + 2, nb) * block), np.float32)
    prefix[:, : nf * block] = rx[:, : nf * block]
    qcap = max(nf + 2 - nb, 0)
    syms = np.zeros((B, S, N_FFT), np.float32)
    scw = np.zeros((B, N_FFT), np.float32)
    roll = np.zeros(B, np.int32)
    for i, s in enumerate(starts):
        q = min(max(s // block, 0), qcap)
        w = q * block
        roll[i] = min(max(s - w, 0), block - 1)
        for k in range(S):
            a = w + BODY_OFF + k * SYM_LEN + CP
            syms[i, k] = prefix[i, a: a + N_FFT]
        scw[i] = prefix[i, w + SC_OFF: w + SC_OFF + N_FFT]
    return syms, scw, roll


@pytest.mark.parametrize("block,T,where", [
    (128, 2000, "inside"),       # ragged tail: T % block != 0
    (128, 2000, "edges"),        # start 0 and exactly max_cut_start
    (32, 1501, "inside"),        # a tiny-CP config's block
    (32, 1501, "beyond"),        # past max_cut_start: zero tail, clamp
    (128, 300, "short"),         # recording shorter than one window
])
def test_cut_symbols_matches_numpy(block, T, where):
    rng = np.random.default_rng(block + T)
    B = 6
    rx = rng.standard_normal((B, T)).astype(np.float32)
    hi = max_cut_start(T, NEED, block)
    starts = {
        "inside": rng.integers(0, max(hi, 1), B),
        "edges": np.array([0, hi, hi, 0, hi - 1, 1]),
        "beyond": rng.integers(hi + 1, T, B),
        "short": rng.integers(0, T, B),
    }[where].astype(np.int32)
    syms, scw, roll = jax.jit(lambda r, s: cut_symbols(
        r, s, S=S, n_fft=N_FFT, sym_len=SYM_LEN, cp=CP, body_off=BODY_OFF,
        sc_off=SC_OFF, block=block))(jnp.asarray(rx), jnp.asarray(starts))
    ref = _numpy_cut(rx, starts, block)
    np.testing.assert_array_equal(np.asarray(syms), ref[0])
    np.testing.assert_array_equal(np.asarray(scw), ref[1])
    np.testing.assert_array_equal(np.asarray(roll), ref[2])
    if where in ("inside", "edges"):
        # every start up to max_cut_start cuts the recording verbatim
        for i, s in enumerate(starts):
            w = s - int(roll[i])
            a = w + BODY_OFF + CP
            np.testing.assert_array_equal(np.asarray(syms)[i, 0],
                                          rx[i, a: a + N_FFT])


def test_bounded_matched_filter_matches_numpy_correlation():
    """The FFT matched filter at a shortened length equals the direct
    correlation m[n] = Σ_i x[n+i]·c[i] over the lags it is read at."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((3, 700)).astype(np.float32)
    c = rng.standard_normal(100).astype(np.float32)
    nfft = 1024                       # ≥ T: lags < nfft − len(c) are exact
    m = np.asarray(jax.jit(lambda a: matched_filter(a, c, nfft=nfft))(
        jnp.asarray(x)))
    n_lags = 600
    ref = np.stack([[np.dot(x[b, n: n + 100].astype(np.float64),
                            np.pad(c, (0, max(0, n + 100 - 700)))[: len(x[b, n: n + 100])])
                     for n in range(n_lags)] for b in range(3)])
    np.testing.assert_allclose(m[:, :n_lags], ref, atol=2e-4 * np.max(np.abs(ref)))
