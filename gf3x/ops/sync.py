"""Frame synchronization (reference L4, SURVEY.md §2): chirp matched filter
and Schmidl–Cox, as jittable batched ops.

The reference's O(T·len(chirp)) correlation loop (hot loop #2, SURVEY.md
§4.2 — "dominates wall-clock on long recordings") becomes one batched
frequency-domain cross-correlation: irfft(rfft(rx)·conj(rfft(chirp))) with a
static padded length, then an argmax peak-pick and a first-arrival
refinement — all static-shape, so the whole sync runs as a single fused XLA
program over a (batch, T) recording block.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..config import ModemConfig

__all__ = [
    "matched_filter",
    "matched_filter_spec",
    "streaming_matched_filter",
    "gather_cut",
    "cut_symbols",
    "max_cut_start",
    "find_frame_start",
    "schmidl_cox_metric",
    "sc_metric_at",
    "sc_metric_window",
    "sync_nfft",
    "bounded_sync_nfft",
    "rx_spectrum",
    "extract_windows_spec",
]


def _next_pow2(n: int) -> int:
    return 1 << int(np.ceil(np.log2(max(2, n))))


def sync_nfft(T: int, chirp_len: int) -> int:
    """Static FFT length for linear (non-circular) correlation."""
    return _next_pow2(T + chirp_len)


def bounded_sync_nfft(T: int, search_len: int, chirp_len: int,
                      decimate: int = 1) -> int:
    """The correlation FFT length `find_frame_start` uses for a bounded
    (and optionally decimated) search on a length-T recording — exported so
    consumers that account its cost (bench.py's FLOPs model) cannot drift
    from the implementation. Only lags < search_len are read, so the length
    is next_pow2(max(len(seg), n_lags + len(chirp))) — wraparound-free for
    every read lag and, in the streaming case, HALF the general linear
    length next_pow2(T + chirp)."""
    S = min(search_len, T)
    seg_len = min(S + chirp_len, T)
    if decimate > 1:
        seg_len = -(-seg_len // decimate)
        chirp_len = -(-chirp_len // decimate)
        n_lags = min(S // decimate, seg_len)
    else:
        n_lags = min(S, seg_len)
    return _next_pow2(max(seg_len, n_lags + chirp_len))


def rx_spectrum(rx: jnp.ndarray, nfft: int) -> jnp.ndarray:
    """rfft of the recording at the sync FFT length — computed once and
    shared by the matched filter and the frame-window extraction."""
    return jnp.fft.rfft(rx, nfft, axis=-1)


def matched_filter_spec(R: jnp.ndarray, chirp: np.ndarray, T: int, nfft: int) -> jnp.ndarray:
    """Matched filter from a precomputed spectrum R = rfft(rx, nfft)."""
    c_f = jnp.asarray(np.conj(np.fft.rfft(chirp, nfft)).astype(np.complex64))
    M = jnp.fft.irfft(R * c_f, nfft, axis=-1)
    return M[..., :T].astype(jnp.float32)


def matched_filter(rx: jnp.ndarray, chirp: np.ndarray,
                   nfft: int | None = None) -> jnp.ndarray:
    """m[n] = Σ_i rx[n+i]·c[i] via FFT cross-correlation (SURVEY.md Appendix).

    rx: (..., T) float32; chirp: host constant. Returns (..., T) float32.
    The default FFT length is a static power of two ≥ T+len(chirp) (linear,
    not circular, correlation at every lag). An explicit smaller `nfft`
    (≥ T) halves the transforms when the caller only reads lags
    n ≤ nfft − len(chirp) — beyond that the circular wraparound corrupts
    the tail (the bounded-search sync path's case).
    """
    T = rx.shape[-1]
    if nfft is None:
        nfft = sync_nfft(T, len(chirp))
    return matched_filter_spec(jnp.fft.rfft(rx, nfft, axis=-1), chirp, T, nfft)


def bounded_mf_shape(T: int, search_len: int, chirp_len: int,
                     decimate: int = 2) -> tuple[int, int]:
    """Static geometry of the bounded matched filter that
    `find_frame_start(search_len=..., decimate=...)` runs on a (..., T)
    recording: (seg_len, n_lags) — the correlated prefix length and the
    candidate lags, both after decimation. Exported so perf accounting
    (bench.py's bytes model) describes the same geometry as the
    implementation instead of a private copy that can drift."""
    S = min(search_len, T)
    seg_len = -(-min(S + chirp_len, T) // decimate)
    return seg_len, min(S // decimate, seg_len)


def streaming_matched_filter(rx: jnp.ndarray, chirp: np.ndarray,
                             chunk: int = 1 << 15) -> jnp.ndarray:
    """Overlap-save matched filter: the unbounded-recording sync path
    (SURVEY.md §6.7 — "overlap-save FFT cross-correlation ... fixed-size
    chunks, running state carried in a lax.scan").

    Identical output to `matched_filter` (up to FFT rounding) but works in
    fixed-size segments: memory is O(chunk + chirp) regardless of recording
    length, instead of one next-pow2(T) FFT workspace. rx: (..., T) → (..., T).
    """
    *lead, T = rx.shape
    L = len(chirp)
    n_chunks = -(-T // chunk)
    F = _next_pow2(chunk + L)
    c_f = jnp.asarray(np.conj(np.fft.rfft(chirp, F)).astype(np.complex64))
    pad = n_chunks * chunk + L - T
    rx_pad = jnp.pad(rx, [(0, 0)] * len(lead) + [(0, pad)])

    def body(carry, i):
        seg = jax.lax.dynamic_slice_in_dim(rx_pad, i * chunk, chunk + L, axis=-1)
        m = jnp.fft.irfft(jnp.fft.rfft(seg, F, axis=-1) * c_f, F, axis=-1)
        return carry, m[..., :chunk].astype(jnp.float32)

    _, ms = jax.lax.scan(body, 0, jnp.arange(n_chunks))
    # scan stacks on axis 0 → (n_chunks, ..., chunk); move chunks last
    ms = jnp.moveaxis(ms, 0, -2).reshape(*lead, n_chunks * chunk)
    return ms[..., :T]


def extract_windows_spec(
    R: jnp.ndarray, starts: jnp.ndarray, need: int, nfft: int
) -> jnp.ndarray:
    """Cut rx[start : start+need] per row from the precomputed spectrum.

    The shift theorem does the data-dependent slice as an elementwise phase
    ramp + one irfft: rolling rx left by `start` (y[n] = x[n+start])
    multiplies bin k by exp(+2πik·start/nfft), reusing the sync spectrum.

    The ramp index start·k is reduced mod nfft in *integer* arithmetic
    before touching float32 (start·k reaches 2⁴⁴ on minute-long recordings
    — float32 would corrupt the phase by ~0.7 rad). nfft is a power of two,
    so the wrapping uint32 product already holds the low bits exactly.
    """
    assert nfft & (nfft - 1) == 0, "nfft must be a power of two"
    k = jnp.arange(R.shape[-1], dtype=jnp.uint32)
    s = starts.astype(jnp.uint32)[..., None]
    m = (s * k) & jnp.uint32(nfft - 1)           # (start·k) mod nfft, exact
    ang = jnp.float32(2.0 * np.pi / nfft) * m.astype(jnp.float32)
    rolled = jnp.fft.irfft(R * jax.lax.complex(jnp.cos(ang), jnp.sin(ang)),
                           nfft, axis=-1)
    return rolled[..., :need].astype(jnp.float32)


#: Blocks a `gather_cut` window may run past the recording's whole-block
#: prefix (read as zeros): nb·block < need + 2·block, so two blocks cover
#: every start `max_cut_start` allows.
_OVERRUN_BLOCKS = 2


def gather_cut(rx: jnp.ndarray, starts: jnp.ndarray, need: int,
               block: int = 128) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Block-aligned coarse cut: (win (..., nb·block), r (...,)).

    `win` starts at floor(start/block)·block — i.e. r = start − win_start ∈
    [0, block) samples EARLY — and covers ≥ start+need. The cut is one
    contiguous (nb, block) dynamic slice per row over the block axis (a
    coalesced gather of whole blocks), and the misalignment r is returned
    for the consumer to absorb: an OFDM demod folds it into a post-FFT
    phase ramp (the CP absorbs the window shift), so no FFT pair is needed
    in the cut at all (`extract_windows_spec` remains for consumers that
    need the exact time-domain window).

    BOUNDARY SEMANTICS: the cut reads only the whole-block PREFIX of the
    recording — any window samples falling in the ragged tail
    [floor(T/block)·block, T) or beyond read as ZEROS (not the recording's
    tail samples). A window may run at most two blocks past that prefix,
    which covers every start up to `max_cut_start(T, need, block)`; later
    starts clamp to the last such window (r saturates at block − 1).
    """
    *lead, T = rx.shape
    nb = -(-(need + block) // block)
    nf = T // block                                    # whole blocks in rx
    sflat = jnp.broadcast_to(starts.astype(jnp.int32), tuple(lead)).reshape(-1)
    rx2 = rx.reshape(-1, T)
    qcap = nf + _OVERRUN_BLOCKS - nb
    if qcap < 0:
        # recording shorter than the window: zero-pad to one window and cut
        # at block 0 (tiny-input fallback; decode is degenerate here anyway)
        rxp = jnp.pad(rx2, ((0, 0), (0, nb * block - T)))
        win = rxp.reshape(*lead, nb * block)
        r = jnp.clip(sflat, 0, block - 1).reshape(tuple(lead))
        return win, r
    q = jnp.clip(sflat // block, 0, qcap)
    rxp = jnp.pad(rx2[:, : nf * block], ((0, 0), (0, _OVERRUN_BLOCKS * block)))
    xb = rxp.reshape(-1, nf + _OVERRUN_BLOCKS, block)
    g = jax.vmap(
        lambda row, s: jax.lax.dynamic_slice(row, (s, 0), (nb, block))
    )(xb, q)
    win = g.reshape(*lead, nb * block)
    r = jnp.clip(sflat - q * block, 0, block - 1).reshape(tuple(lead))
    return win, r


def cut_symbols(rx: jnp.ndarray, starts: jnp.ndarray, *, S: int, n_fft: int,
                sym_len: int, cp: int, body_off: int, sc_off: int,
                block: int = 128):
    """Frame cut + CP strip: (syms (..., S, n_fft), scw (..., n_fft) or
    None, roll (...,)).

    Symbol s of row i is rx[i, w + body_off + s·sym_len + cp :][:n_fft]
    with w = floor(start/block)·block (roll = start − w, for the consumer's
    post-FFT phase ramp, exactly as `gather_cut`); scw is the n_fft window
    at w + sc_off (None when sc_off < 0). Same boundary rule as
    `gather_cut`.
    """
    *lead, _ = rx.shape
    need = max(body_off + S * sym_len, (sc_off + n_fft) if sc_off >= 0 else 0)
    win, r = gather_cut(rx, starts, need, block)
    body = win[..., body_off: body_off + S * sym_len]
    syms = body.reshape(*lead, S, sym_len)[..., cp: cp + n_fft]
    scw = win[..., sc_off: sc_off + n_fft] if sc_off >= 0 else None
    return syms, scw, r


def max_cut_start(T: int, need: int, block: int = 128) -> int:
    """Largest window start for which `gather_cut(rx, starts, need, block)`
    returns all `need` samples verbatim on a length-T recording: the cut
    reads whole blocks of the recording prefix, so the last partial
    block's ≤ block−1 samples read as zeros. Callers clamp their cut base
    to it."""
    return max((T // block) * block - need, 0)


def find_frame_start(cfg: ModemConfig, rx: jnp.ndarray, chirp: np.ndarray,
                     R: jnp.ndarray | None = None, nfft: int | None = None,
                     search_len: int | None = None, decimate: int = 1):
    """Chirp sync: (..., T) recording → (start (...,) int32, metric (...,) f32).

    argmax |m| then first-arrival refinement: earliest tap within 6 dB of
    the peak in the preceding CP-length window (multipath robustness —
    the strongest correlation tap can be a reflection). Mean |m| stands in
    for the golden model's median in the peak metric (no O(T log T) sort on
    device; both are floor estimates of the correlation noise).

    Pass R = rfft(rx, nfft) to reuse a precomputed spectrum. `search_len`
    (static) bounds the candidate onset to [0, search_len): the correlation
    then runs on the static prefix rx[:search_len + chirp_len] with a
    correspondingly small FFT — the streaming receiver's case, where a
    frame is known to arrive within the current chunk. `decimate` (static,
    only with search_len) correlates every decimate-th sample — valid when
    the chirp band fits the decimated Nyquist; timing granularity becomes
    `decimate` samples, absorbed by the CP backoff.
    """
    if search_len is not None:
        S = min(search_len, rx.shape[-1])
        seg = rx[..., : min(S + len(chirp), rx.shape[-1])]
        # only lags < S (/decimate) are candidates → wraparound-free FFT of
        # bounded_sync_nfft's length (half the general linear size in the
        # streaming case)
        F = bounded_sync_nfft(rx.shape[-1], search_len, len(chirp), decimate)
        if decimate > 1:
            seg = seg[..., ::decimate]
            c_d = chirp[::decimate]
            n_lags = min(S // decimate, seg.shape[-1])
            mabs_d = jnp.abs(matched_filter(seg, c_d, nfft=F))[..., :n_lags]
            peak = jnp.argmax(mabs_d, axis=-1).astype(jnp.int32)
            peak_val = jnp.max(mabs_d, axis=-1)
            start = _first_arrival(mabs_d, peak, peak_val,
                                   cfg.cp // decimate)
            metric = peak_val / (jnp.mean(mabs_d, axis=-1) + 1e-12)
            return (decimate * start).astype(jnp.int32), metric
        n_lags = min(S, seg.shape[-1])
        mabs = jnp.abs(matched_filter(seg, chirp, nfft=F))[..., :n_lags]
    elif R is not None:
        mabs = jnp.abs(matched_filter_spec(R, chirp, rx.shape[-1], nfft))
    else:
        mabs = jnp.abs(matched_filter(rx, chirp))
    peak = jnp.argmax(mabs, axis=-1).astype(jnp.int32)
    peak_val = jnp.max(mabs, axis=-1)
    start = _first_arrival(mabs, peak, peak_val, cfg.cp)
    metric = peak_val / (jnp.mean(mabs, axis=-1) + 1e-12)
    return start, metric


def _first_arrival(mabs: jnp.ndarray, peak: jnp.ndarray,
                   peak_val: jnp.ndarray, back: int) -> jnp.ndarray:
    """Earliest tap within 6 dB of the peak in the `back`-wide window before
    it (multipath: the strongest correlation tap can be a reflection).

    One masked argmax over the full correlation — argmax returns the FIRST
    True: a fused elementwise pass over data the peak search already
    touched, with no per-row window gather."""
    idx = jax.lax.broadcasted_iota(jnp.int32, mabs.shape, mabs.ndim - 1)
    p = peak[..., None]
    valid = ((mabs >= 0.5 * peak_val[..., None])
             & (idx >= p - back) & (idx <= p))
    return jnp.argmax(valid, axis=-1).astype(jnp.int32)


#: Above this length the prefix-sum form of the SC metric switches to the
#: ones-kernel correlation form: float32 cumsums grow to the total recording
#: energy while a half-symbol window is a tiny difference of two huge values
#: (catastrophic cancellation — same failure _device_frame_scan's NCC energy
#: fixed). At 2^20 samples the relative cumsum error is still ≤ ~1e-4 of a
#: window sum for speech-level signals; beyond it the FFT form's error scales
#: with window magnitudes instead.
_SC_CUMSUM_MAX = 1 << 20


def schmidl_cox_metric(cfg: ModemConfig, rx: jnp.ndarray) -> jnp.ndarray:
    """M(d) = P(d)²/R(d)² over the half-symbol lag.

    P(d) = Σ_{m<L/2} r[d+m]·r[d+m+L/2] (real signal ⇒ conj is identity),
    R(d) = Σ |r[d+m+L/2]|² (SURVEY.md Appendix; §6.7 "Schmidl–Cox via
    prefix sums"). rx: (..., T) → (..., T − n_fft) float32.

    Window sums come from prefix sums on short recordings and from a
    correlation with a ones kernel (the matched-filter machinery) on long
    ones, where float32 prefix sums catastrophically cancel.
    """
    half = cfg.n_fft // 2
    prod = rx[..., :-half] * rx[..., half:]
    energy = rx[..., half:] ** 2
    n = rx.shape[-1] - cfg.n_fft
    if rx.shape[-1] <= _SC_CUMSUM_MAX:
        zero = jnp.zeros(rx.shape[:-1] + (1,), dtype=rx.dtype)
        cs_p = jnp.concatenate([zero, jnp.cumsum(prod, axis=-1)], axis=-1)
        cs_r = jnp.concatenate([zero, jnp.cumsum(energy, axis=-1)], axis=-1)
        d = jnp.arange(n)
        P = cs_p[..., d + half] - cs_p[..., d]
        R = cs_r[..., d + half] - cs_r[..., d]
    else:
        ones = np.ones(half, dtype=np.float32)
        P = matched_filter(prod, ones)[..., :n]
        R = jnp.maximum(matched_filter(energy, ones)[..., :n], 0.0)
    # energy floor: near-silent windows otherwise spike to M ≈ 1 on noise
    R = jnp.maximum(R, 0.05 * jnp.max(R, axis=-1, keepdims=True) + 1e-24)
    return (P * P) / (R * R)


def find_frame_start_sc(cfg: ModemConfig, rx: jnp.ndarray):
    """Schmidl–Cox timing: frame start from the autocorrelation plateau —
    the fallback when the chirp is unusable (clipped, band-filtered, or
    colliding with another transmission). BASELINE.json:5: synchronization
    by BOTH chirp matched filtering and Schmidl–Cox.

    The repeated-half SC symbol creates an M(d) ≈ 1 plateau of ~CP width
    starting at the SC symbol's CP; the timing estimate is the plateau
    *center* (argmax alone is noise-driven on a flat top): center of mass
    of M^4 in a CP-wide window around the argmax, then back off to the
    plateau start. rx: (..., T) → (start (...,) int32, metric (...,) f32).
    """
    if not cfg.use_schmidl_cox:
        raise ValueError("SC sync needs use_schmidl_cox=True: this config "
                         "transmits no repeated-half symbol to lock onto")
    M = schmidl_cox_metric(cfg, rx)                       # (..., T - n_fft)
    peak = jnp.argmax(M, axis=-1).astype(jnp.int32)
    peak_val = jnp.take_along_axis(M, peak[..., None], axis=-1)[..., 0]

    W = 2 * cfg.cp + 1

    def refine(mrow, p):
        base = jnp.maximum(p - cfg.cp, 0)
        win = jax.lax.dynamic_slice(mrow, (base,), (W,))
        w = win ** 4                                      # sharpen the plateau
        idx = jnp.arange(W, dtype=jnp.float32)
        com = jnp.sum(w * idx) / jnp.maximum(jnp.sum(w), 1e-12)
        return base + com.astype(jnp.int32)

    flat_m = M.reshape(-1, M.shape[-1])
    flat_p = peak.reshape(-1)
    center = jax.vmap(refine)(flat_m, flat_p).reshape(peak.shape)
    # plateau center ≈ SC CP midpoint + half the plateau → the SC body start
    # is ~center + cp/2; chirp onset = body − cp − chirp_len. The extra
    # −cp/8 biases the estimate EARLY: plateau smear under multipath/SFO
    # was measured to push the centre-of-mass up to ~+76 samples late
    # (past the cp//4 backoff budget, fatal ISI), while early errors only
    # move the FFT windows deeper into the CP (safe until cp − backoff −
    # channel spread).
    start = center + cfg.cp // 2 - cfg.cp - cfg.chirp_len - cfg.cp // 8
    return jnp.maximum(start, 0), peak_val


def sc_metric_at(cfg: ModemConfig, rx: jnp.ndarray, d: jnp.ndarray,
                 R: jnp.ndarray | None = None,
                 nfft: int | None = None) -> jnp.ndarray:
    """Schmidl–Cox metric evaluated at one (per-row, data-dependent) lag —
    the second sync opinion: M ≈ 1 exactly when the repeated-half SC symbol
    sits at `d` (frame-presence validation for the decode diagnostics).

    Only the n_fft-sample window at `d` is touched — O(n_fft) work per row
    instead of two full-recording prefix sums (which are O(T) HBM traffic
    for a diagnostic and catastrophically cancel in float32 on long
    recordings). Pass R = rfft(rx, nfft) to cut the window from an already
    computed sync spectrum (shift theorem); otherwise a per-row dynamic
    slice is used.

    rx: (..., T); d: (...,) int32 window start (clipped). Returns (...,) f32.
    """
    half = cfg.n_fft // 2
    T = rx.shape[-1]
    d = jnp.clip(jnp.broadcast_to(d, rx.shape[:-1]), 0, max(T - cfg.n_fft, 0))
    if R is not None:
        win = extract_windows_spec(R, d, cfg.n_fft, nfft)
    else:
        flat = rx.reshape(-1, T)
        df = d.reshape(-1)
        win = jax.vmap(
            lambda r, s: jax.lax.dynamic_slice(r, (s,), (cfg.n_fft,))
        )(flat, df).reshape(*rx.shape[:-1], cfg.n_fft)
    return sc_metric_window(cfg, win)


def sc_metric_window(cfg: ModemConfig, win: jnp.ndarray) -> jnp.ndarray:
    """SC metric of one already-cut n_fft window: win (..., n_fft) → (...,).

    M = P²/R² over the window's two halves, measured on GUARDED sub-windows
    (length half − 2·(half//4), skipping half//4 samples at each end): the
    half-periodicity then survives ±half//4 samples of window misplacement
    — block-grid cuts (`gather_cut`) and sync error land inside that
    budget. ≈1 when the window holds the repeated-half SC symbol."""
    half = cfg.n_fft // 2
    guard = half // 4
    L = half - 2 * guard
    h1 = win[..., guard: guard + L]
    h2 = win[..., guard + half: guard + half + L]
    P = jnp.sum(h1 * h2, axis=-1)
    Rw = jnp.sum(h2 * h2, axis=-1)
    # energy floor: by Cauchy–Schwarz |P| ≤ √(E₁·E₂), so windows whose
    # second half carries ≪ half the window energy (no repeated structure,
    # or silence) are pushed toward M ≈ 0 rather than 0/0 noise
    tot = jnp.sum(h1 * h1, axis=-1) + Rw
    Rw = jnp.maximum(Rw, 0.05 * tot + 1e-24)
    return (P * P) / (Rw * Rw)
