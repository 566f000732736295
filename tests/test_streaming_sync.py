"""Overlap-save streaming sync (SURVEY.md §6.7): identical to the one-shot
matched filter, bounded memory, works on long multi-frame recordings."""

import numpy as np
import jax
import jax.numpy as jnp

from gf3x import ModemConfig, Modem
from gf3x.channel import awgn, delay_gain
from gf3x.models.stream import decode_stream, encode_file, find_frames, frame_capacity
from gf3x.ops.sync import matched_filter, streaming_matched_filter

CFG = ModemConfig(
    n_fft=256, cp=64, bin_lo=8, bin_hi=103, pilot_spacing=8,
    n_known_symbols=2, n_data_symbols=12, chirp_duration=0.02,
).validate()


def test_streaming_equals_oneshot():
    m = Modem(CFG)
    rng = np.random.default_rng(0)
    rx = jnp.asarray(rng.standard_normal((3, 50000)).astype(np.float32))
    a = np.asarray(jax.jit(lambda r: matched_filter(r, m.chirp))(rx))
    b = np.asarray(jax.jit(
        lambda r: streaming_matched_filter(r, m.chirp, 4096))(rx))
    assert np.max(np.abs(a - b)) < 1e-3 * np.max(np.abs(a))


def test_window_extraction_exact_on_long_recordings():
    """Regression: the shift-theorem ramp start·k must reduce mod nfft in
    integer arithmetic — float32 loses ~0.7 rad once start·k ≳ 2²⁴ (a frame
    near the end of a minute-long recording decoded to garbage)."""
    from gf3x.ops.sync import extract_windows_spec, rx_spectrum, sync_nfft

    rng = np.random.default_rng(3)
    T = 1_500_000
    rx = rng.standard_normal((T,)).astype(np.float32) * 0.1
    start, need = T - 40_000, 8192
    nfft = sync_nfft(T, 0)
    R = rx_spectrum(jnp.asarray(rx), nfft)
    win = np.asarray(extract_windows_spec(R, jnp.int32(start), need, nfft))
    ref = rx[start: start + need]
    assert np.max(np.abs(win - ref)) < 5e-3 * np.max(np.abs(ref))


def test_ber_sweep_delay_beyond_cp():
    """Regression: the sweep recording must grow by delay_samples or the
    frame tail truncates and every SNR reports ~0.5 BER."""
    from gf3x.bench.ber import ber_sweep

    m = Modem(CFG)
    res = ber_sweep(m, snrs_db=[30.0], n_trials=4, delay_samples=500)
    assert res["ber_post_fec"][0] < 0.01


def test_stereo_wav_normalized(tmp_path):
    """Regression: PCM normalization must happen before the stereo mixdown."""
    from scipy.io import wavfile
    from gf3x.io import read_wav

    rng = np.random.default_rng(4)
    mono = (rng.standard_normal(4000) * 0.3).clip(-1, 1)
    st = (np.stack([mono, mono], 1) * 32767).astype(np.int16)
    wavfile.write(tmp_path / "st.wav", 44100, st)
    x, _ = read_wav(tmp_path / "st.wav")
    assert np.abs(x).max() <= 1.0
    assert np.allclose(x, mono, atol=1e-3)


def test_device_frame_scan_matches_host():
    """Segment-level on-device enumeration must equal the host peak picker
    (decode_stream auto-routes recordings > 1M samples through it)."""
    from gf3x.models.stream import encode_file, find_frames, find_frames_device, frame_capacity
    from gf3x.channel import awgn, delay_gain

    m = Modem(CFG)
    rng = np.random.default_rng(7)
    data = b"q" * (frame_capacity(m, "d") * 4)
    wav = encode_file(m, data, "d", gap_s=0.2)
    rx = awgn(delay_gain(wav.astype(np.float64), 20000, 0.5,
                         total_len=len(wav) + 60000), 22.0, rng)
    s1, m1 = find_frames(m, rx)
    s2, m2 = find_frames_device(m, rx)
    s3, _ = find_frames_device(m, rx, streaming_chunk=8192)
    assert s1.size == 4
    assert np.array_equal(s1, s2)
    assert np.array_equal(s1, s3)
    assert np.allclose(m1, m2, rtol=1e-3)


def test_streaming_find_frames_on_long_recording():
    m = Modem(CFG)
    rng = np.random.default_rng(1)
    data = b"z" * (frame_capacity(m, "s") * 4)      # 4 frames
    wav = encode_file(m, data, "s", gap_s=0.3)
    rx = awgn(delay_gain(wav.astype(np.float64), 30000, 0.5,
                         total_len=len(wav) + 90000), 22.0, rng)
    s1, _ = find_frames(m, rx)
    s2, _ = find_frames(m, rx, streaming_chunk=8192)
    assert s1.size == 4
    assert np.array_equal(s1, s2) or np.max(np.abs(s1 - s2)) <= 1
    res = decode_stream(m, rx)
    assert res.complete and res.payload == data


def test_bounded_decimated_sync_decodes():
    """Modem(max_delay=...) bounds + decimates the sync correlation (the
    streaming receiver's case). Onsets resolve within a few samples (early
    side only — safe: further into the CP) and frames decode."""
    import jax.numpy as jnp  # noqa: F401
    from gf3x import GF3_STANDARD, Modem
    from gf3x.channel import awgn, delay_gain

    m = Modem(GF3_STANDARD, max_delay=4096 + 256)
    assert m._sync_decimate == 2          # 10 kHz chirp fits fs/4
    rng = np.random.default_rng(1)
    payload = bytes(rng.integers(0, 256, 400, dtype=np.uint8))
    wav = m.encode(payload, "d.bin")
    for delay in (0, 777, 4000):
        rx = awgn(delay_gain(wav.astype(np.float64), delay, 0.5,
                             total_len=len(wav) + 4096), 18.0, rng)
        res = m.decode(rx.astype(np.float32))
        err = int(res.diag.sync_start) - delay
        assert res.crc_ok and res.payload == payload, delay
        assert -8 <= err <= 2, (delay, err)
