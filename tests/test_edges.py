"""Edge and fuzz coverage: the bit layer must never crash on garbage, config
validation must reject bad geometry."""

import numpy as np
import pytest

from gf3x import ModemConfig
from gf3x.utils.bits import parse_frame_header, pack_header


def test_header_fuzz_never_crashes():
    """parse_frame_header on random bytes: ValueError or a result — never
    an unhandled exception (decode feeds it raw demodulated bits)."""
    rng = np.random.default_rng(0)
    for n in (0, 1, 15, 16, 17, 64, 300):
        for _ in range(50):
            blob = bytes(rng.integers(0, 256, n, dtype=np.uint8))
            try:
                h = parse_frame_header(blob)
                assert isinstance(h.crc_ok, bool)
            except ValueError:
                pass


def test_header_fuzz_valid_prefix():
    """Correct magic but corrupted fields: still ValueError or crc_ok=False."""
    rng = np.random.default_rng(1)
    good = pack_header(b"payload", "f.txt", seq=1, total=3)
    for _ in range(200):
        blob = bytearray(good)
        i = int(rng.integers(2, len(blob)))
        blob[i] ^= int(rng.integers(1, 256))
        try:
            h = parse_frame_header(bytes(blob))
            if h.payload == b"payload":
                continue                      # mutation hit the name/seq only
            assert not h.crc_ok              # altered payload must fail CRC
        except ValueError:
            pass


def test_pack_header_limits():
    with pytest.raises(ValueError):
        pack_header(b"x", "n" * 256)
    with pytest.raises(ValueError):
        pack_header(b"x", seq=3, total=3)
    with pytest.raises(ValueError):
        pack_header(b"x", seq=0, total=0x10000)


def test_config_validation_rejects_bad_geometry():
    with pytest.raises(AssertionError):
        ModemConfig(n_fft=1000).validate()          # not a power of two
    with pytest.raises(AssertionError):
        ModemConfig(cp=1024).validate()             # cp >= n_fft
    with pytest.raises(AssertionError):
        ModemConfig(bin_hi=512).validate()          # beyond Nyquist-1
    with pytest.raises(AssertionError):
        ModemConfig(fec="turbo").validate()
    with pytest.raises(AssertionError):
        # frame too small for one codeword
        ModemConfig(fec="ldpc", ldpc_z=96, n_data_symbols=1).validate()


def test_safe_filename_strips_traversal():
    from gf3x.utils.bits import safe_filename
    assert safe_filename("report.txt") == "report.txt"
    assert safe_filename("../../.bashrc") == ".bashrc"
    assert safe_filename("/etc/passwd") == "passwd"
    assert safe_filename("a\\b\\c.bin") == "c.bin"
    assert safe_filename("..") == "decoded.bin"
    assert safe_filename("") == "decoded.bin"
    assert safe_filename("x\x00y") == "decoded.bin"
    assert safe_filename("dir/") == "decoded.bin"


def test_sc_metric_long_recording_no_cancellation():
    """The full SC metric must stay sane on long recordings (ADVICE r1:
    float32 prefix sums catastrophically cancel beyond ~1M samples)."""
    import jax.numpy as jnp
    from gf3x import GF3_STANDARD, Modem
    from gf3x.ops.sync import schmidl_cox_metric

    cfg = GF3_STANDARD
    m = Modem(cfg)
    rng = np.random.default_rng(7)
    T = (1 << 20) + 50_000          # forces the ones-kernel correlation path
    rx = (rng.standard_normal(T) * 0.01).astype(np.float32)
    wav = m.encode(b"long-recording", "x.bin")
    pos = T - cfg.frame_len - 1000
    rx[pos: pos + wav.size] += wav
    M = np.asarray(schmidl_cox_metric(cfg, jnp.asarray(rx)))
    sc_body = pos + cfg.chirp_len + cfg.cp
    # plateau at the SC symbol, quiet elsewhere
    assert M[sc_body] > 0.5
    far = np.concatenate([M[: pos - cfg.frame_len], M[pos + cfg.frame_len:]])
    assert np.max(far) < 0.5


def test_channel_denoise_reduces_estimator_noise():
    """The tap-subspace projection cuts LS Ĥ noise ≈ n_used/taps without
    biasing channels inside the taps (VERDICT r1 item 4)."""
    import jax.numpy as jnp
    from gf3x.config import GF3_STANDARD
    from gf3x.ops.chanest import estimate_channel
    from gf3x.config import layout as get_layout

    cfg_on = GF3_STANDARD
    cfg_off = GF3_STANDARD.replace(chanest_taps=0)
    assert cfg_on.est_taps == cfg_on.cp // 2
    lay = get_layout(cfg_on)
    rng = np.random.default_rng(5)
    # a true (real) channel with 40 taps (well inside est_taps)
    h = rng.standard_normal(40) * np.exp(-np.arange(40) / 10)
    Hk = np.fft.rfft(np.concatenate([h, np.zeros(cfg_on.n_fft - 40)]))[
        lay.used_bins]
    X = lay.known_syms
    noise = 0.05 * (rng.standard_normal(X.shape) + 1j * rng.standard_normal(X.shape))
    known_rx = jnp.asarray((Hk[None, :] * X + noise).astype(np.complex64))
    H_raw, _ = estimate_channel(cfg_off, known_rx)
    H_den, _ = estimate_channel(cfg_on, known_rx)
    err_raw = np.mean(np.abs(np.asarray(H_raw) - Hk) ** 2)
    err_den = np.mean(np.abs(np.asarray(H_den) - Hk) ** 2)
    assert err_den < 0.7 * err_raw, (err_raw, err_den)
