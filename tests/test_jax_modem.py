"""JAX modem tests: parity with the golden model + end-to-end configs 1-3.

Parity is asserted on decoded payload bits / waveform closeness, not on
intermediate floats (SURVEY.md §8 risk "Bit-exactness across float32
accelerator math vs float64 NumPy"). Runs on a virtual 8-device CPU mesh (conftest).
"""

import numpy as np
import pytest

from gf3x import CONFIG1_LOOPBACK, GoldenModem, Modem
from gf3x.channel import awgn, delay_gain, multipath, room_impulse_response
from gf3x.config import layout


@pytest.fixture(scope="module")
def modem():
    return Modem(CONFIG1_LOOPBACK)


@pytest.fixture(scope="module")
def golden():
    return GoldenModem(CONFIG1_LOOPBACK)


# ------------------------------------------------------------------- parity

def test_encode_waveform_matches_golden(modem, golden):
    payload = b"parity check payload" * 3
    wj = modem.encode(payload, "p.txt")
    wg = golden.encode(payload, "p.txt")
    assert wj.shape == wg.shape
    # float32 FFT vs float64 FFT: agree to ~1e-5 of the ~0.5 peak amplitude
    assert np.max(np.abs(wj - wg.astype(np.float32))) < 1e-4


def test_jax_decodes_golden_encode(modem, golden):
    rng = np.random.default_rng(10)
    payload = bytes(rng.integers(0, 256, size=500, dtype=np.uint8))
    wav = golden.encode(payload, "x.bin")
    rx = delay_gain(wav, 4000, 0.4, total_len=len(wav) + 9000)
    rx = awgn(rx, 25.0, rng)
    res = modem.decode(rx)
    assert res.crc_ok and res.payload == payload and res.filename == "x.bin"


def test_golden_decodes_jax_encode(modem, golden):
    rng = np.random.default_rng(11)
    payload = bytes(rng.integers(0, 256, size=500, dtype=np.uint8))
    wav = modem.encode(payload)
    rx = delay_gain(wav.astype(np.float64), 4000, 0.4, total_len=len(wav) + 9000)
    rx = awgn(rx, 25.0, rng)
    res = golden.decode(rx)
    assert res.crc_ok and res.payload == payload


def test_sync_start_matches_golden(modem, golden):
    rng = np.random.default_rng(12)
    wav = golden.encode(b"sync parity")
    rx = awgn(delay_gain(wav, 7777, 0.3, total_len=len(wav) + 12000), 20.0, rng)
    gs, _ = golden.find_frame_start(rx)
    res = modem.decode(rx)
    assert abs(int(res.diag.sync_start) - gs) <= 2


# ----------------------------------------------------------- configs 1 -- 3

def test_config1_loopback_jit(modem):
    """BASELINE.json:7 — loopback QPSK-OFDM, ideal channel, jitted path."""
    payload = b"The five boxing wizards jump quickly." * 5
    wav = modem.encode(payload, "wiz.txt")
    res = modem.decode(wav, start=0)
    assert res.crc_ok and res.payload == payload and res.filename == "wiz.txt"


def test_config2_delay_gain(modem):
    """BASELINE.json:8 — chirp-synchronized decode with delay + gain."""
    rng = np.random.default_rng(13)
    payload = bytes(rng.integers(0, 256, size=700, dtype=np.uint8))
    wav = modem.encode(payload)
    rx = awgn(delay_gain(wav.astype(np.float64), 12345, 0.21,
                         total_len=len(wav) + 20000), 25.0, rng)
    res = modem.decode(rx)
    assert res.crc_ok and res.payload == payload
    assert int(res.diag.sync_start) in range(12345 - 4, 12345 + 2)


def test_config3_multipath(modem):
    """BASELINE.json:9 — pilot-aided est/EQ over a multipath room channel."""
    rng = np.random.default_rng(14)
    payload = bytes(rng.integers(0, 256, size=300, dtype=np.uint8))
    wav = modem.encode(payload)
    # margin for UNCODED QPSK: reverb well inside the CP. Harsher rooms are
    # the FEC-protected case (config 4, test_gf3_frame).
    h = room_impulse_response(rng, rt60=0.015, drr_db=6.0)
    rx = awgn(delay_gain(multipath(wav.astype(np.float64), h), 2000, 1.0,
                         total_len=len(wav) + 8000), 30.0, rng)
    res = modem.decode(rx)
    assert res.crc_ok and res.payload == payload


def test_16qam_roundtrip():
    m = Modem(CONFIG1_LOOPBACK.replace(bits_per_symbol=4))
    rng = np.random.default_rng(15)
    payload = bytes(rng.integers(0, 256, size=900, dtype=np.uint8))
    wav = m.encode(payload)
    rx = awgn(delay_gain(wav.astype(np.float64), 500, 0.6,
                         total_len=len(wav) + 2000), 30.0, rng)
    res = m.decode(rx)
    assert res.crc_ok and res.payload == payload


# ------------------------------------------------------------------ batched

def test_batched_decode_parity(modem):
    """Frame-batch data parallelism (SURVEY.md §3.2): B frames, one jit call."""
    rng = np.random.default_rng(16)
    B = 8
    payloads = [bytes(rng.integers(0, 256, size=200, dtype=np.uint8)) for _ in range(B)]
    wavs = modem.encode_batch(payloads)
    assert wavs.shape == (B, modem.cfg.frame_len)
    T = modem.cfg.frame_len + 6000
    rx = np.zeros((B, T))
    delays = rng.integers(0, 5000, size=B)
    for i in range(B):
        rx[i] = awgn(delay_gain(wavs[i].astype(np.float64), int(delays[i]),
                                0.5, total_len=T), 25.0, rng)
    results = modem.decode_batch(rx)
    for i, res in enumerate(results):
        assert res.crc_ok and res.payload == payloads[i]
        assert abs(int(res.diag.sync_start) - int(delays[i])) <= 2


def test_diag_pytree_shapes(modem):
    rng = np.random.default_rng(17)
    wav = modem.encode(b"diag")
    rx = awgn(delay_gain(wav.astype(np.float64), 100, 1.0,
                         total_len=len(wav) + 1000), 30.0, rng)
    res = modem.decode(rx)
    d = res.diag
    assert d.H.shape == (modem.cfg.n_used,)
    assert d.pilot_slope.shape == (modem.cfg.n_data_symbols,)
    assert float(d.evm) < 0.05
    assert float(d.noise_var) > 0


def test_dd_retry_recovers_room_frame():
    """Decision-directed retry (r5, decode(dd='auto')): a beyond-CP room
    frame near the decode cliff (the regime tools/dd_room_check.json
    measured DD winning in — gf3-hicap rt60=20 ms FER 0.667→0.375) fails
    the standard pass but decodes through the dd second pass, which
    re-references Ĥ on the D data symbols' decisions. Clean channels must
    be unaffected (dd='on' decodes the same payload). Seed 3004 /
    rt60=24 ms was found by scanning 16 room draws: the standard pass
    fails CRC, isi_db ≈ 16 (gate > −25 fires), and the DD pass decodes."""
    from gf3x import Modem, ModemConfig
    from gf3x.channel import (awgn, delay_gain, multipath,
                              room_impulse_response)

    cfg = ModemConfig(
        n_fft=256, cp=64, bin_lo=8, bin_hi=103, pilot_spacing=8,
        n_known_symbols=2, n_data_symbols=12, chirp_duration=0.02,
        fec="ldpc", ldpc_z=24, ldpc_iters=10,
    ).validate()
    m = Modem(cfg)
    payload = b"decision directed retry"
    wav = np.asarray(m.encode(payload, "dd.bin")).astype(np.float64)

    # clean channel: dd='on' decodes the same payload
    rng = np.random.default_rng(8)
    rx0 = np.zeros(wav.size + 800, np.float32)
    rx0[300: 300 + wav.size] = 0.7 * wav.astype(np.float32)
    rx0 += (rng.standard_normal(rx0.size) * 1e-3).astype(np.float32)
    r_on = m.decode(rx0, dd="on")
    assert r_on.crc_ok and r_on.payload == payload

    # beyond-CP room draw where the known-symbol estimate breaks the
    # standard pass (CP = 64 samples ≈ 1.5 ms; rt60 = 24 ms ≈ 16× CP)
    rng = np.random.default_rng(3004)
    x = multipath(wav, room_impulse_response(rng, rt60=0.024, drr_db=0.0))
    rx = awgn(delay_gain(x, 600, 0.7, total_len=wav.size + 4000),
              30.0, rng).astype(np.float32)
    r_std = m.decode(rx, sfo="off", dd="off")
    assert not r_std.crc_ok          # the standard pass fails this draw
    assert float(np.max(np.asarray(r_std.diag.isi_db))) > -25.0  # gate fires
    r_auto = m.decode(rx, sfo="off", dd="auto")
    assert r_auto.crc_ok and r_auto.payload == payload
