"""Preset family coverage: every named preset round-trips end-to-end."""

import numpy as np
import pytest

from gf3x import Modem, preset
from gf3x.channel import awgn, delay_gain, multipath, room_impulse_response
from gf3x.models.stream import frame_capacity


@pytest.mark.parametrize("name,snr_db,rt60", [
    ("loopback", 30.0, 0.012),   # uncoded: needs clean margins
    ("gf3", 18.0, 0.02),
    ("gf3-fast", 26.0, 0.02),    # 16-QAM needs ~6 dB more than QPSK
    ("gf3-hicap", 28.0, 0.02),   # 16-QAM + rate-3/4 code: ~2 dB over gf3-fast
    ("gf3-robust", 16.0, 0.02),
])
def test_preset_roundtrip(name, snr_db, rt60):
    import zlib
    m = Modem(preset(name))
    rng = np.random.default_rng(zlib.crc32(name.encode()))  # stable across runs
    payload = bytes(rng.integers(0, 256, min(frame_capacity(m, "p.bin"), 300), dtype=np.uint8))
    wav = m.encode(payload, "p.bin")
    h = room_impulse_response(rng, rt60=rt60, drr_db=6.0)
    rx = awgn(delay_gain(multipath(wav.astype(np.float64), h), 2500, 0.5,
                         total_len=len(wav) + 7000), snr_db, rng)
    res = m.decode(rx)
    assert res.crc_ok and res.payload == payload


def test_preset_capacities():
    assert frame_capacity(Modem(preset("gf3"))) == 560
    assert frame_capacity(Modem(preset("gf3-fast"))) == 1136
    assert frame_capacity(Modem(preset("gf3-hicap"))) == 1712
    assert frame_capacity(Modem(preset("gf3-robust"))) == 272


def test_unknown_preset():
    with pytest.raises(KeyError):
        preset("nope")


def test_coded_64qam_roundtrip_e2e():
    """gf3-turbo (coded 64-QAM) end-to-end through delay + noise, golden and
    JAX bit-identical."""
    from gf3x import GoldenModem
    from gf3x.channel import awgn, delay_gain

    cfg = preset("gf3-turbo")
    assert cfg.bits_per_symbol == 6 and cfg.fec == "ldpc"
    m, g = Modem(cfg), GoldenModem(cfg)
    rng = np.random.default_rng(66)
    payload = bytes(rng.integers(0, 256, 1500, dtype=np.uint8))
    wav = m.encode(payload, "turbo.bin")
    rx = awgn(delay_gain(wav.astype(np.float64), 4000, 0.5,
                         total_len=len(wav) + 9000), 24.0, rng)
    res = m.decode(rx.astype(np.float32))
    gres = g.decode(rx)
    assert res.crc_ok and res.payload == payload
    assert gres.crc_ok and gres.payload == payload
    assert np.array_equal(res.bits, gres.bits)
