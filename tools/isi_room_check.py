#!/usr/bin/env python
"""Measure the beyond-CP ISI demap-deweighting lever (VERDICT r4 weak #4).

Question: does adding the per-bin ISI floor (`ops.chanest.isi_profile`) to
the demapper's effective noise improve room FER, or is the adaptation-side
fix (room-aware `recommend_preset`, landed in r5) the whole lever?

Method: for each (preset, rt60) cell, decode n_trials frames through a
seeded room + AWGN chain twice from the SAME recordings — once with the
standard receiver, once with nv_eff' = (nv_sym + ISI_k) · inv_csi in an
inline twin of `Modem._eq_syms` — and report both FERs. Runs on the CPU
or a GPU (both arms share every other op).

Usage: python tools/isi_room_check.py [--trials 24]
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp


def decode_arm(modem, rx, start, deweight: bool) -> bool:
    """One frame decode via the XLA tail, optionally ISI-deweighted.
    Returns CRC ok."""
    from gf3x.config import layout
    from gf3x.models.frame import split_pilots
    from gf3x.ops.chanest import (equalize, estimate_channel,
                                  pilot_phase_correct)
    from gf3x.ops.ofdm import ofdm_dft

    cfg = modem.cfg
    lay = layout(cfg)

    def fn(r, s):
        syms, _, roll = modem._cut_frame(r, s)
        Y = modem._deroll(ofdm_dft(cfg, syms), roll)
        H, nv, (isi_var, _r) = estimate_channel(
            cfg, Y[..., : cfg.n_known_symbols, :], with_isi=True)
        eq = equalize(H, Y[..., cfg.n_known_symbols:, :])
        eq, slope, cpe = pilot_phase_correct(cfg, eq, H)
        pil, data = split_pilots(cfg, eq)
        csi = jnp.abs(H) ** 2
        w, _ = split_pilots(cfg, csi)
        perr = jnp.abs(pil - jnp.asarray(lay.pilot_vals)) ** 2
        sig_d = jnp.sum(w[..., None, :] * perr, axis=-1) / cfg.n_pilots
        nv_sym = jnp.maximum(nv[..., None], sig_d)
        _, inv_csi = split_pilots(cfg, 1.0 / jnp.maximum(csi, 1e-12))
        if deweight:
            _, isi_d = split_pilots(cfg, isi_var)
            nv_eff = ((nv_sym[..., None] + isi_d[..., None, :])
                      * inv_csi[..., None, :])
        else:
            nv_eff = nv_sym[..., None] * inv_csi[..., None, :]
        from gf3x.ops.constellation import qam_demap_llr
        llr3 = qam_demap_llr(data, jnp.broadcast_to(nv_eff, data.shape),
                             cfg.bits_per_symbol)
        llr = llr3.reshape(*r.shape[:-1], cfg.raw_bits_per_frame)
        bits, _, _, _ = modem._payload_bits(llr, r.shape[:-1])
        return bits

    key = ("isi_arm", deweight)
    if key not in modem._jit_cache:
        modem._jit_cache[key] = jax.jit(fn)
    bits = np.asarray(modem._jit_cache[key](
        jnp.asarray(rx[None, :]), jnp.int32(start)))[0]
    return modem._result(bits, None).crc_ok


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=24)
    args = ap.parse_args()

    from gf3x import Modem, preset
    from gf3x.channel import awgn, delay_gain, multipath, room_impulse_response

    out = []
    for preset_name, rt60s in (("gf3", (0.025, 0.032, 0.040)),
                               ("gf3-hicap", (0.020, 0.028, 0.040))):
        m = Modem(preset(preset_name))
        cfg = m.cfg
        pay = bytes(np.random.default_rng(1).integers(
            0, 256, 400, dtype=np.uint8))
        wav = np.asarray(m.encode(pay, "x.bin")).astype(np.float64)
        for rt60 in rt60s:
            ok_std = ok_isi = 0
            for t in range(args.trials):
                rng = np.random.default_rng(1000 + t)
                h = room_impulse_response(rng, rt60=rt60, drr_db=0.0)
                rx = awgn(delay_gain(multipath(wav, h), 600, 0.7,
                                     total_len=len(wav) + 4000), 30.0, rng)
                rx32 = rx.astype(np.float32)
                # shared chirp sync for both arms
                from gf3x.ops.sync import find_frame_start
                if "sync_only" not in m._jit_cache:
                    m._jit_cache["sync_only"] = jax.jit(
                        lambda r: find_frame_start(cfg, r, m.chirp))
                s, _ = m._jit_cache["sync_only"](jnp.asarray(rx32))
                s = int(np.asarray(s))
                ok_std += decode_arm(m, rx32, s, False)
                ok_isi += decode_arm(m, rx32, s, True)
            row = {"preset": preset_name, "rt60_ms": rt60 * 1e3,
                   "fer_std": round(1 - ok_std / args.trials, 3),
                   "fer_isi_deweight": round(1 - ok_isi / args.trials, 3),
                   "trials": args.trials}
            out.append(row)
            print(json.dumps(row))
    Path(__file__).with_name("isi_room_check.json").write_text(
        json.dumps(out, indent=1) + "\n")


if __name__ == "__main__":
    main()
