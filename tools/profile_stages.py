#!/usr/bin/env python
"""Per-stage GPU timing of the batched receive path (bench.py's workload).

Times each receiver stage in isolation with a hoisting-proof measurement:
the stage runs inside a lax.scan whose body depends on the carry (XLA
cannot hoist it), and the per-iteration time is the difference between two
repeat counts (cancels the per-dispatch cost). Achieved bytes/s are read
against the device's HBM peak from bench.PEAKS (keyed by device_kind).
Run on a GPU: python tools/profile_stages.py
"""

import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp

from gf3x import GF3_STANDARD, Modem

B = 1024
MARGIN = 4096
R1, R2 = 4, 12            # repeat counts; per-iter = (t2 - t1) / (R2 - R1)


def timed(fn, x, label, nbytes: float = 0.0):
    """Per-iteration seconds of fn via carry-dependent scan differencing.
    `nbytes` (bytes touched per iteration, from bench.hbm_bytes_per_step's
    model) adds an achieved-GB/s column vs the device's HBM peak."""
    from bench import peaks

    hbm_peak = peaks(jax.devices()[0].device_kind)["hbm_bytes_per_s"]

    def prog(reps):
        @jax.jit
        def run(x):
            def body(c, _):
                out = fn(x + c * 1e-30)
                leaves = [l for l in jax.tree.leaves(out)
                          if hasattr(l, "dtype")]
                acc = sum(jnp.sum(l).astype(jnp.float32) if l.dtype != jnp.int32
                          else jnp.sum(l).astype(jnp.float32) for l in leaves)
                return c + acc * 1e-30, 0
            c, _ = jax.lax.scan(body, jnp.float32(0), None, length=reps)
            return c
        return run

    ts = {}
    for reps in (R1, R2):
        run = prog(reps)
        run(x).block_until_ready(); run(x).block_until_ready()
        t0 = time.perf_counter()
        for _ in range(3):
            run(x).block_until_ready()
        ts[reps] = (time.perf_counter() - t0) / 3
    per = (ts[R2] - ts[R1]) / (R2 - R1)
    gbs = ""
    if nbytes and per > 0:
        frac = nbytes / per / hbm_peak
        gbs = f"  {nbytes / per / 1e9:7.1f} GB/s ({frac:5.1%} of roofline)"
    print(f"{label:34s} {per * 1e3:8.2f} ms{gbs}")
    return per


def main():
    from gf3x.ops.sync import find_frame_start, gather_cut, matched_filter
    from gf3x.ops.ofdm import ofdm_demodulate
    from gf3x.ops.chanest import estimate_channel

    cfg = GF3_STANDARD
    modem = Modem(cfg, max_delay=MARGIN + cfg.cp)
    rng = np.random.default_rng(0)
    payload = rng.integers(0, 256, 540, dtype=np.uint8).tobytes()
    wav = modem.encode(payload, "p.bin")
    T = cfg.frame_len + MARGIN
    rx = np.zeros((B, T), dtype=np.float32)
    delays = rng.integers(0, MARGIN, size=B)
    for i in range(B):
        rx[i, delays[i]: delays[i] + wav.size] = wav
    rx += (rng.standard_normal((B, T)) * 0.01).astype(np.float32)
    rx = jax.device_put(jnp.asarray(rx))
    print(f"workload: B={B} T={T} device={jax.devices()[0]}")

    dec = modem._sync_decimate
    sl = modem.max_delay
    from bench import hbm_bytes_per_step
    hb = hbm_bytes_per_step(cfg, T, B, sl)

    timed(lambda r: modem.demodulate(r)[0], rx, "full demodulate",
          hb["total"])
    timed(lambda r: find_frame_start(cfg, r, modem.chirp,
                                     search_len=sl, decimate=dec),
          rx, "find_frame_start (bounded, dec)", hb["sync"])
    seg = rx[..., : (sl + cfg.chirp_len) // dec * dec: dec]
    timed(lambda s: matched_filter(s, modem.chirp[::dec]), seg,
          "  matched_filter only")

    start = jnp.full((B,), 2000, jnp.int32)
    need = (cfg.n_known_symbols + cfg.n_data_symbols) * cfg.symbol_len
    timed(lambda r: gather_cut(r, start, cfg.sc_len + need,
                               modem._cut_block)[0],
          rx, "gather_cut", hb["cut_symbols"])

    body = jnp.zeros((B, need), jnp.float32) + rx[..., :need]
    timed(lambda b: ofdm_demodulate(cfg, b), body, "ofdm_demodulate (rfft)",
          hb["dft"])
    Y = ofdm_demodulate(cfg, body)
    Yri = jnp.stack([Y.real, Y.imag], -1)

    def est(yri):
        Yc = jax.lax.complex(yri[..., 0], yri[..., 1])
        H, nv = estimate_channel(cfg, Yc[..., : cfg.n_known_symbols, :])
        return jnp.abs(H), nv
    timed(est, Yri, "estimate_channel")

    syms = modem._sym_matrix(body)
    timed(lambda s: modem._demod_syms(s)[0], syms, "DFT + est + EQ/demap",
          hb["dft"] + hb["eq_demap"])

    llr = jax.jit(lambda s: modem._demod_syms(s)[0])(syms)
    timed(lambda l: modem._payload_bits(l, (B,))[0], llr,
          "LDPC decode only (+epilogue)",
          hb["fec_epilogue"] + hb["ldpc"] + hb["bits_out"])

    timed(lambda r: modem.demodulate_prewindowed(r)[0],
          rx[..., :cfg.frame_len], "demodulate_prewindowed")


if __name__ == "__main__":
    main()
