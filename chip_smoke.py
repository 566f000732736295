#!/usr/bin/env python
"""On-card smoke test of the gf3x receiver: the quickest proof that the
system starts and decodes correctly on the GPU.

    python chip_smoke.py          # one GPU: main path, parity, timings
    python chip_smoke.py --four   # sharded decode over four GPUs, only

Phases (one GPU), in order:

1. device — JAX must see a GPU (never falls back to the CPU); prints its
   kind, the device count, and the card's name and power limit;
2. main path at bench geometry (GF3_STANDARD, bench.py's B = 1024 batch):
   `Modem.decode_batch` (every row CRC-ok with the payload), `Modem.decode`
   on one recording, `decode_stream` on a multi-frame recording, and a
   `StreamingReceiver` fed in chunks;
3. parity on the card — the frozen capture WAVs decode bit-exact; the
   demod DFT's error floor against float64; the Triton LDPC kernel against
   the XLA min-sum on the batch's 4096 codewords (and on a noisier copy
   that makes the decoder iterate);
4. timing (informational) — the bench-geometry step with each LDPC route.

`--four` runs only `parallel.mesh.sharded_decode` (shard_map route and the
dp×sp GSPMD route) and `sharded_pipeline_step` over four GPUs, each compared
with the one-card decode of the same batch.

A failed check raises and the script exits non-zero; nothing is caught and
passed over. The last line of a passing run is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import argparse
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

#: Seed of every random input (payloads, delays, noise).
SEED = 0


def check(cond: bool, what: str) -> None:
    """Fail the run (non-zero exit, no result line) unless `cond`."""
    if not cond:
        raise AssertionError(what)
    print(f"  ok: {what}", flush=True)


def device_phase(want: int):
    """JAX's first device must be a GPU, and there must be `want` of them."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"chip_smoke: no GPU found (JAX runs on {devs[0].platform})")
    if len(devs) < want:
        sys.exit(f"chip_smoke: needs {want} GPUs, JAX sees {len(devs)}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"device: {devs[0].device_kind} x{len(devs)}", flush=True)
    print(f"card: {card}", flush=True)
    return devs


def _bench_batch(modem, B: int, margin: int):
    from bench import build_batch

    return build_batch(modem, B, margin, np.random.default_rng(SEED))


def main_path_phase(B: int = 1024, stream_bytes: int = 6000):
    """The decode surfaces a user calls, at bench geometry."""
    from bench import MARGIN
    from gf3x import GF3_STANDARD, Modem
    from gf3x.channel import awgn, delay_gain
    from gf3x.models.stream import StreamingReceiver, decode_stream, encode_file

    cfg = GF3_STANDARD
    print("main path:", flush=True)
    modem = Modem(cfg, max_delay=MARGIN + cfg.cp)
    rx, payload, delays = _bench_batch(modem, B, MARGIN)
    t0 = time.perf_counter()
    res = modem.decode_batch(rx)
    print(f"  decode_batch B={B}: {time.perf_counter() - t0:.1f} s "
          "(compile included)", flush=True)
    n_ok = sum(r.crc_ok and r.payload == payload for r in res)
    check(n_ok == B, f"Modem.decode_batch: {n_ok}/{B} rows CRC-ok with the "
                     f"payload (GF3_STANDARD, 20 dB, random delays)")

    single = Modem(cfg)
    r1 = single.decode(rx[0])
    check(r1.crc_ok and r1.payload == payload
          and abs(int(r1.diag.sync_start) - int(delays[0])) <= 8,
          "Modem.decode of one recording")

    rng = np.random.default_rng(SEED + 1)
    data = rng.integers(0, 256, stream_bytes, dtype=np.uint8).tobytes()
    wav = encode_file(single, data, "smoke.bin")
    rec = awgn(delay_gain(wav.astype(np.float64), 3000, 0.6,
                          total_len=len(wav) + 12000), 20.0, rng)
    rec = rec.astype(np.float32)
    sres = decode_stream(single, rec)
    check(sres.complete and sres.payload == data
          and sres.filename == "smoke.bin",
          f"decode_stream of a {len(sres.frames)}-frame recording")

    rcv = StreamingReceiver(single)
    chunk = cfg.fs // 2
    for i in range(0, len(rec), chunk):
        rcv.feed(rec[i: i + chunk])
    fres = rcv.result()
    check(fres.complete and fres.payload == data,
          f"StreamingReceiver fed {chunk}-sample chunks "
          f"({len(fres.frames)} frames)")
    return modem, rx, delays


def capture_parity():
    """The frozen capture WAVs decode bit-exact on the card."""
    from gf3x import Modem
    from gf3x.io import read_wav
    from gf3x.models.stream import decode_stream
    from gf3x.utils.captures import capture_config

    fixtures = ROOT / "tests" / "fixtures"
    manifest = json.loads((fixtures / "manifest.json").read_text())
    for cap in manifest["captures"]:
        rx, _ = read_wav(fixtures / cap["wav"])
        res = decode_stream(Modem(capture_config(cap)), rx)
        check(res.complete and res.starts.size == cap["n_frames"]
              and res.filename == cap["filename"]
              and res.payload is not None
              and hashlib.sha256(res.payload).hexdigest()
              == cap["payload_sha256"],
              f"capture {cap['wav']} bit-exact")
    return len(manifest["captures"])


def dft_floor_db(modem, rx_dev, delays, delta=None) -> float:
    """Error power of the used-band demod DFT on the card against a float64
    DFT of the same float32 symbols, over the batch, in dB of the signal."""
    import jax
    import jax.numpy as jnp

    from gf3x.ops.ofdm import ofdm_dft

    cfg = modem.cfg
    syms, _, _ = jax.jit(modem._cut_frame)(rx_dev, jnp.asarray(delays, jnp.int32))
    d = None if delta is None else jnp.float32(delta)
    Y = np.asarray(jax.jit(lambda s: ofdm_dft(cfg, s, d))(syms))
    x = np.asarray(syms, np.float64)
    n = np.arange(cfg.n_fft)[:, None]
    k = np.arange(cfg.bin_lo, cfg.bin_hi + 1)[None, :]
    warp = 1.0 if delta is None else 1.0 + np.float32(delta)
    W = np.exp(-2j * np.pi * n * k * warp / cfg.n_fft) / cfg.ofdm_scale
    ref = x @ W
    err = np.sum(np.abs(Y - ref) ** 2) / np.sum(np.abs(ref) ** 2)
    return float(10 * np.log10(err))


def bench_llrs(modem, rx_dev, delays):
    """The bench batch's LDPC input: (B·n_codewords, 24, z) channel LLRs."""
    import jax
    import jax.numpy as jnp

    cfg = modem.cfg

    def lam(r):
        llr, _ = modem._demod_at(r, jnp.asarray(delays, jnp.int32))
        llr = modem.coded_stream_llr(llr, r.shape[:-1])
        used = cfg.n_codewords * cfg.ldpc_n
        return llr[..., :used].reshape(-1, 24, cfg.ldpc_z)

    return jax.jit(lam)(rx_dev)


def ldpc_parity(code, lam, iters: int, label: str):
    """Triton kernel vs the XLA min-sum on the same LLRs: decoded bits,
    per-codeword passes and unsat flags identical; totals within a relative
    1e-5 of each codeword's largest |total| — the two compile the same
    float ops, but the GPU compiler may contract a multiply and a subtract
    into one FMA in one and not the other, and one rounding can then
    propagate through the later passes."""
    from gf3x.ops.pallas.ldpc_minsum import minsum_totals

    kt, kit, kun = minsum_totals(lam, code.z, iters, True, code.rate)
    xt, xit, xun = code._minsum_xla(lam, iters, True)
    kt, xt = np.asarray(kt), np.asarray(xt)
    kit, xit = np.asarray(kit), np.asarray(xit)
    B = kt.shape[0]
    check(np.array_equal(kt < 0, xt < 0),
          f"LDPC kernel bits == _minsum_xla bits, {label} ({B} codewords)")
    check(np.array_equal(kit, xit) and np.array_equal(np.asarray(kun),
                                                      np.asarray(xun)),
          f"LDPC kernel passes/unsat == _minsum_xla, {label} "
          f"(passes mean {kit.mean():.2f}, max {kit.max()})")
    scale = np.max(np.abs(xt).reshape(B, -1), axis=1)[:, None, None]
    rel = float(np.max(np.abs(kt - xt) / scale))
    check(rel <= 1e-5, f"LDPC kernel totals within 1e-5 relative, {label} "
                       f"(max {rel:.3g})")


def parity_phase(modem, rx, delays):
    import jax
    import jax.numpy as jnp

    print("parity:", flush=True)
    n = capture_parity()
    print(f"  {n} captures bit-exact", flush=True)
    rx_dev = jax.device_put(jnp.asarray(rx))
    db = dft_floor_db(modem, rx_dev, delays)
    check(db <= -80.0, f"demod DFT error floor {db:.1f} dB vs float64 "
                       f"(gate -80 dB)")
    dbw = dft_floor_db(modem, rx_dev, delays, delta=2e-4)
    # the δ-warped tables are built in float32 on the card: the phase
    # argument 2π·n·k·(1+δ)/N rounds at ~1e-4 rad, which bounds this floor
    check(dbw <= -60.0, f"δ-warped demod DFT error floor {dbw:.1f} dB vs "
                        f"float64 (gate -60 dB)")

    code = modem._code
    lam = bench_llrs(modem, rx_dev, delays)
    ldpc_parity(code, lam, modem.cfg.ldpc_iters, "bench batch")
    # the bench batch is clean enough to decode in zero passes: re-modulate
    # its hard decisions at 1.9 dB Eb/N0 so the decoder iterates
    sigma = 0.8
    noise = jax.random.normal(jax.random.PRNGKey(SEED), lam.shape)
    hard = (2.0 * (jnp.sign(lam) + sigma * noise) / sigma**2).astype(jnp.float32)
    ldpc_parity(code, hard, modem.cfg.ldpc_iters, "iterating copy")
    return lam, hard


def _median_time(f, x, n: int = 20) -> float:
    """Median seconds of `n` calls of f(x), each fenced by
    `block_until_ready`, after two warm-up calls."""
    import jax

    for _ in range(2):
        jax.block_until_ready(f(x))
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(f(x))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def timing_phase(rx, lam, hard):
    """Bench-geometry step and LDPC stage with each LDPC route
    (informational: one process, medians of 20 fenced calls)."""
    import jax
    import jax.numpy as jnp

    from bench import MARGIN
    from gf3x import GF3_STANDARD, Modem

    cfg = GF3_STANDARD
    rx_dev = jax.device_put(jnp.asarray(rx))
    bits = {}
    for backend in ("triton", "xla"):
        m = Modem(cfg, max_delay=MARGIN + cfg.cp, ldpc_backend=backend)
        step = jax.jit(m.demodulate)
        bits[backend] = np.asarray(step(rx_dev)[0])
        t = _median_time(step, rx_dev)
        code = m._code
        dec = jax.jit(lambda l, b=backend: code.decode_jax(
            l.reshape(l.shape[0], -1), cfg.ldpc_iters, backend=b))
        tl = _median_time(dec, lam)
        th = _median_time(dec, hard)
        print(f"timing: ldpc={backend}: step {t * 1e3:.3f} ms "
              f"(B={rx.shape[0]}), LDPC alone {tl * 1e3:.3f} ms "
              f"(bench LLRs), {th * 1e3:.3f} ms (iterating copy)", flush=True)
    check(np.array_equal(bits["triton"], bits["xla"]),
          "step bits identical with either LDPC route")


def four_phase(B: int = 1024):
    """Sharded decode over four cards, each route against one card."""
    import jax
    import jax.numpy as jnp

    from bench import MARGIN
    from gf3x import GF3_STANDARD, Modem
    from gf3x.parallel import (make_mesh, shard_batch, sharded_decode,
                               sharded_pipeline_step)

    cfg = GF3_STANDARD
    modem = Modem(cfg, max_delay=MARGIN + cfg.cp)
    rx, payload, _ = _bench_batch(modem, B, MARGIN)
    # the dp×sp route shards the samples over 2: keep T even
    rx = np.pad(rx, ((0, 0), (0, rx.shape[1] % 2)))
    one = jax.jit(modem.demodulate)
    ref_bits, ref_diag = one(jax.device_put(jnp.asarray(rx), jax.devices()[0]))
    ref_bits = np.asarray(ref_bits)
    n_ok = sum(modem._result(b, None).crc_ok for b in ref_bits)
    check(n_ok == B, f"one-card decode: {n_ok}/{B} rows CRC-ok")

    mesh = make_mesh(4)
    bits, diag = sharded_decode(modem, mesh)(shard_batch(rx, mesh))
    check(np.array_equal(np.asarray(bits), ref_bits)
          and np.array_equal(np.asarray(diag.sync_start),
                             np.asarray(ref_diag.sync_start)),
          "sharded_decode shard_map route over 4 cards == one card")

    mesh2 = make_mesh(axes=("dp", "sp"), shape=(2, 2))
    bits2, _ = sharded_decode(modem, mesh2, seq_axis="sp")(rx)
    check(np.array_equal(np.asarray(bits2), ref_bits),
          "sharded_decode dp×sp GSPMD route over 4 cards == one card")

    rng = np.random.default_rng(SEED + 2)
    info = rng.integers(0, 2, (B, cfg.payload_bits_per_frame), dtype=np.uint8)
    key = jax.random.PRNGKey(SEED)
    out4 = sharded_pipeline_step(modem, mesh)(info, key, 25.0)
    out1 = sharded_pipeline_step(modem, make_mesh(1))(info, key, 25.0)
    check(float(out4[0]) == 0.0 and bool(out4[1])
          and np.array_equal(np.asarray(out4[2]), info)
          and np.array_equal(np.asarray(out4[2]), np.asarray(out1[2])),
          "sharded_pipeline_step over 4 cards: BER 0, bits == info == "
          "the one-card step's bits")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded decode over four GPUs")
    args = ap.parse_args(argv)
    devs = device_phase(4 if args.four else 1)
    sys.path.insert(0, str(ROOT))
    try:
        import gf3x  # noqa: F401
    except ImportError as e:
        sys.exit(f"chip_smoke: the gf3x package is not beside this script "
                 f"({e})")
    t0 = time.perf_counter()
    if args.four:
        four_phase()
    else:
        modem, rx, delays = main_path_phase()
        lam, hard = parity_phase(modem, rx, delays)
        timing_phase(rx, lam, hard)
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.0f} s",
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
