"""GF3 standard frame schema (reference L6, SURVEY.md §2):

    chirp ∥ [Schmidl–Cox symbol] ∥ K known symbols ∥ D pilot-bearing data symbols

Assembly/parsing of the bin-domain frame, shared by the jitted encode and
decode paths. All geometry is static from `ModemConfig` (BASELINE.json:10
"Full GF3 standard frame").
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import jax.numpy as jnp

from ..config import ModemConfig, layout

__all__ = [
    "data_symbols_from_bits",
    "frame_bin_matrix",
    "bits_from_llr_layout",
    "interleave_pilots",
    "split_pilots",
    "interleave_bits",
    "scatter_factors",
    "loading_tables",
    "loaded_qam_map",
    "loaded_demap_llr",
]


@dataclass(frozen=True)
class LoadingTables:
    """Host-side static tables of a per-bin bit-loading config (SPEC.md §5b).

    Wire order is GROUP-SORTED: each OFDM symbol's coded bits fill the
    loaded data bins in ascending constellation order (all QPSK bins, then
    all 16-QAM, then all 64-QAM bins), each group in ascending bin index,
    each bin MSB-first I-axis then Q-axis bits — so the map/demap is a few
    static reshapes per group plus ONE static permutation, never a per-bin
    loop (all shapes compile-time constant from the config)."""

    groups: tuple          # ((m, positions int32 ascending), ...) ascending m>0
    inv_perm: np.ndarray   # (n_data_bins,) int32 into concat(group syms)+[0]
    gain: float            # sqrt(n_data_bins / n_active): nulled bins' TX
                           # power reallocated uniformly to active data bins


@functools.lru_cache(maxsize=None)
def loading_tables(cfg: ModemConfig) -> LoadingTables:
    bits = np.asarray(cfg.bit_loading, dtype=np.int32)
    groups = tuple(
        (m, np.nonzero(bits == m)[0].astype(np.int32))
        for m in (2, 4, 6) if np.any(bits == m)
    )
    active = np.concatenate([pos for _, pos in groups])
    inv = np.full(cfg.n_data_bins, len(active), dtype=np.int32)  # → zero slot
    inv[active] = np.arange(len(active), dtype=np.int32)
    return LoadingTables(
        groups=groups, inv_perm=inv,
        gain=float(np.sqrt(cfg.n_data_bins / len(active))),
    )


def loaded_qam_map(cfg: ModemConfig, coded: jnp.ndarray) -> jnp.ndarray:
    """Group-sorted coded bits (..., D, R) → data-bin symbols
    (..., D, n_data_bins) complex64, zeros on nulled bins, active bins
    boosted by `gain` (total symbol power is loading-invariant)."""
    from ..ops.constellation import qam_map

    t = loading_tables(cfg)
    *lead, D, _ = coded.shape
    syms, off = [], 0
    for m, pos in t.groups:
        n = len(pos)
        grp = coded[..., off: off + n * m].reshape(*lead, D, n, m)
        syms.append(qam_map(grp, m))
        off += n * m
    cat = jnp.concatenate(
        syms + [jnp.zeros((*lead, D, 1), syms[0].dtype)], axis=-1)
    return jnp.take(cat, jnp.asarray(t.inv_perm), axis=-1) * t.gain


def loaded_demap_llr(cfg: ModemConfig, data: jnp.ndarray,
                     nv_eff: jnp.ndarray):
    """Equalized data bins (..., D, n_data_bins) + per-bin noise → group-
    sorted LLRs (..., D, R) and EVM (...,) over the active bins (the RX
    inverse of `loaded_qam_map`; nulled bins contribute nothing)."""
    from ..ops.constellation import hard_bits, qam_demap_llr, qam_map

    t = loading_tables(cfg)
    *lead, D, _ = data.shape
    llrs, err = [], 0.0
    for m, pos in t.groups:
        idx = jnp.asarray(pos)
        y = jnp.take(data, idx, axis=-1) * jnp.float32(1.0 / t.gain)
        nv = jnp.take(jnp.broadcast_to(nv_eff, data.shape), idx, axis=-1)
        nv = nv * jnp.float32(1.0 / t.gain**2)
        l3 = qam_demap_llr(y, nv, m)                     # (..., D, n_g, m)
        llrs.append(l3.reshape(*lead, D, len(pos) * m))
        err = err + jnp.sum(
            jnp.abs(y - qam_map(hard_bits(l3), m)) ** 2, axis=(-2, -1))
    evm = err / jnp.float32(D * cfg.n_active_bins)
    return jnp.concatenate(llrs, axis=-1), evm


def scatter_factors(R: int) -> tuple[int, int]:
    """(A2, B2) with A2·B2 = R and B2 the divisor nearest √R — the
    bin-scatter stage of the v3 interleaver. B2 = 1 (prime R) degrades
    gracefully to the plain symbol transpose."""
    root = R ** 0.5
    B2 = 1
    for d in range(2, R):
        if R % d == 0 and abs(d - root) < abs(B2 - root):
            B2 = d
    return R // B2, B2


def interleave_bits(cfg: ModemConfig, arr, inverse: bool = False):
    """Channel-bit interleaver (WIRE_FORMAT v3, SPEC.md §5a).

    arr: (..., raw_bits_per_frame) bits (TX) or LLRs (RX). Two stages of
    pure reshape/transpose (no gathers):

    1. symbol spread — the (R × D) rectangle (R = bits per OFDM symbol,
       D = data symbols) written row-major, read column-major: consecutive
       coded bits land on successive OFDM symbols, so a TIME-localized hit
       (impulse, collision) dents every codeword lightly instead of wiping
       one contiguous codeword region;
    2. bin scatter — the R axis itself is permuted by the (A2 × B2)
       transpose (σ(a·B2 + c) = c·A2 + a, `scatter_factors`): a FREQUENCY
       notch (contiguous bin range, hit in every symbol) then lands on
       coded positions spaced B2·D apart instead of one contiguous run.

    Works on numpy and jax arrays (shape ops only) — the golden twin calls
    the same function.
    """
    *lead, _ = arr.shape
    R, D = cfg.bits_per_ofdm_symbol, cfg.n_data_symbols
    A2, B2 = scatter_factors(R)
    if not inverse:
        x = arr.reshape(*lead, A2, B2, D).swapaxes(-3, -2)
        return x.reshape(*lead, R, D).swapaxes(-2, -1).reshape(*lead, R * D)
    x = arr.reshape(*lead, D, R).swapaxes(-2, -1)
    x = x.reshape(*lead, B2, A2, D).swapaxes(-3, -2)
    return x.reshape(*lead, R * D)


def interleave_pilots(cfg: ModemConfig, dsym: jnp.ndarray) -> jnp.ndarray:
    """Data symbols (..., n_data_bins) + class-standard pilots → (..., n_used).

    Strided layout (cfg.strided_pilots, the standard presets): the used band
    viewed as (n_pilots, spacing) groups, pilot at slot 0 of each group —
    pure reshape/concat, no scatter. Falls back to scatter for irregular
    layouts.
    """
    lay = layout(cfg)
    *lead, _ = dsym.shape
    if cfg.strided_pilots:
        sp = cfg.pilot_spacing
        grp = dsym.reshape(*lead, cfg.n_pilots, sp - 1)
        pil = jnp.broadcast_to(
            jnp.asarray(lay.pilot_vals), (*lead, cfg.n_pilots))[..., None]
        return jnp.concatenate([pil, grp], axis=-1).reshape(*lead, cfg.n_used)
    out = jnp.zeros((*lead, cfg.n_used), dtype=jnp.complex64)
    out = out.at[..., jnp.asarray(lay.data_pos)].set(dsym)
    out = out.at[..., jnp.asarray(lay.pilot_pos)].set(jnp.asarray(lay.pilot_vals))
    return out


def split_pilots(cfg: ModemConfig, bins: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(..., n_used) → (pilot bins (..., n_pilots), data bins (..., n_data_bins)),
    the inverse of `interleave_pilots` (slice/reshape on strided layouts)."""
    lay = layout(cfg)
    if cfg.strided_pilots:
        *lead, _ = bins.shape
        grp = bins.reshape(*lead, cfg.n_pilots, cfg.pilot_spacing)
        return grp[..., 0], grp[..., 1:].reshape(*lead, cfg.n_data_bins)
    return (bins[..., jnp.asarray(lay.pilot_pos)],
            bins[..., jnp.asarray(lay.data_pos)])


def data_symbols_from_bits(cfg: ModemConfig, coded_bits: jnp.ndarray) -> jnp.ndarray:
    """Channel bits (..., raw_bits_per_frame) → data-symbol bins (..., D, n_used).

    Maps Gray QAM onto data positions and writes the class-standard pilot
    values on pilot positions (same pilots every symbol — the phase-tracking
    reference, SURVEY.md Appendix "Pilot phase tracking").
    """
    from ..ops.constellation import qam_map

    *lead, _ = coded_bits.shape
    if cfg.bit_loading is not None:
        grp = coded_bits.reshape(
            *lead, cfg.n_data_symbols, cfg.bits_per_ofdm_symbol)
        return interleave_pilots(cfg, loaded_qam_map(cfg, grp))
    grp = coded_bits.reshape(*lead, cfg.n_data_symbols, cfg.n_data_bins, cfg.bits_per_symbol)
    dsym = qam_map(grp, cfg.bits_per_symbol)
    return interleave_pilots(cfg, dsym)


def frame_bin_matrix(cfg: ModemConfig, data_syms: jnp.ndarray) -> jnp.ndarray:
    """Prepend the K known channel-estimation symbols → (..., K+D, n_used)."""
    lay = layout(cfg)
    *lead, D, U = data_syms.shape
    known = jnp.broadcast_to(
        jnp.asarray(lay.known_syms), (*lead, cfg.n_known_symbols, U)
    )
    return jnp.concatenate([known, data_syms], axis=-2)


def bits_from_llr_layout(cfg: ModemConfig, llr: jnp.ndarray) -> jnp.ndarray:
    """Flatten demapper LLRs (..., D, n_data_bins, bps) → (..., raw_bits)."""
    *lead, _, _, _ = llr.shape
    return llr.reshape(*lead, cfg.raw_bits_per_frame)
