"""LDPC codec: matmul encoder + batched normalized-min-sum BP decoder.

The one component where the reference leans on compiled code (the C `ldpc`
library's encoder and sum-product decoder — SURVEY.md §3.1): here it becomes
JAX (SURVEY.md §8 step 5):

- **encode**: parity bits via one (batch×k)·(k×m) float32 matmul against the
  precomputed GF(2) projector, then mod 2 — back-substitution as a matmul.
- **decode**: LAYERED (block-row-serial) normalized min-sum over the
  quasi-cyclic block structure: each block row's check update reads the
  variable totals already updated by this iteration's earlier rows —
  roughly half the iterations to convergence of the flooding schedule at
  the same per-iteration cost. The base matrix is static, so circulant
  shifts are static rolls (XLA) or index arithmetic (the GPU kernel in
  `ops/pallas/ldpc_minsum.py`) and the only reductions are over the tiny
  static row degree. No sparse scatter into ragged structures — irregular
  connectivity is padded to rectangles (SURVEY.md §8 risk "LDPC in XLA").

A NumPy float64 twin of the decoder (same message schedule) serves the
golden model; `gf3x/native/` adds a C++ host codec for parity testing.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp

from .codes import N_BLOCK_COLS, block_rows, build_H_blocks, gf2_solve_parity

__all__ = ["LdpcCode"]

_ALPHA = 0.8  # min-sum normalization factor
_BIG = np.float32(1e30)


@dataclass(frozen=True)
class _Tables:
    """Static host-side decoder tables for one (lifting factor z, rate)."""

    z: int
    mb: int                   # parity block rows of the base matrix
    dmax: int                 # max check-node degree over block rows
    edge_col: np.ndarray      # (mb, Dmax) int32 — block column (24 = dummy)
    edge_shift: np.ndarray    # (mb, Dmax) int32
    edge_valid: np.ndarray    # (mb, Dmax) bool
    P: np.ndarray             # (m, k) uint8 — GF(2) parity projector


@functools.lru_cache(maxsize=None)
def _tables(z: int, rate: str) -> _Tables:
    mb = block_rows(rate)
    edges = build_H_blocks(z, rate)
    by_row: list[list[tuple[int, int]]] = [[] for _ in range(mb)]
    for (i, j, s) in edges:
        by_row[i].append((j, s))
    dmax = max(len(r) for r in by_row)
    col = np.full((mb, dmax), N_BLOCK_COLS, dtype=np.int32)  # dummy col
    shf = np.zeros((mb, dmax), dtype=np.int32)
    val = np.zeros((mb, dmax), dtype=bool)
    for i, r in enumerate(by_row):
        for d, (j, s) in enumerate(r):
            col[i, d], shf[i, d], val[i, d] = j, s, True
    return _Tables(
        z=z, mb=mb, dmax=dmax, edge_col=col, edge_shift=shf, edge_valid=val,
        P=gf2_solve_parity(z, rate),
    )


class LdpcCode:
    """QC-LDPC over the 24-block-column 802.16e-style family: n = 24z at
    every rate, k = (24 − m_b)·z with m_b block rows of parity (rate ∈
    `gf3x.fec.codes.RATES`: 1/2, 2/3, 3/4, 5/6)."""

    def __init__(self, z: int, rate: str = "1/2"):
        self.z = z
        self.rate = rate
        self.mb = block_rows(rate)
        self.n = N_BLOCK_COLS * z
        self.m = self.mb * z
        self.k = self.n - self.m
        self.t = _tables(z, rate)

    @classmethod
    @functools.lru_cache(maxsize=None)
    def _cached(cls, z: int, rate: str) -> "LdpcCode":
        return cls(z, rate)

    @classmethod
    def for_config(cls, cfg) -> "LdpcCode":
        return cls._cached(cfg.ldpc_z, getattr(cfg, "ldpc_rate", "1/2"))

    # ------------------------------------------------------------ host numpy
    def encode(self, u: np.ndarray) -> np.ndarray:
        """(..., k) uint8 info bits → (..., n) uint8 codeword [u | p]."""
        u = np.asarray(u, dtype=np.uint8)
        p = (u.astype(np.int64) @ self.t.P.T.astype(np.int64)) & 1
        return np.concatenate([u, p.astype(np.uint8)], axis=-1)

    def check(self, c: np.ndarray) -> np.ndarray:
        """Syndrome weight per codeword (0 ⇒ valid)."""
        from .codes import _dense_H
        H = _dense_H(self.z, self.rate)
        return ((c.astype(np.int64) @ H.T.astype(np.int64)) & 1).sum(axis=-1)

    def decode(self, llr: np.ndarray, iters: int = 25,
               early_exit: bool = True) -> tuple[np.ndarray, int]:
        """NumPy normalized-min-sum (golden twin). llr: (..., n), positive ⇒
        bit 0. Returns (info bits (..., k), message-update passes run).

        Early termination (all backends share the rule so decoded bits stay
        bit-identical): before each message update, codewords whose current
        totals already satisfy every parity check FREEZE — their messages
        stop updating, so their bits are those of the first zero-syndrome
        pass regardless of batch composition; the loop exits once every
        codeword is frozen (or `iters` passes ran)."""
        bits, it_run, _ = self.decode_diag(llr, iters, early_exit)
        return bits, it_run

    def decode_diag(self, llr: np.ndarray, iters: int = 25,
                    early_exit: bool = True):
        """`decode` + per-codeword convergence diag: (info bits (..., k),
        passes run (int), unsat (...,) bool — True where the final hard
        decisions still violate a parity check, i.e. the decoder gave up)."""
        lead = llr.shape[:-1]
        lam = llr.reshape(-1, self.n).astype(np.float64)
        total, it_run = self._np_minsum(lam, iters, early_exit)
        unsat = self.check((total < 0).astype(np.uint8)) > 0
        bits = (total < 0).astype(np.uint8)
        return (bits[..., : self.k].reshape(*lead, self.k), it_run,
                unsat.reshape(lead))

    def _np_unsat(self, totals: np.ndarray) -> np.ndarray:
        """totals: (B, 25, z) (incl. dummy col) → (B,) bool, True where any
        parity check of the hard decisions is violated."""
        t, z = self.t, self.z
        hard = totals[:, :N_BLOCK_COLS] < 0                       # (B, 24, z)
        unsat = np.zeros(totals.shape[0], dtype=bool)
        for i in range(self.mb):
            par = np.zeros((totals.shape[0], z), dtype=bool)
            for d in range(t.dmax):
                if not t.edge_valid[i, d]:
                    continue
                # check c of block row i touches var (c + s) mod z of col j
                par ^= np.roll(hard[:, t.edge_col[i, d]],
                               -int(t.edge_shift[i, d]), axis=-1)
            unsat |= par.any(axis=-1)
        return unsat

    def _np_minsum(self, lam: np.ndarray, iters: int,
                   early_exit: bool = True) -> tuple[np.ndarray, int]:
        """Layered (block-row-serial) normalized min-sum: each block row's
        check update reads the CURRENT variable totals — which already
        include this iteration's earlier rows — and writes its message
        delta back into them immediately. Within one block row the z checks
        touch disjoint variables (single circulant per base entry), so the
        vectorized per-row update equals check-serial processing; across
        rows the immediacy roughly halves the iterations to convergence vs
        the flooding schedule. All four backends (this, XLA, Pallas, C++)
        share the exact layer order and tie-breaking, so decoded bits stay
        bit-identical."""
        t, z = self.t, self.z
        B = lam.shape[0]
        lam_b = lam.reshape(B, N_BLOCK_COLS, z)
        totals = np.concatenate([lam_b, np.zeros((B, 1, z))], axis=1)  # +dummy
        c2v = np.zeros((self.mb, t.dmax, B, z))

        it_run = 0
        frozen = np.zeros(B, dtype=bool)
        for _ in range(iters):
            if early_exit:
                frozen = ~self._np_unsat(totals)
                if frozen.all():
                    break
            upd = ~frozen
            for i in range(self.mb):
                d = int(np.sum(t.edge_valid[i]))
                cols = t.edge_col[i, :d]
                shfs = t.edge_shift[i, :d]
                # v2c in check order: roll(tot, −s) − c2v (current totals)
                v2c = np.stack(
                    [np.roll(totals[:, cols[e]], -int(shfs[e]), axis=-1)
                     - c2v[i, e] for e in range(d)], axis=0)       # (d, B, z)
                mag = np.abs(v2c)
                sgn = np.where(v2c < 0, -1.0, 1.0)
                prod = np.prod(sgn, axis=0, keepdims=True)
                m1 = np.min(mag, axis=0, keepdims=True)
                am = np.argmin(mag, axis=0, keepdims=True)
                mask = np.arange(d)[:, None, None] == am
                m2 = np.min(np.where(mask, np.inf, mag), axis=0, keepdims=True)
                mins = np.where(mask, m2, m1)
                new = _ALPHA * (prod * sgn) * mins                 # (d, B, z)
                for e in range(d):
                    delta = np.where(upd[:, None], new[e] - c2v[i, e], 0.0)
                    totals[:, cols[e]] += np.roll(delta, int(shfs[e]), axis=-1)
                    c2v[i, e] = np.where(upd[:, None], new[e], c2v[i, e])
            it_run += 1
        return totals[:, :N_BLOCK_COLS].reshape(B, self.n), it_run

    # -------------------------------------------------------------- jax path
    def encode_jax(self, u: jnp.ndarray) -> jnp.ndarray:
        """(..., k) uint8 → (..., n) uint8. Parity via a matmul mod 2.

        Exact at any matmul precision, TF32 included: the operands are 0/1
        (exact in TF32's 10-bit mantissa) and every row sum stays far below
        2²⁴, so the float32 accumulation is exact integer arithmetic."""
        Pt = jnp.asarray(self.t.P.T.astype(np.float32))              # (k, m)
        uf = u.astype(jnp.float32)
        p = jnp.dot(uf, Pt, preferred_element_type=jnp.float32)
        p = jnp.mod(p, 2.0).astype(jnp.uint8)
        return jnp.concatenate([u.astype(jnp.uint8), p], axis=-1)

    def decode_jax(self, llr: jnp.ndarray, iters: int,
                   backend: str | None = None,
                   early_exit: bool = True, with_diag: bool = False,
                   interpret: bool = False):
        """(..., n) float32 LLRs (positive ⇒ bit 0) → (..., k) uint8 info bits.

        Layered normalized min-sum, all shapes static. Leading dims are
        flattened into the batch axis and restored — callers may vmap/shard
        over them freely.

        `backend` picks one of two formulations with the same message
        schedule and freeze rule (bit-equal decodes):
        'triton' — the Pallas kernel (`ops.pallas.ldpc_minsum`), one
        codeword per program with its messages held on chip; it compiles
        only for a GPU, or runs in the Pallas interpreter with
        `interpret=True` — and 'xla' — static `jnp.roll` circulants over
        the whole batch (`_minsum_xla`, the reference the kernel is tested
        against). None takes 'triton' where the program is lowered for a
        CUDA GPU and 'xla' elsewhere.

        `early_exit` enables on-device early termination (same freeze rule
        as `decode`; `iters` becomes the maximum).

        `with_diag=True` also returns (iters_run (...,) int32 — message-
        update passes the codeword ran — and unsat (...,) bool — True
        where the final hard decisions still violate a parity check): the
        decoder-stress observability of SURVEY.md §6.5.
        """
        lead = llr.shape[:-1]
        lam_b = llr.reshape(-1, N_BLOCK_COLS, self.z).astype(jnp.float32)

        def kernel(lam):
            from ..ops.pallas.ldpc_minsum import minsum_totals
            return minsum_totals(lam, self.z, iters, early_exit, self.rate,
                                 interpret)

        def xla(lam):
            return self._minsum_xla(lam, iters, early_exit)

        if backend is None:
            # decided when the program is lowered, for the platform it is
            # lowered for: a trace cannot see its target device
            tot, it_run, unsat = jax.lax.platform_dependent(
                lam_b, cuda=kernel, default=xla)
        elif backend == "triton":
            tot, it_run, unsat = kernel(lam_b)
        elif backend == "xla":
            tot, it_run, unsat = xla(lam_b)
        else:
            raise ValueError(f"unknown LDPC backend {backend!r}; "
                             "use 'triton' or 'xla'")
        total = tot.reshape(-1, self.n)
        bits = (total < 0).astype(jnp.uint8)[:, : self.k].reshape(*lead, self.k)
        if not with_diag:
            return bits
        return bits, it_run.reshape(lead), unsat.reshape(lead)

    def _minsum_xla(self, lam_b: jnp.ndarray, iters: int, early_exit: bool):
        """The XLA layered min-sum core. lam_b: (B, 24, z) → (totals
        (B, 24, z), passes run per codeword (B,) int32, unsat (B,) bool).
        The loop runs while any codeword of the batch is unconverged;
        frozen codewords keep their messages and totals."""
        z = self.z
        B = lam_b.shape[0]
        edges = build_H_blocks(z, self.rate)                          # row-major
        rows: list[list[tuple[int, int, int]]] = [[] for _ in range(self.mb)]
        for e, (i, j, s) in enumerate(edges):
            rows[i].append((e, j, s))
        E = len(edges)

        def sweep(tot, c2v, frozen):
            """One layered iteration: each block row reads the CURRENT
            totals (already updated by this iteration's earlier rows) and
            writes its message delta back immediately. `frozen` (B,) lanes
            keep messages AND totals. tot: (B, 24, z), c2v: (E, B, z)."""
            upd = None if frozen is None else \
                jnp.logical_not(frozen)[:, None].astype(jnp.float32)
            for i in range(self.mb):
                v2c = jnp.stack(
                    [jnp.roll(tot[:, j], -s, axis=-1) - c2v[e]
                     for (e, j, s) in rows[i]], axis=0)               # (d, B, z)
                mag = jnp.abs(v2c)
                sgn = jnp.where(v2c < 0, -1.0, 1.0)
                prod = jnp.prod(sgn, axis=0, keepdims=True)
                m1 = jnp.min(mag, axis=0, keepdims=True)
                am = jnp.argmin(mag, axis=0, keepdims=True)
                d = len(rows[i])
                mask = jnp.arange(d)[:, None, None] == am
                m2 = jnp.min(jnp.where(mask, _BIG, mag), axis=0, keepdims=True)
                mins = jnp.where(mask, m2, m1)
                out = _ALPHA * (prod * sgn) * mins                    # (d, B, z)
                for di, (e, j, s) in enumerate(rows[i]):
                    delta = out[di] - c2v[e]
                    if upd is not None:
                        delta = delta * upd
                    tot = tot.at[:, j].set(
                        tot[:, j] + jnp.roll(delta, s, axis=-1))
                    c2v = c2v.at[e].set(c2v[e] + delta)
            return tot, c2v

        def unsat_of(tot):
            """(B, 24, z) totals → (B,) bool: any parity check violated."""
            hard = tot < 0
            unsat = jnp.zeros(B, dtype=bool)
            for i in range(self.mb):
                par = jnp.zeros((B, z), dtype=bool)
                for (_, j, s) in rows[i]:
                    par = par ^ jnp.roll(hard[:, j], -s, axis=-1)
                unsat = unsat | jnp.any(par, axis=-1)
            return unsat

        c2v = jnp.zeros((E, B, z), jnp.float32)
        tot = lam_b
        if early_exit:
            def cond(state):
                it, done, _, _, _ = state
                return (it < iters) & jnp.logical_not(done)

            def body(state):
                it, _, n_upd, tot, c2v = state
                frozen = jnp.logical_not(unsat_of(tot))
                tot, c2v = sweep(tot, c2v, frozen)
                # a codeword's count is the sweeps that updated it — the
                # final body, run once everything is frozen, adds nothing
                n_upd = n_upd + jnp.logical_not(frozen).astype(jnp.int32)
                return it + 1, jnp.all(frozen), n_upd, tot, c2v

            _, _, it_run, tot, _ = jax.lax.while_loop(
                cond, body, (jnp.int32(0), jnp.bool_(False),
                             jnp.zeros(B, jnp.int32), tot, c2v))
        else:
            def body(_, state):
                tot, c2v = state
                return sweep(tot, c2v, None)

            tot, _ = jax.lax.fori_loop(0, iters, body, (tot, c2v))
            it_run = jnp.full(B, iters, jnp.int32)
        return tot, it_run, unsat_of(tot)
