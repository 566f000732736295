"""Pallas (Triton route) kernel: layered normalized min-sum LDPC decoder,
one codeword per program.

The XLA formulation (`LdpcCode._minsum_xla`) streams the whole (E, B, z)
message state and the touched totals columns through device memory on
every layered row of every iteration, and runs the whole batch while any
codeword is unconverged. Here each program owns one codeword, and its whole
decoder state lives in its own slices of the outputs, which stay in the
L1/L2 caches while the program runs:

- the variable totals (24·z floats) in the totals output, so device memory
  sees the LLRs once in and the totals once out;
- the check-to-variable messages (one z-vector per edge slot) in a message
  output the caller discards;
- a circulant shift is index arithmetic on the load and the store: check c
  of block row i reads variable (c + s) mod z of block column j;
- the early exit is per program: a codeword that satisfies every parity
  check stops, and a straggler holds back only itself.

The block rows are a loop over a small (row → degree, columns, shifts)
table, each row padded to the largest degree with masked edges. Unrolling
the rows and carrying the messages in registers runs ≈25 % faster but
compiles for ≈60 s per batch shape against ≈5 s for this form (H100 SXM,
GF3 rate-1/2 code at z = 96), and every new batch shape of a streaming
receiver pays that compile.

z is padded to a power of two of lanes with masks. The message schedule,
the min1/min2 tie-breaking (first index wins, as `argmin`) and the freeze
rule are those of the XLA and NumPy twins, so decoded bits are identical;
the totals can differ in the last bits where the GPU compiler contracts a
multiply and a subtract into one FMA.

Within a row every edge's load and store touch the same addresses from the
same lanes, but the next row reads them through another shift, i.e. from
other threads: a block barrier orders each row's stores before the next
row's loads (the interpreter runs sequentially and needs none).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ...fec.codes import N_BLOCK_COLS, block_rows, build_H_blocks

__all__ = ["minsum_totals"]

_ALPHA = 0.8
_BIG = np.float32(1e30)


@functools.lru_cache(maxsize=None)
def _row_table(z: int, rate: str) -> np.ndarray:
    """(m_b, 1 + 2·dmax) int32: per block row its degree, then the block
    columns, then the circulant shifts of its edges (zero-padded)."""
    rows = [[] for _ in range(block_rows(rate))]
    for (i, j, s) in build_H_blocks(z, rate):
        rows[i].append((j, s))
    dmax = max(len(r) for r in rows)
    tab = np.zeros((len(rows), 1 + 2 * dmax), np.int32)
    for i, r in enumerate(rows):
        tab[i, 0] = len(r)
        for d, (j, s) in enumerate(r):
            tab[i, 1 + d], tab[i, 1 + dmax + d] = j, s
    return tab


def _kernel(tab_ref, lam_ref, tot_ref, diag_ref, c2v_ref, *, z: int, zp: int,
            iters: int, mb: int, dmax: int, early_exit: bool, sync: bool):
    lane = jax.lax.broadcasted_iota(jnp.int32, (zp,), 0)
    valid = lane < z

    def barrier():
        if sync:
            plgpu.debug_barrier()

    def at(s):
        # check order → variable index: lane c reads variable (c + s) mod z;
        # pad lanes point past the row (masked, and distinct from every
        # valid address, so the interpreter's scatter cannot collide)
        return jnp.where(valid, (lane + s) % z, lane)

    def edges(i):
        """Row i's (column, shift, lane mask) per edge slot; slots past the
        row's degree are masked out."""
        deg = tab_ref[i, 0]
        return [(tab_ref[i, 1 + d], tab_ref[i, 1 + dmax + d], valid & (d < deg))
                for d in range(dmax)]

    def row(i, carry):
        """Row i's check update: read the CURRENT totals (already updated
        by this pass's earlier rows), write the message delta back."""
        es = edges(i)
        tot = [plgpu.load(tot_ref.at[j, at(s)], mask=m, other=0.0)
               for j, s, m in es]
        c2v = [plgpu.load(c2v_ref.at[i * dmax + d, lane], mask=m, other=0.0)
               for d, (_, _, m) in enumerate(es)]
        v2c = [t - c for t, c in zip(tot, c2v)]
        # masked slots: magnitude _BIG and sign +1 leave min1/min2/sign alone
        mag = [jnp.where(m, jnp.abs(v), _BIG) for v, (_, _, m) in zip(v2c, es)]
        sgn = [jnp.where(v < 0, -1.0, 1.0) for v in v2c]
        prod = sgn[0]
        for sg in sgn[1:]:
            prod = prod * sg
        m1 = mag[0]
        for mg in mag[1:]:
            m1 = jnp.minimum(m1, mg)
        # the FIRST edge attaining the minimum gets min2 (argmin ties)
        seen = jnp.zeros((zp,), jnp.bool_)
        first = []
        for mg in mag:
            at_min = mg == m1
            first.append(at_min & jnp.logical_not(seen))
            seen = seen | at_min
        m2 = jnp.full((zp,), _BIG, jnp.float32)
        for mg, f in zip(mag, first):
            m2 = jnp.minimum(m2, jnp.where(f, _BIG, mg))
        for d, (j, s, m) in enumerate(es):
            mins = jnp.where(first[d], m2, m1)
            delta = _ALPHA * (prod * sgn[d]) * mins - c2v[d]
            plgpu.store(tot_ref.at[j, at(s)], tot[d] + delta, mask=m)
            plgpu.store(c2v_ref.at[i * dmax + d, lane], c2v[d] + delta, mask=m)
        barrier()
        return carry

    def sweep():
        jax.lax.fori_loop(0, mb, row, 0)

    def unsat():
        """1 when the hard decisions of the current totals violate any
        parity check, else 0 (int32 scalar)."""
        def check_row(i, bad):
            par = jnp.zeros((zp,), jnp.int32)
            for j, s, m in edges(i):
                t = plgpu.load(tot_ref.at[j, at(s)], mask=m, other=0.0)
                par = par ^ (t < 0).astype(jnp.int32)
            return bad | par

        bad = jax.lax.fori_loop(0, mb, check_row, jnp.zeros((zp,), jnp.int32))
        barrier()
        return jnp.max(jnp.where(valid, bad, 0))

    for j in range(N_BLOCK_COLS):
        plgpu.store(tot_ref.at[j, at(0)],
                    plgpu.load(lam_ref.at[j, at(0)], mask=valid, other=0.0),
                    mask=valid)
    zeros = jnp.zeros((zp,), jnp.float32)
    for e in range(mb * dmax):
        plgpu.store(c2v_ref.at[e, lane], zeros, mask=valid)
    barrier()
    if early_exit:
        def cond(state):
            it, bad = state
            return (it < iters) & (bad != 0)

        def body(state):
            it, _ = state
            sweep()
            return it + 1, unsat()

        it, bad = jax.lax.while_loop(cond, body, (jnp.int32(0), unsat()))
    else:
        def body(_, carry):
            sweep()
            return carry

        jax.lax.fori_loop(0, iters, body, 0)
        it, bad = jnp.int32(iters), unsat()
    k = jax.lax.broadcasted_iota(jnp.int32, (2,), 0)
    diag_ref[...] = jnp.where(k == 0, bad, it)


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4, 5))
def minsum_totals(lam: jnp.ndarray, z: int, iters: int, early_exit: bool = True,
                  rate: str = "1/2", interpret: bool = False):
    """lam: (B, 24, z) f32 LLRs (positive ⇒ bit 0) → (totals (B, 24, z)
    f32, iters_run (B,) int32 — message-update passes each codeword ran —,
    unsat (B,) bool — final hard decisions still violate a parity check).

    `interpret=True` runs the Pallas interpreter (CPU tests); otherwise the
    kernel compiles through Triton and needs a GPU."""
    B = lam.shape[0]
    tab = _row_table(z, rate)
    mb, dmax = tab.shape[0], (tab.shape[1] - 1) // 2
    zp = max(32, 1 << (z - 1).bit_length())
    kern = functools.partial(
        _kernel, z=z, zp=zp, iters=iters, mb=mb, dmax=dmax,
        early_exit=early_exit, sync=not interpret)
    cols = pl.BlockSpec((None, N_BLOCK_COLS, z), lambda b: (b, 0, 0))
    tot, diag, _ = pl.pallas_call(
        kern,
        grid=(B,),
        in_specs=[pl.BlockSpec(tab.shape, lambda b: (0, 0)), cols],
        out_specs=(
            cols,
            pl.BlockSpec((None, 2), lambda b: (b, 0)),
            pl.BlockSpec((None, mb * dmax, z), lambda b: (b, 0, 0)),
        ),
        out_shape=(
            jax.ShapeDtypeStruct(lam.shape, jnp.float32),
            jax.ShapeDtypeStruct((B, 2), jnp.int32),
            jax.ShapeDtypeStruct((B, mb * dmax, z), jnp.float32),
        ),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=zp // 32,
                                             num_stages=1),
        interpret=interpret,
        name="ldpc_minsum",
    )(jnp.asarray(tab), lam.astype(jnp.float32))
    return tot, diag[:, 1], diag[:, 0] != 0
