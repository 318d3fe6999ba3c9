"""Score-only Smith-Waterman forward pass as a Pallas kernel for the GPU
(Triton backend).

Same recurrence, boundary rows and best score as ops/sw.sw_forward, the
executable specification: the result is the ScoreMax ``max`` entry, the
best cell of the last row and the last column (sw.cpp:100-127).  Without
traceback the move priorities do not change any value, so each cell is
``H = max(diag + sub, E, F)``.

Layout: whole pairs ride the parallel axis, one DP cell per pair per step
(``block`` pairs per program).  Target rows are swept in strips of
``strip`` rows; inside a strip the rows run staggered (row ``s`` computes
query column ``t - s`` at step ``t``), so a cell's left, upper and
upper-left neighbours are values the strip holds in registers from the
two previous steps.  Only the strip's last row crosses to the next strip,
through an H/E row of ``Q + 1`` columns in device memory that the kernel
writes behind the column it reads.  Arrays are row-major with pairs
minor, ``(rows, pairs)``, so a row load is one coalesced vector.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from mgl_tpu.core.params import DP_NEG_INF
from mgl_tpu.utils import round_up

NEG = DP_NEG_INF


def _sw_score_kernel(tch_ref, q_ref, tl_ref, ql_ref, best_ref, hrow_ref,
                     erow_ref, *, n_strips: int, S: int, Q: int,
                     match: int, mismatch: int, gap_open: int, gap_ext: int,
                     indel_init: bool):
    BP = tl_ref.shape[1]
    tl = tl_ref[0, :]
    ql = ql_ref[0, :]
    negv = jnp.full((BP,), NEG, jnp.int32)

    def border(k):
        """First-row/column score at index k (sw.cpp:29-40): 0 at k = 0,
        else -open - (k-1)*ext under indel_init.  Arithmetic, not a
        select: the Triton lowering gives a scalar select's literal
        branch the predicate's type (i1)."""
        if indel_init:
            return jnp.minimum(k, 1) * (gap_ext - gap_open) - k * gap_ext
        return jnp.int32(0)

    def vec(x):
        return jnp.full((BP,), x, jnp.int32)

    # matrix row 0 is the first strip's row above
    def init_col(j, c):
        hrow_ref[j, :] = vec(border(j))
        erow_ref[j, :] = negv
        return c

    jax.lax.fori_loop(0, Q + 1, init_col, jnp.int32(0))

    def strip(k, best):
        i0 = k * S
        rows = [i0 + s + 1 for s in range(S)]
        tc = [tch_ref[i0 + s, :] for s in range(S)]
        last_row = [tl == r for r in rows]
        in_rows = [r <= tl for r in rows]
        bnd = [border(r) for r in rows]

        def step(t, c):
            ha_prev, H, Hp, E, F, qc, best = c
            col = jnp.minimum(t, Q)
            ha = hrow_ref[col, :]
            ea = erow_ref[col, :]
            qn = q_ref[jnp.minimum(t - 1, Q - 1), :]
            nH, nE, nF, nq = [], [], [], []
            for s in range(S):
                j = t - s
                if s == 0:
                    up_h, up_e, dg, qch = ha, ea, ha_prev, qn
                else:
                    up_h, up_e, dg, qch = H[s - 1], E[s - 1], Hp[s - 1], qc[s - 1]
                e = jnp.maximum(up_h - gap_open, up_e - gap_ext)
                f = jnp.maximum(H[s] - gap_open, F[s] - gap_ext)
                d = dg + jnp.where(qch == tc[s], match, mismatch)
                h = jnp.maximum(d, jnp.maximum(e, f))
                edge = j <= 0            # column 0 (and the ramp before it)
                h = jnp.where(edge, bnd[s], h)
                f = jnp.where(edge, NEG, f)
                cand = ((last_row[s] & (j >= 1) & (j <= ql))
                        | ((j == ql) & in_rows[s]))
                best = jnp.where(cand, jnp.maximum(best, h), best)
                nH.append(h)
                nE.append(e)
                nF.append(f)
                nq.append(qch)
            # the strip's last row hands column t-S+1 down; column 0 of
            # the carry row is never read back, so it takes the ramp
            w = jnp.maximum(t - (S - 1), 0)
            hrow_ref[w, :] = nH[-1]
            erow_ref[w, :] = nE[-1]
            return ha, nH, H, nE, nF, nq, best

        h0 = [vec(b) for b in bnd]
        c0 = (vec(border(i0)), h0, h0, [negv] * S, [negv] * S,
              [jnp.zeros((BP,), jnp.int32)] * S, best)
        return jax.lax.fori_loop(1, Q + S, step, c0)[-1]

    best_ref[0, :] = jax.lax.fori_loop(0, n_strips, strip, negv)


@functools.partial(jax.jit, static_argnames=(
    "match", "mismatch", "gap_open", "gap_ext", "indel_init", "strip",
    "block", "num_warps", "interpret"))
def sw_scores(tchar, query, tlen, qlen, *, match: int, mismatch: int,
              gap_open: int, gap_ext: int, indel_init: bool,
              strip: int = 16, block: int = 128, num_warps: int = 4,
              interpret: bool = False):
    """Best SW score per pair.

    tchar (T, B) and query (Q, B) int32 symbol codes, pairs minor; tlen,
    qlen (B,) int32 with 1 <= tlen <= T and 1 <= qlen <= Q.  Padding past
    a pair's lengths is never read into its result.  Returns (B,) int32,
    equal to ops/sw.compute_score_max(...)["max"].
    """
    T, B = tchar.shape
    Q = query.shape[0]
    Bp = round_up(B, block)
    Tp = round_up(T, strip)
    pad = lambda a, rows: jnp.pad(a.astype(jnp.int32),
                                  ((0, rows - a.shape[0]), (0, Bp - B)))
    tc = pad(tchar, Tp)
    qp = pad(query, Q)
    # pad lanes: lengths 1 keep every index in range; results are dropped
    tl = jnp.pad(tlen.astype(jnp.int32), (0, Bp - B),
                 constant_values=1)[None, :]
    ql = jnp.pad(qlen.astype(jnp.int32), (0, Bp - B),
                 constant_values=1)[None, :]
    kernel = functools.partial(
        _sw_score_kernel, n_strips=Tp // strip, S=strip, Q=Q, match=match,
        mismatch=mismatch, gap_open=gap_open, gap_ext=gap_ext,
        indel_init=indel_init)
    lane = lambda i: (0, i)
    best, _, _ = pl.pallas_call(
        kernel,
        grid=(Bp // block,),
        in_specs=[pl.BlockSpec((Tp, block), lane),
                  pl.BlockSpec((Q, block), lane),
                  pl.BlockSpec((1, block), lane),
                  pl.BlockSpec((1, block), lane)],
        out_specs=[pl.BlockSpec((1, block), lane),
                   pl.BlockSpec((Q + 1, block), lane),
                   pl.BlockSpec((Q + 1, block), lane)],
        out_shape=[jax.ShapeDtypeStruct((1, Bp), jnp.int32),
                   jax.ShapeDtypeStruct((Q + 1, Bp), jnp.int32),
                   jax.ShapeDtypeStruct((Q + 1, Bp), jnp.int32)],
        compiler_params=pl_triton.CompilerParams(num_warps=num_warps,
                                                 num_stages=1),
        backend="triton",
        interpret=interpret,
        name="sw_score_strips",
    )(tc, qp, tl, ql)
    return best[0, :B]
