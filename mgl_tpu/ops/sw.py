"""Batched anti-diagonal Smith-Waterman forward pass (JAX).

Batched redesign of the reference SW kernels (``mgl_sw/sw.cpp`` scalar
semantics; ``sw_avx.cpp`` band-parallel layout).  Key departures from the
reference:

* **Inter-pair vectorization**: the reference packs 8 anti-diagonal cells of
  ONE pair into AVX lanes; here whole *batches of pairs* ride the vector
  lanes, one DP cell per pair per step, the natural shape for ~100-500 bp
  sequences (SURVEY.md §7.3).
* **Wavefront over anti-diagonals**: all cells of diagonal d = i+j are
  independent; state for diagonals d-1/d-2 is carried between steps.
* **Run-length backtrack preserved**: the emitted backtrack codes are the
  reference's exact encoding (0 diag, +L DEL run, -L INS run), so the host
  CIGAR decode (ops/cigar.py) replays calculateCigar semantics verbatim.

Exact semantics replicated (sw.cpp:60-93,100-127):
  move priority diag >= INS >= DEL; gap-open on strictly-greater only;
  last-column max via >= (largest row wins); last-row tie-closer-to-diagonal.

This module is the plain JAX path and the semantic specification; the
score-only GPU kernel (kernels/sw_triton.py) is checked against it.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from mgl_tpu.core.params import DP_NEG_INF, OverhangStrategy, SWParameters


class SWForwardResult(NamedTuple):
    """Device outputs of the forward pass (diag-major).

    btr:      (D, B, R) int16, run-length backtrack codes per diagonal;
              cell (i, j) of pair b lives at btr[i + j, b, i].
              Empty (D=0) when traceback is disabled.
    last_col: (D, B) int32, score of cell (r=d-qlen, qlen) per diagonal
              (garbage where that cell is out of range).
    last_row: (D, B) int32, score of cell (tlen, j=d-tlen) per diagonal.
    """

    btr: jax.Array
    last_col: jax.Array
    last_row: jax.Array


from mgl_tpu.utils import shift_down as _shift_down  # shared



@functools.partial(
    jax.jit,
    static_argnames=("indel_init", "with_traceback"),
)
def sw_forward(
    target: jax.Array,   # (B, T) int32 ASCII codes, zero-padded
    tlen: jax.Array,     # (B,) int32
    query: jax.Array,    # (B, Q) int32
    qlen: jax.Array,     # (B,) int32
    match: jax.Array,    # () int32
    mismatch: jax.Array,
    gap_open: jax.Array,  # positive magnitude
    gap_ext: jax.Array,   # positive magnitude
    *,
    indel_init: bool,
    with_traceback: bool = True,
) -> SWForwardResult:
    """Batched affine-gap DP over anti-diagonals.

    ``indel_init`` selects the INDEL/LEADING_INDEL first-row/column
    initialization (sw.cpp:29-40); SOFTCLIP/IGNORE use zeros.
    """
    B, T = target.shape
    _, Q = query.shape
    R = T + 1                      # row axis: target index 0..T
    D = T + Q + 1                  # diagonals 0..T+Q
    neg = jnp.int32(DP_NEG_INF)

    r_iota = jax.lax.broadcasted_iota(jnp.int32, (B, R), 1)
    tchar = jnp.pad(target, ((0, 0), (1, 0)))          # tchar[:, r] = target base of row r
    # query padded so q_at(d-1) never reads OOB (d-1 <= T+Q-1)
    qpad = jnp.pad(query, ((0, 0), (0, T + 1)))

    w_open = gap_open.astype(jnp.int32)
    w_ext = gap_ext.astype(jnp.int32)
    w_match = match.astype(jnp.int32)
    w_mismatch = mismatch.astype(jnp.int32)

    def border(k):
        """First-row/column score at index k (sw.cpp:29-40): 0, or the
        leading-indel ramp -open-(k-1)*ext for k >= 1."""
        if indel_init:
            return jnp.where(k >= 1, -w_open - (k - 1) * w_ext, 0).astype(jnp.int32)
        return jnp.zeros_like(k, dtype=jnp.int32)

    # --- initial carries (diagonals 0 and 1) --------------------------------
    sc_prev2 = jnp.full((B, R), neg).at[:, 0].set(0)                  # diag 0
    sc_prev = jnp.full((B, R), neg)                                   # diag 1
    sc_prev = sc_prev.at[:, 0].set(border(jnp.int32(1)))              # cell (0,1)
    if R > 1:
        sc_prev = sc_prev.at[:, 1].set(border(jnp.int32(1)))          # cell (1,0)
    e_prev = jnp.full((B, R), neg)
    f_prev = jnp.full((B, R), neg)
    gapv_prev = jnp.ones((B, R), jnp.int32)
    gaph_prev = jnp.ones((B, R), jnp.int32)
    qdiag = jnp.zeros((B, R), jnp.int32)
    qdiag = qdiag.at[:, 0].set(qpad[:, 0])                            # diag 1, element 0

    qlen_c = qlen.astype(jnp.int32)[:, None]
    tlen_c = tlen.astype(jnp.int32)[:, None]

    def step(carry, d):
        sc_prev, sc_prev2, e_prev, f_prev, gapv_prev, gaph_prev, qdiag = carry

        # query char for this diagonal's new top element: query[d-1]
        qch = jax.lax.dynamic_slice_in_dim(qpad, d - 1, 1, axis=1)     # (B, 1)
        qdiag = _shift_down(qdiag, 0).at[:, 0].set(qch[:, 0])

        # E (vertical, DEL): from cell above (element r-1 of diag d-1)
        sc_up = _shift_down(sc_prev, neg)
        e_up = _shift_down(e_prev, neg)
        gv_up = _shift_down(gapv_prev, 1)
        open_v = sc_up - w_open
        ext_v = e_up - w_ext
        open_wins_v = open_v > ext_v                                   # strict > (sw.cpp:73)
        e_cur = jnp.where(open_wins_v, open_v, ext_v)
        gapv_cur = jnp.where(open_wins_v, 1, gv_up + 1)

        # F (horizontal, INS): from cell left (element r of diag d-1)
        open_h = sc_prev - w_open
        ext_h = f_prev - w_ext
        open_wins_h = open_h > ext_h                                   # strict > (sw.cpp:84)
        f_cur = jnp.where(open_wins_h, open_h, ext_h)
        gaph_cur = jnp.where(open_wins_h, 1, gaph_prev + 1)

        # diagonal move: element r-1 of diag d-2 + substitution score
        sub = jnp.where(qdiag == tchar, w_match, w_mismatch)
        diag_sc = _shift_down(sc_prev2, neg) + sub

        # priority diag >= INS(right) >= DEL(down)  (sw.cpp:60-71)
        is_diag = (diag_sc >= e_cur) & (diag_sc >= f_cur)
        ins_over_del = f_cur >= e_cur
        sc_cur = jnp.where(is_diag, diag_sc, jnp.where(ins_over_del, f_cur, e_cur))
        btr = jnp.where(
            is_diag, 0, jnp.where(ins_over_del, -gaph_cur, gapv_cur)
        )

        # boundaries: element 0 is row 0 (j=d), element d is column 0 (i=d)
        row0 = border(d)
        sc_cur = jnp.where(r_iota == 0, row0, sc_cur)
        sc_cur = jnp.where(r_iota == d, border(d), sc_cur)
        boundary = (r_iota == 0) | (r_iota == d)
        e_cur = jnp.where(boundary, neg, e_cur)
        f_cur = jnp.where(boundary, neg, f_cur)
        gapv_cur = jnp.where(boundary, 1, gapv_cur)
        gaph_cur = jnp.where(boundary, 1, gaph_cur)
        btr = jnp.where(boundary, 0, btr)

        # last-column / last-row samples for ScoreMax bookkeeping
        r_lc = jnp.clip(d - qlen_c, 0, R - 1)
        lc = jnp.take_along_axis(sc_cur, r_lc, axis=1)[:, 0]
        r_lr = jnp.clip(tlen_c, 0, R - 1)
        lr = jnp.take_along_axis(sc_cur, r_lr, axis=1)[:, 0]

        new_carry = (sc_cur, sc_prev, e_cur, f_cur, gapv_cur, gaph_cur, qdiag)
        if with_traceback:
            return new_carry, (btr.astype(jnp.int16), lc, lr)
        return new_carry, (lc, lr)

    ds = jnp.arange(2, D, dtype=jnp.int32)
    carry0 = (sc_prev, sc_prev2, e_prev, f_prev, gapv_prev, gaph_prev, qdiag)
    _, ys = jax.lax.scan(step, carry0, ds)

    if with_traceback:
        btr, lc, lr = ys
    else:
        lc, lr = ys
        btr = jnp.zeros((0, B, R), jnp.int16)
    return SWForwardResult(btr=btr, last_col=lc, last_row=lr)


def best_scores(target, tlen, query, qlen, params, *,
                indel_init: bool = False, impl: str = "auto",
                interpret: bool = False):
    """(B,) int32 best score per pair, the ScoreMax ``max`` entry (best
    cell of the last row and the last column), on device.

    target (B, T) and query (B, Q) int32 symbol codes with their lengths;
    ``params`` an SWParameters.  impl='pallas' runs the score-only GPU
    kernel (kernels/sw_triton.py), 'xla' the plain forward pass; 'auto'
    chooses by device (core/backend.resolve_impl).  Traceable inside jit.
    """
    from mgl_tpu.core.backend import resolve_impl

    if resolve_impl(impl) == "pallas":
        from mgl_tpu.kernels.sw_triton import sw_scores

        return sw_scores(target.T, query.T, tlen, qlen,
                         match=int(params.match),
                         mismatch=int(params.mismatch),
                         gap_open=int(params.gap_open),
                         gap_ext=int(params.gap_extend),
                         indel_init=indel_init, interpret=interpret)
    sw = sw_forward(target, tlen, query, qlen, jnp.int32(params.match),
                    jnp.int32(params.mismatch), jnp.int32(params.gap_open),
                    jnp.int32(params.gap_extend), indel_init=indel_init,
                    with_traceback=False)
    # only diagonals [ql-1, ql+tl-1) of last_col and [tl-1, tl+ql-1) of
    # last_row are real cells (compute_score_max's slicing); the rest
    # hold fill values that must not win the max
    neg = jnp.int32(DP_NEG_INF)
    d = jnp.arange(sw.last_col.shape[0], dtype=jnp.int32)[:, None]
    ql = qlen.astype(jnp.int32)[None, :]
    tl = tlen.astype(jnp.int32)[None, :]
    lc = jnp.where((d >= ql - 1) & (d < ql + tl - 1), sw.last_col, neg)
    lr = jnp.where((d >= tl - 1) & (d < tl + ql - 1), sw.last_row, neg)
    return jnp.maximum(jnp.max(lr, axis=0), jnp.max(lc, axis=0))


# ---------------------------------------------------------------------------
# Host-side ScoreMax (ez) computation — mirrors sw.cpp:100-127.
# ---------------------------------------------------------------------------

def compute_score_max(
    last_col: np.ndarray,   # (D-2, B) from sw_forward (diag d=2..D-1)
    last_row: np.ndarray,
    tlen: np.ndarray,
    qlen: np.ndarray,
) -> dict:
    """ScoreMax per pair (native fast path, NumPy fallback).  Returns dict
    of (B,) arrays: mqe, mqe_t, max, max_t, max_q, seg_length."""
    from mgl_tpu.native import score_max_bulk

    native = score_max_bulk(last_col, last_row, tlen, qlen)
    if native is not None:
        return native
    B = len(tlen)
    out = {k: np.zeros(B, dtype=np.int64) for k in
           ("mqe", "mqe_t", "max", "max_t", "max_q", "seg_length")}
    for b in range(B):
        tl, ql = int(tlen[b]), int(qlen[b])
        # last column: cell (i, ql) at diag i+ql -> ys index i+ql-2
        vals = last_col[ql - 1: ql + tl - 1, b]  # i = 1..tl
        mqe = int(vals.max())
        mqe_t = int(np.nonzero(vals == mqe)[0][-1]) + 1   # >= rule: last wins
        # last row: cell (tl, j) at diag tl+j -> ys index tl+j-2
        rvals = last_row[tl - 1: tl + ql - 1, b]  # j = 1..ql
        mx, mx_t, mx_q, seg = mqe, mqe_t, ql, 0
        # sequential > / tie-closer-to-diagonal scan (sw.cpp:117-127)
        for j in range(1, ql + 1):
            v = int(rvals[j - 1])
            if v > mx or (v == mx and abs(tl - j) < abs(mx_t - mx_q)):
                mx, mx_t, mx_q, seg = v, tl, j, ql - j
        out["mqe"][b], out["mqe_t"][b] = mqe, mqe_t
        out["max"][b], out["max_t"][b], out["max_q"][b] = mx, mx_t, mx_q
        out["seg_length"][b] = seg
    return out


# ---------------------------------------------------------------------------
# Convenience batch API (device forward + host decode).
# ---------------------------------------------------------------------------

def align_batch(
    targets: list[bytes],
    queries: list[bytes],
    params: SWParameters,
    strategy: OverhangStrategy,
    pad_to: tuple[int, int] | None = None,
) -> list[tuple[str, int]]:
    """Align a batch of pairs; returns [(cigar, offset), ...].

    Pads to ``pad_to`` (target, query) or the batch max lengths, and the
    pair count to a power of two, so compiled shapes recur; production
    callers length-bucket first (mgl_tpu.batch.bucketing).
    """
    from mgl_tpu.ops.cigar import decode_batch

    B = len(targets)
    assert B == len(queries) and B > 0
    tlen = np.array([len(t) for t in targets], dtype=np.int32)
    qlen = np.array([len(q) for q in queries], dtype=np.int32)
    T, Q = int(tlen.max()), int(qlen.max())
    if pad_to is not None:
        T, Q = max(T, pad_to[0]), max(Q, pad_to[1])
    Bp = max(8, 1 << (B - 1).bit_length())
    tbuf = np.zeros((Bp, T), dtype=np.int32)
    qbuf = np.zeros((Bp, Q), dtype=np.int32)
    for i, (t, q) in enumerate(zip(targets, queries)):
        tbuf[i, : len(t)] = np.frombuffer(t, dtype=np.uint8)
        qbuf[i, : len(q)] = np.frombuffer(q, dtype=np.uint8)
    tl = np.ones(Bp, np.int32)
    ql = np.ones(Bp, np.int32)
    tl[:B], ql[:B] = tlen, qlen

    indel_init = bool(
        strategy & (OverhangStrategy.INDEL | OverhangStrategy.LEADING_INDEL)
    )
    res = sw_forward(
        jnp.asarray(tbuf), jnp.asarray(tl), jnp.asarray(qbuf), jnp.asarray(ql),
        jnp.int32(params.match), jnp.int32(params.mismatch),
        jnp.int32(params.gap_open), jnp.int32(params.gap_extend),
        indel_init=indel_init,
    )
    btr = np.asarray(res.btr[:, :B])
    ez = compute_score_max(np.asarray(res.last_col[:, :B]),
                           np.asarray(res.last_row[:, :B]), tlen, qlen)
    return decode_batch(btr, ez, tlen, qlen, strategy)
