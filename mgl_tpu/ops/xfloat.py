"""Extended-range double-float arithmetic ("xfloat") + the on-device
PairHMM f64 rescue tier.

Device replacement for the reference's double-precision rescue kernel
(``mgl_pairhmm/compute_prob_avxd.cc`` and the tier driver
``com_microsoft_mgl_pairhmm_MicrosoftPairHmm.cc:199-213``), built from f32
operations only.  Plain double-float (two f32s) has f32's *exponent
range* — useless here, because the rescue tier exists precisely to
survive exponents far below 1e-38 (the forward matrix spans hundreds of
decades across read rows).  The number format is therefore

    value = (hi + lo) * 2^e      hi, lo: f32 (double-float mantissa,
                                 ~48-bit precision; hi in [1, 2) or 0)
                                 e: int32 (per-element exponent)

which exceeds f64 in both range and (slightly) matches it in precision
(2^-47 vs 2^-52; the parity contract is 1e-5 in log10 space, ~2.3e-5
relative, so both are far inside tolerance).

Everything in the forward DP is nonnegative (probabilities, sums of
products), so there is no cancellation and renormalization after add/mul
is a single conditional halving — no exponent extraction needed.  The
mantissa product uses Dekker splitting, which needs every product and sum
rounded on its own: a compiler that contracted a multiply and an add into
one fused operation would change the error terms.  On the H100, XLA keeps
them separate (the rescue tier matches the reference's f64 goldens there;
see PERF.md).  Native f64 in its place is ROADMAP speed item 5.

The rescue forward pass mirrors the anti-diagonal sweep of
ops/pairhmm.pairhmm_forward_f32 (the executable spec) with xfloat state;
transition/emission rows are the *double*-context tables
(core/context.CTX_F64, Context.h:105-134) split exactly into
(hi, lo, e) on the host.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

E_ZERO = -(1 << 27)          # exponent tag for zero (below any real value)
_SPLIT = np.float32(4097.0)  # Dekker split constant for f32 (2^12 + 1)


class XF(NamedTuple):
    """One xfloat tensor: three same-shape arrays."""

    hi: jax.Array   # f32 mantissa head, 0 or in [1, 2)
    lo: jax.Array   # f32 mantissa tail, |lo| <= ulp(hi)
    e: jax.Array    # i32 exponent


# ---------------------------------------------------------------- host side

def xf_split(x: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Exact f64 -> (hi, lo, e) split (host).  Nonnegative inputs only."""
    x = np.asarray(x, np.float64)
    m, e = np.frexp(x)          # m in [0.5, 1) or 0
    m, e = m * 2.0, e - 1       # normalize mantissa to [1, 2)
    hi = m.astype(np.float32)
    lo = (m - hi.astype(np.float64)).astype(np.float32)
    e = np.where(x == 0.0, E_ZERO, e).astype(np.int32)
    hi = np.where(x == 0.0, np.float32(0), hi)
    return hi, lo, e


def xf_to_f64(hi, lo, e) -> np.ndarray:
    """(hi, lo, e) -> f64 with natural f64 under/overflow semantics (host).
    Exponents beyond f64's range saturate to 0 / inf exactly as the
    reference's all-f64 kernel would have under/overflowed."""
    hi = np.asarray(hi, np.float64)
    lo = np.asarray(lo, np.float64)
    e = np.clip(np.asarray(e, np.int64), -4000, 4000).astype(np.int32)
    return np.ldexp(hi + lo, e)


# -------------------------------------------------------------- device side

def xf_zeros(shape) -> XF:
    return XF(jnp.zeros(shape, jnp.float32), jnp.zeros(shape, jnp.float32),
              jnp.full(shape, E_ZERO, jnp.int32))


def _renorm1(hi, lo, e):
    """Exact renormalization to hi in [1, 2) via exponent-bit extraction.
    Nonnegative arithmetic keeps post-op mantissas in [1, 4) (never
    subnormal), so the extracted exponent is always valid; zero is gated."""
    bits = jax.lax.bitcast_convert_type(hi, jnp.int32)
    eh = ((bits >> 23) & 0xFF) - 127
    scale = jax.lax.bitcast_convert_type(
        ((127 - eh) << 23).astype(jnp.int32), jnp.float32)
    iszero = hi == 0.0
    return (jnp.where(iszero, 0.0, hi * scale),
            jnp.where(iszero, 0.0, lo * scale),
            jnp.where(iszero, e, e + eh))


def xf_mul(a: XF, b: XF) -> XF:
    """Product.  Mantissas in [1,2) (or 0) -> exact Dekker two-product plus
    cross terms; one renorm."""
    ah, al, bh, bl = a.hi, a.lo, b.hi, b.lo
    p = ah * bh
    ca = _SPLIT * ah
    a_big = ca - (ca - ah)
    a_lo = ah - a_big
    cb = _SPLIT * bh
    b_big = cb - (cb - bh)
    b_lo = bh - b_big
    err = ((a_big * b_big - p) + a_big * b_lo + a_lo * b_big) + a_lo * b_lo
    t = err + (ah * bl + al * bh)
    # fast renormalize (p dominates t)
    s = p + t
    lo = t - (s - p)
    hi, lo, e = _renorm1(s, lo, jnp.maximum(a.e + b.e, E_ZERO))
    return XF(hi, lo, e)


def xf_add(a: XF, b: XF) -> XF:
    """Sum of nonnegative xfloats: align exponents, two-sum, renorm."""
    swap = b.e > a.e
    bh_ = jnp.where(swap, a.hi, b.hi)
    bl_ = jnp.where(swap, a.lo, b.lo)
    be_ = jnp.where(swap, a.e, b.e)
    ah_ = jnp.where(swap, b.hi, a.hi)
    al_ = jnp.where(swap, b.lo, a.lo)
    ae_ = jnp.where(swap, b.e, a.e)
    d = be_ - ae_                                    # <= 0
    dc = jnp.maximum(d, -126)
    scale = jax.lax.bitcast_convert_type(
        ((dc + 127) << 23).astype(jnp.int32), jnp.float32)
    scale = jnp.where(d < -126, 0.0, scale)
    sh = bh_ * scale
    sl = bl_ * scale
    # branchless two-sum of the heads + tails
    s = ah_ + sh
    v = s - ah_
    err = (ah_ - (s - v)) + (sh - v)
    t = err + al_ + sl
    s2 = s + t
    lo = t - (s2 - s)
    hi, lo, e = _renorm1(s2, lo, ae_)
    return XF(hi, lo, e)


def xf_where(cond, a: XF, b: XF) -> XF:
    return XF(jnp.where(cond, a.hi, b.hi), jnp.where(cond, a.lo, b.lo),
              jnp.where(cond, a.e, b.e))


def xf_shift_down(a: XF) -> XF:
    """out[..., r] = a[..., r-1]; row 0 = zero (DP shift along read rows)."""
    from mgl_tpu.utils import shift_down

    return XF(shift_down(a.hi, 0.0), shift_down(a.lo, 0.0),
              shift_down(a.e, E_ZERO))


def _take_lane(a: XF, idx) -> XF:
    """a[..., idx] per batch row; idx (B, 1) -> (B,) triple."""
    return XF(
        jnp.take_along_axis(a.hi, idx, axis=1)[:, 0],
        jnp.take_along_axis(a.lo, idx, axis=1)[:, 0],
        jnp.take_along_axis(a.e, idx, axis=1)[:, 0],
    )


# ------------------------------------------------------- rescue forward pass

AMBIG = ord("N")


@jax.jit
def pairhmm_forward_xf(
    hap, haplen, rchar, rslen,
    p_mm: XF, p_gapm: XF, p_mx: XF, p_my: XF, p_zz: XF,
    dm: XF, dmm: XF, y_init: XF,
):
    """Batched extended-range forward scores.

    Same anti-diagonal sweep and recurrence shape as pairhmm_forward_f32
    (compute_prob_scalar.cc:39-43), state in xfloat.  ``y_init`` is the
    (B,)-shaped triple 2^1020/haplen (Context<double>, Context.h:109).
    Returns the (B,) score triple (hi, lo, e).
    """
    B, R = rchar.shape
    H = hap.shape[1]
    D = R + H

    r_iota = jax.lax.broadcasted_iota(jnp.int32, (B, R), 1)
    hpad = jnp.pad(hap, ((0, 0), (0, R + 1)))
    rl = rslen.astype(jnp.int32)[:, None]
    hl = haplen.astype(jnp.int32)[:, None]
    y_init_col = XF(y_init.hi[:, None], y_init.lo[:, None], y_init.e[:, None])

    zero = xf_zeros((B, R))

    def seed_y():
        # column vector with row 0 = y_init, rest zero
        row0 = r_iota == 0
        return xf_where(row0, XF(jnp.broadcast_to(y_init_col.hi, (B, R)),
                                 jnp.broadcast_to(y_init_col.lo, (B, R)),
                                 jnp.broadcast_to(y_init_col.e, (B, R))),
                        zero)

    m_prev2, x_prev2, y_prev2 = zero, zero, seed_y()
    m_prev, x_prev, y_prev = zero, zero, seed_y()
    hapdiag = jnp.zeros((B, R), jnp.int32).at[:, 0].set(hpad[:, 0])

    def step(carry, d):
        m_prev, x_prev, y_prev, m_prev2, x_prev2, y_prev2, hapdiag, acc = carry

        hch = jax.lax.dynamic_slice_in_dim(hpad, d - 1, 1, axis=1)
        from mgl_tpu.utils import shift_down
        hapdiag = shift_down(hapdiag, 0).at[:, 0].set(hch[:, 0])

        is_match = (rchar == hapdiag) | (rchar == AMBIG) | (hapdiag == AMBIG)
        distm = xf_where(is_match, dm, dmm)

        m_d2 = xf_shift_down(m_prev2)
        x_d2 = xf_shift_down(x_prev2)
        y_d2 = xf_shift_down(y_prev2)
        xy_d2 = xf_add(x_d2, y_d2)
        m_cur = xf_mul(distm, xf_add(xf_mul(m_d2, p_mm),
                                     xf_mul(xy_d2, p_gapm)))

        y_cur = xf_add(xf_mul(m_prev, p_my), xf_mul(y_prev, p_zz))

        m_d1 = xf_shift_down(m_prev)
        x_d1 = xf_shift_down(x_prev)
        x_cur = xf_add(xf_mul(m_d1, p_mx), xf_mul(x_d1, p_zz))

        row0 = r_iota == 0
        col0 = r_iota == d
        zb = xf_zeros((B, R))
        m_cur = xf_where(row0 | col0, zb, m_cur)
        x_cur = xf_where(row0 | col0, zb, x_cur)
        y_cur = xf_where(col0, zb, xf_where(row0, XF(
            jnp.broadcast_to(y_init_col.hi, (B, R)),
            jnp.broadcast_to(y_init_col.lo, (B, R)),
            jnp.broadcast_to(y_init_col.e, (B, R))), y_cur))

        mv = _take_lane(m_cur, rl)
        xv = _take_lane(x_cur, rl)
        c = d - rl[:, 0]
        valid = (c >= 1) & (c <= hl[:, 0])
        contrib = xf_where(valid, xf_add(mv, xv), xf_zeros((B,)))
        acc = xf_add(acc, contrib)

        return (m_cur, x_cur, y_cur, m_prev, x_prev, y_prev, hapdiag, acc), None

    acc0 = xf_zeros((B,))
    carry0 = (m_prev, x_prev, y_prev, m_prev2, x_prev2, y_prev2, hapdiag, acc0)
    ds = jnp.arange(2, D, dtype=jnp.int32)
    final, _ = jax.lax.scan(step, carry0, ds)
    return final[-1]


def xf_forward_args(reads: list[dict], haps: list[np.ndarray],
                    pairs: list[tuple[int, int]],
                    pad_to: tuple[int, int] | None = None) -> tuple:
    """Device arguments of pairhmm_forward_xf for (read, hap) pairs, from
    the double-context tables split exactly into xfloat.  The pair count
    is padded to a power of two (padding repeats pair 0) so compiled
    shapes recur across rescue tails of different sizes."""
    from mgl_tpu.core.context import CTX_F64, read_transition_rows

    pairs = list(pairs)
    B = max(8, 1 << (len(pairs) - 1).bit_length())
    pairs = pairs + [pairs[0]] * (B - len(pairs))
    rmax = max(len(reads[ri]["bases"]) for ri, _ in pairs)
    hmax = max(len(haps[hi]) for _, hi in pairs)
    if pad_to is not None:
        rmax, hmax = max(rmax, pad_to[0]), max(hmax, pad_to[1])
    R = rmax + 1

    trans: dict[int, tuple] = {}
    for ri in {ri for ri, _ in pairs}:
        rd = reads[ri]
        t = read_transition_rows(rd["q"], rd["i"], rd["d"], rd["c"], CTX_F64)
        distm = t[5]
        trans[ri] = t[:5] + (1.0 - distm, distm * (1.0 / 3.0))

    tracks = np.zeros((7, B, R), np.float64)
    hap_a = np.zeros((B, hmax), np.int32)
    haplen = np.zeros(B, np.int32)
    rchar = np.zeros((B, R), np.int32)
    rslen = np.zeros(B, np.int32)
    y_init = np.zeros(B, np.float64)
    for b, (ri, hi) in enumerate(pairs):
        rd, hp = reads[ri], haps[hi]
        n, h = len(rd["bases"]), len(hp)
        hap_a[b, :h] = hp
        haplen[b] = h
        rchar[b, 1: n + 1] = rd["bases"]
        rslen[b] = n
        for k in range(7):
            tracks[k, b, : n + 1] = trans[ri][k]
        y_init[b] = float(CTX_F64.initial_constant) / float(h)

    def xf(a):
        return XF(*(jnp.asarray(x) for x in xf_split(a)))

    return (jnp.asarray(hap_a), jnp.asarray(haplen), jnp.asarray(rchar),
            jnp.asarray(rslen), *(xf(tracks[k]) for k in range(7)),
            xf(y_init))


def rescue_scores_xf(reads: list[dict], haps: list[np.ndarray],
                     pairs: list[tuple[int, int]],
                     pad_to: tuple[int, int] | None = None) -> np.ndarray:
    """Extended-range scores for the rescue tail, computed on device.

    Drop-in for native.pairhmm_f64_rescue: returns (B,) float64
    INITIAL_CONSTANT(2^1020)-scaled scores; results beyond f64 range
    saturate exactly as the reference's all-f64 kernel would.
    """
    score = pairhmm_forward_xf(*xf_forward_args(reads, haps, pairs, pad_to))
    B = len(pairs)
    return xf_to_f64(np.asarray(score.hi)[:B], np.asarray(score.lo)[:B],
                     np.asarray(score.e)[:B])
