"""f32 PairHMM forward pass as a Pallas kernel for the GPU (Triton
backend).

Same recurrence, operation order, boundaries and last-row sum as
ops/pairhmm.pairhmm_forward_f32, the executable specification
(compute_prob_scalar.cc:39-43):

    M = distm * (M[r-1, c-1] * pMM + (X[r-1, c-1] + Y[r-1, c-1]) * pGapM)
    X = M[r-1, c] * pMX + X[r-1, c] * pZZ
    Y = M[r, c-1] * pMY + Y[r, c-1] * pZZ

Layout as in kernels/sw_triton.py: pairs ride the parallel axis, read rows
are swept in strips of ``strip`` staggered rows held in registers, and
only a strip's last row (M, X and X+Y per hap column) crosses to the next
strip through device memory.  The last-row sum adds the cells of row
``rslen`` in ascending column order, as the specification does.

Bases are one-hot codes (A=1, C=2, G=4, T=8, N=15, padding 0), so the
match test ``(read & hap) != 0`` also treats N as matching everything.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from mgl_tpu.utils import round_up

# one-hot base encoding; anything outside ACGTN never matches
BASE_ENC = np.zeros(256, np.int32)
for _ch, _v in ((b"Aa", 1), (b"Cc", 2), (b"Gg", 4), (b"Tt", 8), (b"Nn", 15)):
    for _c in _ch:
        BASE_ENC[_c] = _v

N_PLANES = 7    # pMM, pGapM, pMX, pMY, pZZ, distm match, distm mismatch


def _pairhmm_kernel(rc_ref, pl_ref, hap_ref, rl_ref, hl_ref, yi_ref,
                    out_ref, mrow_ref, xrow_ref, xyrow_ref, *,
                    n_strips: int, S: int, H: int):
    BP = rl_ref.shape[1]
    rl = rl_ref[0, :]
    hl = hl_ref[0, :]
    yi = yi_ref[0, :]
    zero = jnp.zeros((BP,), jnp.float32)

    # matrix row 0 (M = X = 0, Y = yInit) is the first strip's row above
    def init_col(c, carry):
        mrow_ref[c, :] = zero
        xrow_ref[c, :] = zero
        xyrow_ref[c, :] = yi
        return carry

    jax.lax.fori_loop(0, H + 1, init_col, jnp.int32(0))

    def strip(k, acc):
        r0 = k * S
        rows = [r0 + s + 1 for s in range(S)]
        rc = [rc_ref[r, :] for r in rows]
        pmm, pgapm, pmx, pmy, pzz, dmm, dmx = (
            [pl_ref[p, r, :] for r in rows] for p in range(N_PLANES))
        last = [rl == r for r in rows]

        def step(t, c):
            m_dg0, xy_dg0, M, X, Y, XY, Mp, XYp, hc, acc = c
            col = jnp.minimum(t, H)
            ma = mrow_ref[col, :]
            xa = xrow_ref[col, :]
            xya = xyrow_ref[col, :]
            hn = hap_ref[jnp.minimum(t - 1, H - 1), :]
            nM, nX, nY, nXY, nh = [], [], [], [], []
            for s in range(S):
                j = t - s
                if s == 0:
                    up_m, up_x, dg_m, dg_xy, hch = ma, xa, m_dg0, xy_dg0, hn
                else:
                    up_m, up_x = M[s - 1], X[s - 1]
                    dg_m, dg_xy, hch = Mp[s - 1], XYp[s - 1], hc[s - 1]
                distm = jnp.where((rc[s] & hch) != 0, dmm[s], dmx[s])
                m = distm * (dg_m * pmm[s] + dg_xy * pgapm[s])
                x = up_m * pmx[s] + up_x * pzz[s]
                y = M[s] * pmy[s] + Y[s] * pzz[s]
                edge = j <= 0            # column 0 (and the ramp before it)
                m = jnp.where(edge, 0.0, m)
                x = jnp.where(edge, 0.0, x)
                y = jnp.where(edge, 0.0, y)
                valid = last[s] & (j >= 1) & (j <= hl)
                acc = acc + jnp.where(valid, m + x, 0.0)
                nM.append(m)
                nX.append(x)
                nY.append(y)
                nXY.append(x + y)
                nh.append(hch)
            w = jnp.maximum(t - (S - 1), 0)
            mrow_ref[w, :] = nM[-1]
            xrow_ref[w, :] = nX[-1]
            xyrow_ref[w, :] = nXY[-1]
            return ma, xya, nM, nX, nY, nXY, M, XY, nh, acc

        # column 0 of the row above: yInit on matrix row 0, else zeros
        xy0 = jnp.where(r0 == 0, yi, zero)
        zs = [zero] * S
        c0 = (zero, xy0, zs, zs, zs, zs, zs, zs,
              [jnp.zeros((BP,), jnp.int32)] * S, acc)
        return jax.lax.fori_loop(1, H + S, step, c0)[-1]

    out_ref[0, :] = jax.lax.fori_loop(0, n_strips, strip, zero)


@functools.partial(jax.jit, static_argnames=("strip", "block", "num_warps",
                                             "interpret"))
def pairhmm_scores(rchar, planes, hap, rslen, haplen, y_init, *,
                   strip: int = 16, block: int = 32, num_warps: int = 1,
                   interpret: bool = False):
    """(B,) f32 INITIAL_CONSTANT-scaled forward scores.

    rchar (R, B) int32 one-hot codes with rchar[r] = read base r-1 (row 0
    unused); planes (7, R, B) f32 in N_PLANES order, rows past each read's
    length zero; hap (Hm, B) int32 one-hot codes; rslen, haplen (B,)
    int32; y_init (B,) f32.
    """
    R, B = rchar.shape
    Hm = hap.shape[0]
    Bp = round_up(B, block)
    n_strips = -(-(R - 1) // strip)
    Rp = 1 + n_strips * strip
    rc = jnp.pad(rchar.astype(jnp.int32), ((0, Rp - R), (0, Bp - B)))
    pln = jnp.pad(planes.astype(jnp.float32),
                  ((0, 0), (0, Rp - R), (0, Bp - B)))
    hp = jnp.pad(hap.astype(jnp.int32), ((0, 0), (0, Bp - B)))
    row = lambda a, v: jnp.pad(a, (0, Bp - B), constant_values=v)[None, :]
    rl = row(rslen.astype(jnp.int32), 1)
    hl = row(haplen.astype(jnp.int32), 1)
    yi = row(y_init.astype(jnp.float32), 0.0)
    kernel = functools.partial(_pairhmm_kernel, n_strips=n_strips, S=strip,
                               H=Hm)
    lane = lambda i: (0, i)
    out, _, _, _ = pl.pallas_call(
        kernel,
        grid=(Bp // block,),
        in_specs=[pl.BlockSpec((Rp, block), lane),
                  pl.BlockSpec((N_PLANES, Rp, block), lambda i: (0, 0, i)),
                  pl.BlockSpec((Hm, block), lane),
                  pl.BlockSpec((1, block), lane),
                  pl.BlockSpec((1, block), lane),
                  pl.BlockSpec((1, block), lane)],
        out_specs=[pl.BlockSpec((1, block), lane)]
        + [pl.BlockSpec((Hm + 1, block), lane)] * 3,
        out_shape=[jax.ShapeDtypeStruct((1, Bp), jnp.float32)]
        + [jax.ShapeDtypeStruct((Hm + 1, Bp), jnp.float32)] * 3,
        compiler_params=pl_triton.CompilerParams(num_warps=num_warps,
                                                 num_stages=1),
        backend="triton",
        interpret=interpret,
        name="pairhmm_f32_strips",
    )(rc, pln, hp, rl, hl, yi)
    return out[0, :B]
