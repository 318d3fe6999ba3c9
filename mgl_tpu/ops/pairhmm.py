"""Batched PairHMM forward pass (JAX) with precision cascade.

Batched redesign of the reference PairHMM kernels
(``compute_prob_scalar.cc`` recurrence; ``compute_prob_avxf.cc``
production float kernel; ``com_microsoft_mgl_pairhmm_MicrosoftPairHmm.cc:131-215``
tier driver).

Design:

* **Inter-pair vectorization**: each (read, haplotype) pair occupies one
  lane of the wavefront state; the reference instead packs 8 rows of ONE
  pair into AVX lanes.
* **Anti-diagonal sweep** with two carried diagonals, recurrence pinned to
  the reference's op shape (compute_prob_scalar.cc:39-43):
      M = distm * (M_d2 * pMM + (X_d2 + Y_d2) * pGapM)
      X = M_d1[r-1] * pMX + X_d1[r-1] * pZZ
      Y = M_d1[r]   * pMY + Y_d1[r]   * pZZ
  ``pairhmm_forward_f32`` is the executable specification; on a GPU the
  engine runs the same recurrence in kernels/pairhmm_triton.py.
* **Product expansion on device**: the engine ships each read's quality
  tracks and each haplotype once; transition/emission planes are built
  from the canonical tables (core/context.py) and gathered per pair on
  device (``_read_planes_device``).
* **Precision cascade**: f32 on device; pairs whose scaled score falls
  below MIN_ACCEPTED (1e-28) are recomputed on device in extended-range
  double-float arithmetic (ops/xfloat.py, the reference's f64 rescue
  tier, pairhmm_common.h:31); a host C++ f64 kernel remains as an opt-in
  fallback (MGL_TPU_RESCUE=native).

Scaling follows Context<float>: yInitial = 2^120 / haplen, final
likelihood = log10(score) - log10(2^120).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from mgl_tpu.core.context import (
    CTX_F32,
    CTX_F64,
    MIN_ACCEPTED,
    read_transition_rows,
)

AMBIG = ord("N")

# One alphabet for every tier (GPU kernel one-hot, XLA spec, rescue):
# uppercase ACGT; IUPAC codes / lowercase / junk -> N.  Applied at
# compute_likelihoods so direct callers and the api layer see identical
# scores (the reference only ever receives ACGTN from GATK).
BASE_NORM = np.full(256, AMBIG, np.uint8)
for _c in b"ACGT":
    BASE_NORM[_c] = _c
    BASE_NORM[_c + 32] = _c


class PairHMMBatch(NamedTuple):
    """Device-ready padded batch of (read, hap) pairs.

    All arrays have leading dim B (pairs).  R = padded read rows + 1,
    H = padded hap length.
    """

    hap: np.ndarray        # (B, H) int32 ASCII
    haplen: np.ndarray     # (B,) int32
    rchar: np.ndarray      # (B, R) int32 ASCII, rchar[:, r] = read base r-1
    rslen: np.ndarray      # (B,) int32
    p_mm: np.ndarray       # (B, R) f32
    p_gapm: np.ndarray
    p_mx: np.ndarray
    p_my: np.ndarray
    p_zz: np.ndarray
    distm_match: np.ndarray  # (B, R) f32: 1 - ph2pr[q]
    distm_mis: np.ndarray    # (B, R) f32: ph2pr[q] / 3
    y_init: np.ndarray       # (B,) f32: 2^120 / haplen


def compute_haplotype_similarities(
    haps: list[np.ndarray],
) -> tuple[np.ndarray, int, int]:
    """Shared-prefix structure of consecutive haplotypes.

    Re-derivation of the reference's computeHaplotypeSimilarities
    (pairhmm_common.cc:3-63): position[j] is the even-rounded length of the
    prefix hap[j] shares with hap[j-1], reset to 0 when the predecessor is
    shorter than 8 bases or shares less than its own recorded prefix; also
    returns (cols_min, cols_max) over haplotype lengths.

    The reference uses position[] to resume each haplotype's DP from a
    cached column state (compute_prob_avxf.cc:943-967).  Here the engine
    uses only its degenerate case, exact-duplicate haplotype
    deduplication in dispatch_likelihoods; a prefix-sharing pass that
    resumes from shared columns is future work (ROADMAP reach item 2).
    """
    n = len(haps)
    positions = np.zeros(n, dtype=np.int64)
    if n == 0:
        return positions, 0, 0
    cols_min = cols_max = len(haps[0])
    for j in range(1, n):
        prev, cur = np.asarray(haps[j - 1]), np.asarray(haps[j])
        pos = 0
        if len(prev) >= 8:
            common = min(len(prev), len(cur))
            neq = np.nonzero(prev[:common] != cur[:common])[0]
            pos = int(neq[0]) if neq.size else common
            pos -= pos % 2
            if pos < positions[j - 1]:
                pos = 0
        positions[j] = pos
        cols_min = min(cols_min, len(cur))
        cols_max = max(cols_max, len(cur))
    return positions, cols_min, cols_max


def pack_pairs(
    reads: list[dict],
    haps: list[np.ndarray],
    pair_index: list[tuple[int, int]] | None = None,
    pad_to: tuple[int, int] | None = None,
) -> PairHMMBatch:
    """Pack (read, hap) pairs into padded arrays.

    ``reads``: dicts with uint8 arrays bases/q/i/d/c (the packed-buffer
    layout of MicrosoftPairHmm.java:90-97, one dict per read).
    ``pair_index``: list of (read_idx, hap_idx); defaults to the full
    reads x haps product in row-major order (JNI driver semantics).
    ``pad_to``: (read_pad, hap_pad) bucket dims for compiled-shape reuse;
    defaults to the batch maxima.  Padding is inert (zero transition rows,
    column-gated accumulation), so scores are pad-invariant.
    """
    if pair_index is None:
        pair_index = [(ri, hi) for ri in range(len(reads)) for hi in range(len(haps))]
    B = len(pair_index)
    rmax = max(len(reads[ri]["bases"]) for ri, _ in pair_index)
    hmax = max(len(haps[hi]) for _, hi in pair_index)
    if pad_to is not None:
        if pad_to[0] < rmax or pad_to[1] < hmax:
            raise ValueError(f"pad_to {pad_to} < batch maxima ({rmax}, {hmax})")
        rmax, hmax = pad_to
    R = rmax + 1

    # Per-UNIQUE-read/hap staging + per-pair fancy-index gather: the loops
    # below run over distinct reads/haps only (a full product touches each
    # once), and the B-sized expansion is vectorized numpy — the per-pair
    # Python loop this replaces dominated engine host time at GATK region
    # shapes (B = n_r * n_h pairs from n_r + n_h sequences).
    ur = sorted({ri for ri, _ in pair_index})
    uh = sorted({hi for _, hi in pair_index})
    rmap = {ri: k for k, ri in enumerate(ur)}
    hmap = {hi: k for k, hi in enumerate(uh)}

    hap_stack = np.zeros((len(uh), hmax), np.int32)
    haplen_u = np.zeros(len(uh), np.int32)
    for k, hi in enumerate(uh):
        hp = haps[hi]
        hap_stack[k, : len(hp)] = hp
        haplen_u[k] = len(hp)

    # 7 transition/emission planes + rchar, one row per unique read; the
    # quality tracks are stacked once and read_transition_rows runs ONE
    # batched table-lookup pass (it accepts any leading batch shape) —
    # per-element values are identical to per-read calls, and columns
    # past each read's length are masked back to the zero padding the
    # kernels' pad-invariance requires
    nq = len(ur)
    qs = np.zeros((4, nq, rmax), np.uint8)
    rchar_u = np.zeros((nq, R), np.int32)
    rslen_u = np.zeros(nq, np.int32)
    for k, ri in enumerate(ur):
        rd = reads[ri]
        n = len(rd["bases"])
        qs[0, k, :n] = rd["q"]
        qs[1, k, :n] = rd["i"]
        qs[2, k, :n] = rd["d"]
        qs[3, k, :n] = rd["c"]
        rchar_u[k, 1: n + 1] = rd["bases"]
        rslen_u[k] = n
    t = read_transition_rows(qs[0], qs[1], qs[2], qs[3], CTX_F32)
    one = np.float32(1.0)
    third = np.float32(1.0) / np.float32(3.0)
    plane_u = np.empty((nq, 7, R), np.float32)
    for j in range(5):
        plane_u[:, j] = t[j]
    distm = t[5]
    plane_u[:, 5] = one - distm
    plane_u[:, 6] = distm * third
    plane_u *= (np.arange(R) <= rslen_u[:, None])[:, None, :]

    ridx = np.fromiter((rmap[ri] for ri, _ in pair_index), np.int64, B)
    hidx = np.fromiter((hmap[hi] for _, hi in pair_index), np.int64, B)
    planes = plane_u[ridx]                      # (B, 7, R)
    return PairHMMBatch(
        hap=hap_stack[hidx],
        haplen=haplen_u[hidx],
        rchar=rchar_u[ridx],
        rslen=rslen_u[ridx],
        p_mm=planes[:, 0],
        p_gapm=planes[:, 1],
        p_mx=planes[:, 2],
        p_my=planes[:, 3],
        p_zz=planes[:, 4],
        distm_match=planes[:, 5],
        distm_mis=planes[:, 6],
        y_init=(np.float32(CTX_F32.initial_constant)
                / haplen_u[hidx].astype(np.float32)),
    )


from mgl_tpu.utils import shift_down as _shift_down  # shared



@jax.jit
def pairhmm_forward_f32(
    hap: jax.Array, haplen: jax.Array,
    rchar: jax.Array, rslen: jax.Array,
    p_mm: jax.Array, p_gapm: jax.Array, p_mx: jax.Array,
    p_my: jax.Array, p_zz: jax.Array,
    distm_match: jax.Array, distm_mis: jax.Array,
    y_init: jax.Array,
) -> jax.Array:
    """Batched forward probability, f32, INITIAL_CONSTANT-scaled.

    Returns (B,) scores = sum over the last read row of (M + X) across all
    hap columns (compute_prob_scalar.cc:211,313).
    """
    B, R = rchar.shape
    H = hap.shape[1]
    D = R + H            # diagonals 0 .. R-1+H

    r_iota = jax.lax.broadcasted_iota(jnp.int32, (B, R), 1)
    hpad = jnp.pad(hap, ((0, 0), (0, R + 1)))
    y_init_col = y_init[:, None]
    rl = rslen.astype(jnp.int32)[:, None]
    hl = haplen.astype(jnp.int32)[:, None]

    zero = jnp.zeros((B, R), jnp.float32)
    # diag 0: element 0 = cell (0,0): M=X=0, Y=yInit
    m_prev2, x_prev2 = zero, zero
    y_prev2 = zero.at[:, 0].set(y_init)
    # diag 1: element 0 = (0,1): Y=yInit; element 1 = (1,0): zeros
    m_prev, x_prev = zero, zero
    y_prev = zero.at[:, 0].set(y_init)
    hapdiag = jnp.zeros((B, R), jnp.int32).at[:, 0].set(hpad[:, 0])

    def step(carry, d):
        m_prev, x_prev, y_prev, m_prev2, x_prev2, y_prev2, hapdiag, acc = carry

        hch = jax.lax.dynamic_slice_in_dim(hpad, d - 1, 1, axis=1)
        hapdiag = _shift_down(hapdiag, 0).at[:, 0].set(hch[:, 0])

        is_match = (rchar == hapdiag) | (rchar == AMBIG) | (hapdiag == AMBIG)
        distm = jnp.where(is_match, distm_match, distm_mis)

        m_d2 = _shift_down(m_prev2, 0.0)
        x_d2 = _shift_down(x_prev2, 0.0)
        y_d2 = _shift_down(y_prev2, 0.0)
        m_cur = distm * (m_d2 * p_mm + (x_d2 + y_d2) * p_gapm)

        y_cur = m_prev * p_my + y_prev * p_zz

        m_d1 = _shift_down(m_prev, 0.0)
        x_d1 = _shift_down(x_prev, 0.0)
        x_cur = m_d1 * p_mx + x_d1 * p_zz

        # boundaries: element 0 = row 0 (M=X=0, Y=yInit); element d = col 0 (zeros)
        row0 = r_iota == 0
        col0 = r_iota == d
        m_cur = jnp.where(row0 | col0, 0.0, m_cur)
        x_cur = jnp.where(row0 | col0, 0.0, x_cur)
        y_cur = jnp.where(col0, 0.0, jnp.where(row0, y_init_col, y_cur))

        # last-row contribution: cell (rslen, c=d-rslen), valid 1 <= c <= haplen
        mv = jnp.take_along_axis(m_cur, rl, axis=1)[:, 0]
        xv = jnp.take_along_axis(x_cur, rl, axis=1)[:, 0]
        c = d - rl[:, 0]
        valid = (c >= 1) & (c <= hl[:, 0])
        acc = acc + jnp.where(valid, mv + xv, 0.0)

        return (m_cur, x_cur, y_cur, m_prev, x_prev, y_prev, hapdiag, acc), None

    acc0 = jnp.zeros((B,), jnp.float32)
    carry0 = (m_prev, x_prev, y_prev, m_prev2, x_prev2, y_prev2, hapdiag, acc0)
    ds = jnp.arange(2, D, dtype=jnp.int32)
    final, _ = jax.lax.scan(step, carry0, ds)
    return final[-1]


def forward_scores_xla(batch: PairHMMBatch) -> np.ndarray:
    """f32 scores of a host-packed batch via the lax.scan specification."""
    return np.asarray(
        pairhmm_forward_f32(
            jnp.asarray(batch.hap), jnp.asarray(batch.haplen),
            jnp.asarray(batch.rchar), jnp.asarray(batch.rslen),
            jnp.asarray(batch.p_mm), jnp.asarray(batch.p_gapm),
            jnp.asarray(batch.p_mx), jnp.asarray(batch.p_my),
            jnp.asarray(batch.p_zz),
            jnp.asarray(batch.distm_match), jnp.asarray(batch.distm_mis),
            jnp.asarray(batch.y_init),
        )
    )


_DEV_TABLES: dict = {}


def _ctx_tables_f32():
    """Device-resident CTX_F32 tables (ph2pr, match_to_match)."""
    if "f32" not in _DEV_TABLES:
        _DEV_TABLES["f32"] = (
            jnp.asarray(np.asarray(CTX_F32.ph2pr, np.float32)),
            jnp.asarray(np.asarray(CTX_F32.match_to_match, np.float32)),
        )
    return _DEV_TABLES["f32"]


def _read_planes_device(q, i, d, c, rslen, ph2pr, m2m):
    """(7, n, rmax+1) f32 transition/emission planes in pack_pairs order
    (pMM, pGapM, pMX, pMY, pZZ, 1-distm, distm/3), built on device from
    the raw (n, rmax) uint8 quality tracks.  Same table values and
    operation order as pack_pairs / read_transition_rows, so the planes
    are bit-identical; the host ships 5 bytes per read base instead of
    28 per pair row.  Rows past each read's length are zero."""
    qi, ii, di, ci = ((a & np.uint8(127)).astype(jnp.int32)
                      for a in (q, i, d, c))
    mn = jnp.minimum(ii, di)
    mx = jnp.maximum(ii, di)
    distm = ph2pr[qi]
    planes = jnp.stack([
        m2m[((mx * (mx + 1)) >> 1) + mn],
        jnp.float32(1.0) - ph2pr[ci],
        ph2pr[ii],
        ph2pr[di],
        ph2pr[ci],
        jnp.float32(1.0) - distm,
        distm * (np.float32(1.0) / np.float32(3.0)),
    ])
    planes = jnp.pad(planes, ((0, 0), (0, 0), (1, 0)))
    row = jnp.arange(q.shape[1] + 1, dtype=jnp.int32)[None, None, :]
    return jnp.where(row <= rslen[None, :, None], planes, 0.0)


@functools.partial(jax.jit, static_argnames=("impl", "interpret"))
def product_forward(q, i, d, c, bases, rslen, hap, haplen, y_init,
                     ridx, hidx, ph2pr, m2m, *, impl: str,
                     interpret: bool = False):
    """f32 scores of pairs (ridx[b], hidx[b]) with the product expanded on
    device: per-read tracks (n_r, rmax) uint8 and per-hap bases (n_h, H)
    uint8 ship once, per-pair planes are gathered here, then the Triton
    kernel (impl='pallas') or the lax.scan specification runs."""
    planes = _read_planes_device(q, i, d, c, rslen, ph2pr, m2m)
    rchar = jnp.pad(bases, ((0, 0), (1, 0)))          # rchar[:, r] = base r-1
    if impl == "pallas":
        from mgl_tpu.kernels.pairhmm_triton import BASE_ENC, pairhmm_scores

        enc = jnp.asarray(BASE_ENC)
        return pairhmm_scores(
            enc[rchar].T[:, ridx], planes.transpose(0, 2, 1)[:, :, ridx],
            enc[hap].T[:, hidx], rslen[ridx], haplen[hidx], y_init[hidx],
            interpret=interpret)
    p = planes[:, ridx]
    return pairhmm_forward_f32(
        hap[hidx].astype(jnp.int32), haplen[hidx],
        rchar[ridx].astype(jnp.int32), rslen[ridx],
        p[0], p[1], p[2], p[3], p[4], p[5], p[6], y_init[hidx])


def _pow2_at_least(n: int, floor: int) -> int:
    return max(floor, 1 << max(n - 1, 0).bit_length())


def product_forward_args(reads: list[dict], haps: list[np.ndarray],
                         pair_index: list[tuple[int, int]],
                         pad_to: tuple[int, int] | None = None) -> tuple:
    """Device arguments of ``product_forward`` for (read, hap) pairs.
    Read, hap and pair counts are padded to powers of two and lengths to
    ``pad_to`` so compiled shapes recur across calls; padding lanes repeat
    pair 0."""
    ur = sorted({ri for ri, _ in pair_index})
    uh = sorted({hi for _, hi in pair_index})
    rmap = {r: k for k, r in enumerate(ur)}
    hmap = {h: k for k, h in enumerate(uh)}
    rmax = max(len(reads[r]["bases"]) for r in ur)
    hmax = max(len(haps[h]) for h in uh)
    if pad_to is not None:
        rmax, hmax = max(rmax, pad_to[0]), max(hmax, pad_to[1])
    nr = _pow2_at_least(len(ur), 8)
    nh = _pow2_at_least(len(uh), 8)
    tracks = np.zeros((5, nr, rmax), np.uint8)
    rslen = np.zeros(nr, np.int32)
    for k, r in enumerate(ur):
        rd = reads[r]
        n = len(rd["bases"])
        for t, key in enumerate(("q", "i", "d", "c", "bases")):
            tracks[t, k, :n] = rd[key]
        rslen[k] = n
    hapm = np.zeros((nh, hmax), np.uint8)
    haplen = np.ones(nh, np.int32)
    for k, h in enumerate(uh):
        hapm[k, : len(haps[h])] = haps[h]
        haplen[k] = len(haps[h])
    y_init = np.float32(CTX_F32.initial_constant) / haplen.astype(np.float32)
    B = len(pair_index)
    Bp = _pow2_at_least(B, 256)
    ridx = np.zeros(Bp, np.int32)
    hidx = np.zeros(Bp, np.int32)
    ridx[:B] = [rmap[r] for r, _ in pair_index]
    hidx[:B] = [hmap[h] for _, h in pair_index]
    ph2pr, m2m = _ctx_tables_f32()
    return (*(jnp.asarray(t) for t in tracks), jnp.asarray(rslen),
            jnp.asarray(hapm), jnp.asarray(haplen), jnp.asarray(y_init),
            jnp.asarray(ridx), jnp.asarray(hidx), ph2pr, m2m)


def forward_scores_pairs(reads: list[dict], haps: list[np.ndarray],
                         pair_index: list[tuple[int, int]],
                         pad_to: tuple[int, int] | None = None,
                         impl: str = "auto", interpret: bool = False):
    """(B,) f32 scaled scores of arbitrary (read, hap) pairs as a device
    array (dispatch only; the caller fetches)."""
    from mgl_tpu.core.backend import resolve_impl

    scores = product_forward(
        *product_forward_args(reads, haps, pair_index, pad_to),
        impl=resolve_impl(impl), interpret=interpret)
    return scores[:len(pair_index)]


def rescue_tier_scores(reads: list[dict], haps: list[np.ndarray],
                       pairs: list[tuple[int, int]]) -> np.ndarray:
    """Extended-range (f64-class) scores for the rescue tail.

    Default: the device xfloat scan (ops/xfloat.py), the equivalent of the
    reference's compute_prob_avxd.cc rescue tier.  MGL_TPU_RESCUE selects
    a fallback: 'native' = host C++ threaded f64 kernel, 'scalar' = NumPy
    oracle.  Returns (B,) float64 scaled scores.
    """
    import os

    from mgl_tpu.ref_impl.pairhmm_scalar import compute_score

    mode = os.environ.get("MGL_TPU_RESCUE", "xf")
    if mode == "native":
        from mgl_tpu.native import pairhmm_f64_rescue

        native = pairhmm_f64_rescue(reads, haps, pairs)
        if native is not None:
            return np.asarray(native, np.float64)
        mode = "scalar"  # pragma: no cover - lib unavailable
    if mode == "scalar":
        out = np.zeros(len(pairs), np.float64)
        for k, (ri, hi) in enumerate(pairs):
            rd = reads[ri]
            out[k] = compute_score(haps[hi], rd["bases"], rd["q"], rd["i"],
                                   rd["d"], rd["c"], ctx=CTX_F64)
        return out

    from mgl_tpu.batch.bucketing import bucket_pairs
    from mgl_tpu.ops.xfloat import rescue_scores_xf

    out = np.zeros(len(pairs), np.float64)
    la = [len(reads[ri]["bases"]) for ri, _ in pairs]
    lb = [len(haps[hi]) for _, hi in pairs]
    for (pa, pb), idxs in bucket_pairs(la, lb):
        out[np.asarray(idxs)] = rescue_scores_xf(
            reads, haps, [pairs[k] for k in idxs], pad_to=(pa, pb))
    return out


def compute_likelihoods(
    reads: list[dict],
    haps: list[np.ndarray],
    use_double: bool = False,
    use_fast_path: bool = False,
    impl: str = "auto",
) -> np.ndarray:
    """Full cascade: optional seed-extend tier-0, device f32 pass, f64
    rescue below 1e-28.

    Returns (num_reads, num_haps) float64 log10 likelihoods, matching
    MicrosoftPairHmm.computeLikelihoods output layout.  ``use_fast_path``
    activates the seed-extend prefilter the reference ships dormant
    (com_microsoft_mgl_pairhmm_MicrosoftPairHmm.cc:140-143): well-matching
    pairs take the fast estimator's score and skip the DP.
    """
    return dispatch_likelihoods(reads, haps, use_double, use_fast_path,
                                impl)()()


def _finish_scores_start(scores: np.ndarray, reads: list[dict],
                         haps: list[np.ndarray], n_r: int, n_h: int):
    """log10 conversion + underflow rescue over full-product f32 scores
    (flat layout b = ri * n_h + hi).  Returns a closure that yields the
    finished matrix."""
    lic32 = float(CTX_F32.log10_initial_constant)
    lic64 = float(CTX_F64.log10_initial_constant)

    rescue = np.nonzero(scores < float(MIN_ACCEPTED))[0]
    with np.errstate(divide="ignore", invalid="ignore"):
        out = (np.log10(scores) - lic32).reshape(n_r, n_h)
    if not len(rescue):
        return lambda: out
    from mgl_tpu.utils.metrics import METRICS

    with METRICS.timer("engine.rescue"):
        vals = rescue_tier_scores(
            reads, haps, [(int(b) // n_h, int(b) % n_h) for b in rescue])
    out.reshape(-1)[rescue] = np.log10(vals) - lic64
    return lambda: out


def dispatch_likelihoods(reads: list[dict], haps: list[np.ndarray],
                         use_double: bool = False,
                         use_fast_path: bool = False,
                         impl: str = "auto"):
    """Async form of compute_likelihoods for pipelined batch streams.

    Dispatches the f32 device pass and returns a ``finalize`` closure;
    calling it fetches the scores and runs the rescue tail, returning the
    closure that yields the (R, H) matrix.  While the device works on
    this batch, the caller packs and dispatches the next one (JAX
    dispatch is asynchronous).  Results are identical to
    compute_likelihoods in every case.
    """
    reads = [{**rd, "bases": BASE_NORM[np.asarray(rd["bases"], np.uint8)]}
             for rd in reads]
    haps = [BASE_NORM[np.asarray(h, np.uint8)] for h in haps]
    n_r, n_h = len(reads), len(haps)

    # exact-duplicate haplotype dedup (the payoff of the reference's
    # haplotype-similarity pass, see compute_haplotype_similarities):
    # identical haplotypes score identically against every read, so
    # compute each distinct one once
    canon: dict[bytes, int] = {}
    col_of = np.empty(n_h, dtype=np.int64)
    uniq_idx: list[int] = []
    for hi, hp in enumerate(haps):
        key = hp.tobytes()
        if key not in canon:
            canon[key] = len(uniq_idx)
            uniq_idx.append(hi)
        col_of[hi] = canon[key]
    if len(uniq_idx) < n_h:
        inner = dispatch_likelihoods(reads, [haps[h] for h in uniq_idx],
                                     use_double, use_fast_path, impl)

        def expand():
            fin = inner()
            return lambda: fin()[:, col_of]

        return expand

    pair_index = [(ri, hi) for ri in range(n_r) for hi in range(n_h)]
    scores = np.full(len(pair_index), -1.0, dtype=np.float64)
    dp_pairs = list(range(len(pair_index)))
    if use_fast_path and not use_double:
        from mgl_tpu.ops.seed_extend import fast_scores

        fs = fast_scores(reads, haps, pair_index)
        hit = fs >= float(MIN_ACCEPTED)
        scores[hit] = fs[hit]
        dp_pairs = [b for b in dp_pairs if not hit[b]]

    pending = []
    if not use_double and dp_pairs:
        from mgl_tpu.batch.bucketing import bucket_pairs
        from mgl_tpu.utils.logging import get_logger

        # length-bucket by (read, hap) pad shape so mixed-length products
        # don't all pay the global maxima (and compiled shapes recur)
        la = [len(reads[pair_index[b][0]]["bases"]) for b in dp_pairs]
        lb = [len(haps[pair_index[b][1]]) for b in dp_pairs]
        for (pa, pb), idxs in bucket_pairs(la, lb):
            sel = np.asarray([dp_pairs[k] for k in idxs], np.int64)
            get_logger("engine").debug("pairhmm bucket (%d, %d) x%d", pa,
                                       pb, len(sel))
            pending.append((forward_scores_pairs(
                reads, haps, [pair_index[b] for b in sel], pad_to=(pa, pb),
                impl=impl), sel))

    def finalize():
        from mgl_tpu.utils.metrics import METRICS

        with METRICS.timer("engine.f32"):
            for dev, sel in pending:
                scores[sel] = np.asarray(dev, np.float64)
        return _finish_scores_start(scores, reads, haps, n_r, n_h)

    return finalize
