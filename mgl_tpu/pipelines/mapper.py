"""Seed-and-extend read mapper (BASELINE.json config 4).

New capability beyond the reference library (which only scores/aligns
given pairs): map reads to a reference sequence.

Stages:
1. **Index** (host, NumPy): sorted k-mer table of the reference —
   the per-host replicated index of the scale-out design (SURVEY.md §5
   "distributed communication backend": reference/index replicated per
   host over DCN at startup).
2. **Seed** (host, vectorized): non-overlapping read k-mers -> candidate
   diagonals via binary search; majority vote picks a candidate position
   per read.
3. **Verify/extend** (device): SW score of each read against its
   candidate reference window (ops/sw.best_scores: the score-only GPU
   kernel on a GPU, the plain forward pass elsewhere), optional
   traceback for CIGARs.

The host stages are deliberately NumPy-vectorized (no Python per-read
loops) so a single host core can feed the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from mgl_tpu.utils import round_up

_CODE = np.full(256, 4, np.uint8)
for i, b in enumerate(b"ACGT"):
    _CODE[b] = i
    _CODE[ord(chr(b).lower())] = i


def encode(seq: np.ndarray) -> np.ndarray:
    """ASCII -> 2-bit codes (4 = ambiguous)."""
    return _CODE[np.asarray(seq, dtype=np.uint8)]


def _kmers(code: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """All k-mers of a 2-bit coded sequence; returns (values, valid).

    Log-doubling combine (span-1 -> 2 -> 4 -> ... mers) does ceil(log2 k)
    full-array passes instead of k, in uint32 for k <= 16 — the index
    build at genome scale is memory-bandwidth-bound here."""
    n = len(code) - k + 1
    dtype = np.uint32 if k <= 16 else np.uint64
    if n <= 0:
        return np.zeros(0, dtype), np.zeros(0, bool)
    need = {p for p in (1 << j for j in range(k.bit_length())) if k & p}
    w = code.astype(dtype)                 # span-1 values per start
    spans = {1: w} if 1 in need else {}
    span = 1
    while span * 2 <= k:
        nxt = w[: len(w) - span] << dtype(2 * span)
        nxt |= w[span:]            # in-place: one temp, not two
        w = nxt
        span *= 2
        if span in need:
            spans[span] = w
    # binary decomposition of k: concatenate the power-of-two pieces
    acc, done = None, 0
    for s in sorted(spans, reverse=True):
        if done + s > k:
            continue
        arr = spans[s]
        if acc is None:
            acc = arr
        else:
            m = len(arr) - done
            acc = acc[:m] << dtype(2 * s)
            acc |= arr[done: done + m]
        done += s
        if done == k:
            break
    w = acc[:n]
    isn = (code >= 4).astype(np.int32)
    cs = np.concatenate([[0], np.cumsum(isn)])
    valid = (cs[k:] - cs[:-k]) == 0
    return w, valid


_PREFIX_BASES = 13                     # 4^13 = 67M jump-table buckets
_SCAN_WIDTH = 4                        # minimum in-bucket scan width; the
                                       # effective width scales with the
                                       # table's average bucket load (4x
                                       # the mean covers the Poisson tail)
                                       # so large references don't fall
                                       # back to binary search over a
                                       # multi-GB table for most lookups


@dataclasses.dataclass
class ReferenceIndex:
    """Sorted k-mer index of one reference sequence with a 13-base prefix
    jump table: lookups are O(1) direct addressing plus a short vectorized
    in-bucket scan (binary search over tens of millions of k-mers was the
    mapper's bottleneck at chromosome scale)."""

    k: int
    ref: np.ndarray              # ASCII uint8 (contigs N-joined)
    sorted_kmers: np.ndarray     # (M,) uint64 (canonical values when
                                 # canon_fwd is not None)
    positions: np.ndarray        # (M,) uint32 (int64 past 4.29 Gbp) —
                                 # ref offset of each kmer; all consumers
                                 # widen to int64 before arithmetic
    max_hits: int = 64
    prefix_table: np.ndarray | None = None   # (4^13 + 1,) int64 bucket starts
    canon_fwd: np.ndarray | None = None      # (M,) bool: ref fwd kmer is
                                             # its own canonical form
    contig_names: list | None = None
    contig_offsets: np.ndarray | None = None  # start of each contig in ref
    contig_lengths: np.ndarray | None = None
    _ref_dev: object = None
    _ref_blocked: bool = False
    _win_fns: dict | None = None

    @staticmethod
    def build_multi(contigs: list[tuple[str, np.ndarray]], k: int = 16,
                    max_hits: int = 64) -> "ReferenceIndex":
        """Index several contigs as one coordinate space.  Contigs are
        joined with max(k, 48) ambiguous bases: k so no k-mer spans a
        boundary (the N-validity mask in _kmers drops them), 48 = 2x the
        default window_pad so an SW verify window at a contig end never
        reaches real bases of the next contig."""
        sep = np.full(max(k, 48), ord("N"), np.uint8)
        parts, names, offs, lens = [], [], [], []
        at = 0
        for name, seq in contigs:
            s = (np.frombuffer(bytes(seq), np.uint8)
                 if not isinstance(seq, np.ndarray) else seq.astype(np.uint8))
            names.append(name)
            offs.append(at)
            lens.append(len(s))
            parts.append(s)
            parts.append(sep)
            at += len(s) + len(sep)
        idx = ReferenceIndex.build(np.concatenate(parts), k=k,
                                   max_hits=max_hits)
        idx.contig_names = names
        idx.contig_offsets = np.asarray(offs, np.int64)
        idx.contig_lengths = np.asarray(lens, np.int64)
        return idx

    def locate(self, pos: np.ndarray):
        """Global positions -> (contig_id, local_pos); single-contig
        indexes report contig 0.  Unmapped (pos < 0) stays (-1, -1)."""
        pos = np.asarray(pos, np.int64)
        if self.contig_offsets is None:
            cid = np.where(pos >= 0, 0, -1)
            return cid, np.where(pos >= 0, pos, -1)
        cid = np.searchsorted(self.contig_offsets, pos, "right") - 1
        local = pos - self.contig_offsets[np.clip(cid, 0, None)]
        bad = pos < 0
        return np.where(bad, -1, cid), np.where(bad, -1, local)

    @staticmethod
    def build(ref_seq, k: int = 16, max_hits: int = 64) -> "ReferenceIndex":
        ref = np.frombuffer(bytes(ref_seq), np.uint8) if not isinstance(
            ref_seq, np.ndarray) else ref_seq.astype(np.uint8)
        code = encode(ref)
        # native fast path (k <= 16, offsets fit uint32 — covers the
        # human genome): one C pass emits canonical (value, position,
        # fwd-bit) rows, a fused stable radix sort orders them — no
        # log-doubling temporaries, no argsort, no gather passes.
        # Bit-identical to the numpy path below (regression-tested).
        rows = None
        if k <= 16 and len(ref) < 2**32:
            from mgl_tpu.native import kmer_index_rows

            rows = kmer_index_rows(code, k)
        if rows is not None:
            vals, pos, fwd = rows
        else:
            vals, valid = _kmers(code, k)
            # uint32 offsets reach 4.29 Gbp (human genome: 3.1 Gbp) at
            # half the table memory of int64; consumers widen on load
            pos_dtype = np.uint32 if len(ref) < 2**32 else np.int64
            pos = np.nonzero(valid)[0].astype(pos_dtype)
            vals = vals[valid]
            fwd = None
            if k <= 16:
                # canonical k-mers: index min(kmer, rc(kmer)) plus a bit
                # for which form was the forward one — a single table
                # lookup then serves BOTH strands of a read (the lookup
                # gathers are the seeding bottleneck; this halves them)
                rcv = _rc_kmers(vals, k)
                fwd = vals <= rcv
                vals = np.minimum(vals, rcv)
            order = np.argsort(vals, kind="stable")
            vals = vals[order]
            pos = pos[order]
            if fwd is not None:
                fwd = fwd[order]
        if k <= 16:
            # 2k bits fit in 32: halves table memory and, more important,
            # the per-lookup gather bandwidth (the seeding bottleneck)
            vals = vals.astype(np.uint32, copy=False)
        ptable = None
        # the 4^13-entry jump table costs ~270 MB; only worth it once the
        # k-mer set is big enough that binary search is the bottleneck
        if k >= _PREFIX_BASES and len(vals) >= 1_000_000:
            shift = 2 * (k - _PREFIX_BASES)
            if vals.dtype == np.uint32:
                # single cache-friendly pass over the sorted keys
                from mgl_tpu.native import kmer_prefix_table

                ptable = kmer_prefix_table(vals, shift, 4 ** _PREFIX_BASES)
            if ptable is None:
                counts = np.bincount((vals >> vals.dtype.type(shift))
                                     .astype(np.int64),
                                     minlength=4 ** _PREFIX_BASES)
                ptable = np.zeros(4 ** _PREFIX_BASES + 1, np.int64)
                np.cumsum(counts, out=ptable[1:])
                ptable = ptable.astype(np.uint32 if len(vals) < 2**32
                                       else np.int64)
        return ReferenceIndex(k=k, ref=ref, sorted_kmers=vals,
                              positions=pos,
                              max_hits=max_hits, prefix_table=ptable,
                              canon_fwd=fwd)

    def lookup(self, kmer_vals: np.ndarray):
        """Hit index ranges [lo, hi) for a flat array of k-mer values."""
        kmer_vals = kmer_vals.astype(self.sorted_kmers.dtype, copy=False)
        if self.prefix_table is None:
            lo = np.searchsorted(self.sorted_kmers, kmer_vals, "left")
            hi = np.searchsorted(self.sorted_kmers, kmer_vals, "right")
            return lo, hi
        shift = kmer_vals.dtype.type(2 * (self.k - _PREFIX_BASES))
        pfx = (kmer_vals >> shift).astype(np.int64)
        plo = self.prefix_table[pfx].astype(np.int64)
        phi = self.prefix_table[pfx + 1].astype(np.int64)
        M = len(self.sorted_kmers)
        # in-bucket scan width: 4x the table's mean bucket load (capped)
        # so the binary-search fallback stays rare at genome scale
        W = int(np.clip(4 * M // 4 ** _PREFIX_BASES, _SCAN_WIDTH, 64))
        wide = (phi - plo) > W
        idx = plo[:, None] + np.arange(W, dtype=np.int64)[None, :]
        in_rng = idx < phi[:, None]
        vals = self.sorted_kmers[np.minimum(idx, M - 1)]
        lt = ((vals < kmer_vals[:, None]) & in_rng).sum(1)
        eq = ((vals == kmer_vals[:, None]) & in_rng).sum(1)
        lo = plo + lt
        hi = lo + eq
        if wide.any():   # repetitive prefixes: exact search on the few
            lo[wide] = np.searchsorted(self.sorted_kmers, kmer_vals[wide],
                                       "left")
            hi[wide] = np.searchsorted(self.sorted_kmers, kmer_vals[wide],
                                       "right")
        return lo, hi


_RC = np.zeros(256, np.uint8)
for _a, _b in zip(b"ACGTacgtNn", b"TGCATGCANN"):
    _RC[_a] = _b


def revcomp(seq: np.ndarray) -> np.ndarray:
    """Reverse complement of ASCII bases (vectorized; rows if 2-D)."""
    a = np.asarray(seq, np.uint8)
    return _RC[a[..., ::-1]]


def _seed_kmers(reads: np.ndarray, k: int, stride: int):
    """Forward-seed k-mer values/validity: (vals (N,S) u64, valid (N,S),
    offsets (S,))."""
    N, read_len = reads.shape
    offsets = np.arange(0, read_len - k + 1, stride, dtype=np.int32)
    code = encode(reads.reshape(-1)).reshape(N, read_len)
    vals = np.zeros((N, len(offsets)), np.uint64)
    valid = np.ones((N, len(offsets)), bool)
    for i in range(k):
        col = code[:, offsets + i]
        vals = (vals << np.uint64(2)) | col.astype(np.uint64)
        valid &= col < 4
    return vals, valid, offsets


def _rc_kmers(vals: np.ndarray, k: int) -> np.ndarray:
    """Reverse-complement k-mer values (k <= 16) by 2-bit-group reversal
    of the complement — the rc seeds of a read are a pure bit transform
    of its forward seeds, no second encode/shift pass needed."""
    v = (~vals.astype(np.uint64)).astype(np.uint32)
    v = ((v >> 2) & np.uint32(0x33333333)) | ((v & np.uint32(0x33333333)) << 2)
    v = ((v >> 4) & np.uint32(0x0F0F0F0F)) | ((v & np.uint32(0x0F0F0F0F)) << 4)
    v = v.byteswap()
    # stay in uint32: the index build sorts/permutes these values at
    # genome scale, and a uint64 upcast here (via np.minimum with the
    # forward values) doubles the radix-sort and gather traffic — ~35%
    # of the whole build time at 64 Mbp
    return v >> np.uint32(32 - 2 * k)


def _vote_diagonals(index: ReferenceIndex, read_len: int,
                    vals: np.ndarray, valid: np.ndarray,
                    seed_off: np.ndarray,
                    rc_seed_off: np.ndarray | None = None):
    """Diagonal voting over precomputed seed k-mers.

    vals/valid: (N, S) FORWARD seed values; seed_off: (S,) or (N, S) read
    offsets of each seed.  Returns (pos, votes, votes2, pos2): per read
    the exact best diagonal (the most-supported single diagonal inside
    the winning +-8 bin), its vote count, the runner-up locus' count, and
    the runner-up's exact diagonal (-1 if none) — the competitor the
    verify stage rescores for score-based MAPQ.

    On a canonical index, one lookup serves both strands: each hit's
    strand is ``ref_fwd_bit != read_fwd_bit``.  With ``rc_seed_off``
    (two-strand mode) the results come back as 2N rows — forward rows
    then reverse rows, hit diagonals computed with the matching strand's
    seed offsets.  Without it, reverse-strand hits are dropped.
    """
    N, S = vals.shape
    if seed_off.ndim == 1:
        seed_off = np.broadcast_to(seed_off[None, :], (N, S))
    canonical = index.canon_fwd is not None
    if canonical:
        rc_vals = _rc_kmers(vals, index.k)
        b_read = (vals <= rc_vals).reshape(-1)
        look = np.minimum(vals, rc_vals)
    else:
        if rc_seed_off is not None:
            raise ValueError("two-strand single-lookup needs a canonical "
                             "index")
        look = vals

    lo, hi = index.lookup(look.reshape(-1))
    cnt = hi - lo
    keep = (cnt > 0) & (cnt <= index.max_hits) & valid.reshape(-1)
    lo, hi = lo[keep], hi[keep]
    seed_read = np.repeat(np.arange(N, dtype=np.int64), S)[keep]
    seed_off = seed_off.reshape(-1)[keep]

    n_rows = 2 * N if rc_seed_off is not None else N
    pos = np.full(n_rows, -1, np.int64)
    votes = np.zeros(n_rows, np.int32)
    votes2 = np.zeros(n_rows, np.int32)
    total = int((hi - lo).sum())
    if total == 0:
        return pos, votes, votes2, pos.copy()
    reps = (hi - lo).astype(np.int64)
    flat_idx = np.repeat(lo, reps) + (
        np.arange(total) - np.repeat(np.cumsum(reps) - reps, reps))
    hit_pos = index.positions[flat_idx].astype(np.int64)
    hit_read = np.repeat(seed_read, reps)
    hit_off = np.repeat(seed_off, reps)
    if canonical:
        strand = index.canon_fwd[flat_idx] != np.repeat(b_read[keep], reps)
        if rc_seed_off is None:
            hit_read = hit_read[~strand]
            hit_diag = hit_pos[~strand] - hit_off[~strand]
        else:
            if rc_seed_off.ndim == 1:
                rc_seed_off = np.broadcast_to(rc_seed_off[None, :], (N, S))
            hit_roff = np.repeat(rc_seed_off.reshape(-1)[keep], reps)
            hit_read = hit_read + N * strand
            hit_diag = hit_pos - np.where(strand, hit_roff, hit_off)
    else:
        hit_diag = hit_pos - hit_off            # candidate read start
    if len(hit_read) == 0:
        return pos, votes, votes2, pos.copy()
    N = n_rows

    # vote: most-supported diagonal bin per read (+-indel tolerance //8),
    # then the runner-up = best bin among hits NOT adjacent to the winner
    # (adjacent bins are support for the same locus, not competition).
    # The second pass scans every non-adjacent hit, so a competitor can't
    # hide behind same-locus bins — and its exact diagonal comes back too,
    # which the verify stage rescoring (score-based MAPQ) needs.
    p1, votes[:], bins = _best_locus(hit_read, hit_diag, N)
    pos[:] = np.where(p1 >= 0, np.clip(p1, 0, len(index.ref) - 1), -1)
    adj = np.abs(hit_diag // 8 - bins[hit_read]) <= 1
    p2, votes2[:], _ = _best_locus(hit_read[~adj], hit_diag[~adj], N)
    pos2 = np.where(p2 >= 0, np.clip(p2, 0, len(index.ref) - 1), -1)
    return pos, votes, votes2, pos2


def _best_locus(hit_read: np.ndarray, hit_diag: np.ndarray, N: int):
    """Most-supported diagonal bin per read plus the most-supported exact
    diagonal inside it.  Returns (pos, votes, bins): best diagonal (int64,
    -1 where no hits), its bin's vote count, and the winning bin id
    (sentinel -2^60 where none)."""
    pos = np.full(N, -1, np.int64)
    votes = np.zeros(N, np.int32)
    bins = np.full(N, np.int64(-(1 << 60)))
    if len(hit_read) == 0:
        return pos, votes, bins
    diag_bin = hit_diag // 8
    key = hit_read * np.int64(1 << 40) + (diag_bin + np.int64(1 << 32))
    uniq, counts = np.unique(key, return_counts=True)
    u_read = (uniq >> 40).astype(np.int64)
    u_bin = (uniq & np.int64((1 << 40) - 1)) - np.int64(1 << 32)
    order = np.lexsort((counts, u_read))
    u_read_s, u_bin_s, counts_s = u_read[order], u_bin[order], counts[order]
    last = np.nonzero(np.diff(np.concatenate([u_read_s, [-1]])) != 0)[0]
    best_read = u_read_s[last]
    bins[best_read] = u_bin_s[last]
    votes[best_read] = counts_s[last].astype(np.int32)

    # exact diagonal: most-supported single diagonal within the best bin
    in_best = diag_bin == bins[hit_read]
    hr, hd = hit_read[in_best], hit_diag[in_best]
    dkey = hr * np.int64(1 << 40) + (hd + np.int64(1 << 32))
    du, dc = np.unique(dkey, return_counts=True)
    dr = (du >> 40).astype(np.int64)
    dd = (du & np.int64((1 << 40) - 1)) - np.int64(1 << 32)
    dorder = np.lexsort((dc, dr))
    dlast = np.nonzero(np.diff(np.concatenate([dr[dorder], [-1]])) != 0)[0]
    pos[dr[dorder][dlast]] = dd[dorder][dlast]
    return pos, votes, bins


def seed_candidates(index: ReferenceIndex, reads: np.ndarray,
                    read_len: int, stride: int | None = None,
                    both_strands: bool = False, full: bool = False):
    """Vectorized candidate position per read by diagonal voting.

    reads: (N, read_len) ASCII.  Returns (pos, votes) or, with
    ``both_strands``, (pos, votes, strand, votes2): best reference offset
    (int64, -1 if unmapped; the *exact* winning diagonal, not a bin
    estimate), its vote count, the winning strand (0 forward / 1
    reverse-complement), and the best competing vote count across both
    strands and non-adjacent diagonals (the MAPQ denominator).

    ``full=True`` (with both_strands) appends (pos2, strand2): the
    runner-up locus' diagonal and strand (-1/-1 if no competitor) — what
    the verify stage rescores for score-based MAPQ.
    """
    stride = stride or index.k
    k = index.k
    N = reads.shape[0]
    if both_strands and index.canon_fwd is not None:
        # fused native seeding (seed kmers + lookup + vote in one pass per
        # read; bit-identical to the NumPy pipeline below) — the host-side
        # hot path at scale
        import os as _os

        if _os.environ.get("MGL_TPU_NATIVE_SEED", "1") != "0":
            from mgl_tpu.native import map_seed_vote

            rows = map_seed_vote(reads, index, stride)
            if rows is not None:
                pos, votes, votes2, p2 = rows
                return _combine_strand_rows(pos, votes, votes2, p2, N, full)
    fvals, fvalid, offsets = _seed_kmers(reads, k, stride)
    if not both_strands:
        pos, votes, _, _ = _vote_diagonals(index, read_len, fvals, fvalid,
                                           offsets)
        return pos, votes
    if index.canon_fwd is not None:
        # canonical index: ONE lookup serves both strands (hits split by
        # the stored forward bit); rc-read offset of forward seed j is
        # L - k - offsets[j]
        roff = (read_len - k - offsets).astype(np.int32)
        pos, votes, votes2, p2 = _vote_diagonals(index, read_len, fvals,
                                                 fvalid, offsets,
                                                 rc_seed_off=roff)
    else:
        # rc seeds by bit transform: seed j of the rc read covers forward
        # offset offsets[S-1-j], i.e. rc-read offset L - k - offsets[S-1-j]
        if k <= 16:
            rvals = _rc_kmers(fvals[:, ::-1], k)
            rvalid = fvalid[:, ::-1]
            roff = (read_len - k - offsets[::-1]).astype(np.int32)
        else:  # wide k-mers: recompute on the rc reads
            rvals, rvalid, roff = _seed_kmers(revcomp(reads), k, stride)
        vals = np.concatenate([fvals, rvals], axis=0)
        valid = np.concatenate([fvalid, rvalid], axis=0)
        seed_off = np.concatenate(
            [np.broadcast_to(offsets[None, :], fvals.shape),
             np.broadcast_to(roff[None, :], rvals.shape)], axis=0)
        pos, votes, votes2, p2 = _vote_diagonals(index, read_len, vals,
                                                 valid, seed_off)
    return _combine_strand_rows(pos, votes, votes2, p2, N, full)


def _combine_strand_rows(pos, votes, votes2, p2, N, full):
    """Fold the 2N per-strand vote rows (forward rows then reverse rows)
    into per-read outputs: winning strand, best/second vote counts, and
    (with ``full``) the runner-up locus the verify stage rescores."""
    fw, rc = slice(0, N), slice(N, 2 * N)
    rc_wins = votes[rc] > votes[fw]
    strand = rc_wins.astype(np.int8)
    best_pos = np.where(rc_wins, pos[rc], pos[fw])
    best_votes = np.where(rc_wins, votes[rc], votes[fw])
    within = np.where(rc_wins, votes2[rc], votes2[fw])
    other = np.where(rc_wins, votes[fw], votes[rc])
    second = np.maximum(within, other).astype(np.int32)
    if not full:
        return best_pos, best_votes, strand, second
    # runner-up locus: the winning strand's non-adjacent runner-up vs the
    # LOSING strand's best — whichever has more support
    within_pos = np.where(rc_wins, p2[rc], p2[fw])
    other_pos = np.where(rc_wins, pos[fw], pos[rc])
    use_other = other > within
    pos2 = np.where(use_other, other_pos, within_pos)
    strand2 = np.where(use_other, 1 - strand, strand).astype(np.int8)
    strand2 = np.where(pos2 >= 0, strand2, -1).astype(np.int8)
    return best_pos, best_votes, strand, second, pos2, strand2


def mapq_from_votes(votes: np.ndarray, votes2: np.ndarray,
                    max_votes: int | None = None) -> np.ndarray:
    """Mapping quality from best-vs-second-best seed support.

    A repeat-aware gap model (the reference library has no mapper; this
    follows the minimap2-style shape): full confidence needs both a
    clear margin over the runner-up locus and enough absolute support.
    """
    v1 = np.asarray(votes, np.float64)
    v2 = np.asarray(votes2, np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        frac = np.where(v1 > 0, (v1 - v2) / np.maximum(v1, 1), 0.0)
    conf = np.minimum(1.0, v1 / 4.0)
    q = 60.0 * frac * conf
    return np.clip(np.rint(q), 0, 60).astype(np.int32)


def mapq_rescore(score1: np.ndarray, score2: np.ndarray, votes: np.ndarray,
                 params) -> np.ndarray:
    """Mapping quality from the SW score gap of the two best loci.

    Seed votes saturate (~9 non-overlapping seeds/read), so a
    near-duplicate locus one seed short of the winner still leaves a
    large vote fraction — vote-only MAPQ overcalls on repeats.  Here the
    verify stage has SW-scored BOTH loci, and confidence comes from the
    score deficit of the runner-up: one substitution costs
    ``match - mismatch`` score units and is worth ~6 phred of
    discrimination at typical sequencing error rates (the BWA-MEM scale,
    mapq ~ 6 * (s1-s2)/a), so

        mapq = clip(6 * (score1 - score2) / (match - mismatch), 0, 60)

    scaled by the absolute-support prior min(1, votes/4) — votes act as
    a prior only; the score gap is the evidence.  An exact repeat
    (score2 == score1) maps to 0 regardless of votes.
    """
    c = float(params.match) - float(params.mismatch)
    delta = np.asarray(score1, np.float64) - np.asarray(score2, np.float64)
    conf = np.minimum(1.0, np.asarray(votes, np.float64) / 4.0)
    q = 6.0 * np.maximum(delta, 0.0) / max(c, 1.0) * conf
    return np.clip(np.rint(q), 0, 60).astype(np.int32)



def _exact_tier(windows: np.ndarray, rsub: np.ndarray, window_pad: int,
                wlen: int, L: int, clipped: np.ndarray | None = None):
    """Exact-match fast tier: returns (exact mask, per-read window offset,
    -1 where inexact).  A read equal to a window substring provably attains
    the SW optimum (read_len * match), so SW verification is redundant.
    The diagonal-vote bin bounds the candidate offsets to [pad, pad+8);
    windows clipped at a reference edge can hold the hit anywhere, so the
    still-unmatched clipped ones get a full-range scan."""
    exact = np.zeros(len(rsub), bool)
    exact_o = np.full(len(rsub), -1, np.int64)

    def scan(cand: np.ndarray, offsets):
        for o in offsets:
            m = cand & ~exact
            m[m] = (windows[m, o: o + L] == rsub[m]).all(axis=1)
            exact_o[m] = o
            exact[m] = True

    allc = np.ones(len(rsub), bool)
    scan(allc, range(window_pad, min(window_pad + 8, wlen - L + 1)))
    if clipped is not None and (clipped & ~exact).any():
        scan(clipped, range(0, wlen - L + 1))
    return exact, exact_o


def map_reads(index: ReferenceIndex, reads: np.ndarray,
              window_pad: int = 24, params=None, strategy=None,
              with_cigar: bool = False, impl: str = "auto"):
    """Full map: seed -> window extract -> device SW verify.

    Returns dict with pos (candidate window start), score (SW best score),
    offset_in_window, and optionally cigar per read (unmapped: pos=-1).
    """
    from mgl_tpu.core.params import OverhangStrategy, SWParameters

    params = params or SWParameters(25, -50, 110, 6)
    strategy = strategy or OverhangStrategy.SOFTCLIP
    N, L = reads.shape
    pos, votes, strand, votes2 = seed_candidates(index, reads, L,
                                                 both_strands=True)
    mapped = np.nonzero(pos >= 0)[0]

    out = {
        "pos": np.full(N, -1, np.int64),
        "score": np.full(N, -(2**30), np.int64),
        "votes": votes,
        "votes2": votes2,
        "strand": strand,
        "mapq": mapq_from_votes(votes, votes2),
        "offset": np.full(N, -1, np.int64),   # window offset where known
        "window_pad": window_pad,
    }
    if with_cigar:
        out["cigar"] = np.array([""] * N, dtype=object)
        out["offset"] = np.zeros(N, np.int64)
    if len(mapped) == 0:
        return out

    wlen = L + 2 * window_pad
    start = np.clip(pos[mapped] - window_pad, 0,
                    max(len(index.ref) - wlen, 0)).astype(np.int64)
    # verify in aligned orientation: reverse-strand reads run as their
    # reverse complement (SAM stores SEQ/CIGAR in this orientation)
    oriented = np.where(strand[mapped, None] == 1,
                        revcomp(reads[mapped]), reads[mapped])

    def gather_windows():
        win_idx = start[:, None] + np.arange(wlen)[None, :]
        return index.ref[np.clip(win_idx, 0, len(index.ref) - 1)]

    if with_cigar:
        res = sw_cigar_windows(index, start, oriented, wlen, params,
                               strategy)
        out["pos"][mapped] = start
        for j, i in enumerate(mapped):
            out["cigar"][i], out["offset"][i] = res[j]
            out["score"][i] = 0
    else:
        # the device verifies every window (reference resident in device
        # memory); exact-tier offsets are recorded so coordinates/SAM
        # don't have to guess
        windows = gather_windows()
        clipped = start != (pos[mapped] - window_pad)
        exact, exact_o = _exact_tier(windows, oriented, window_pad, wlen, L,
                                     clipped)
        out["pos"][mapped] = start
        out["offset"][mapped[exact]] = exact_o[exact]
        out["score"][mapped[exact]] = L * int(params.match)
        rest = ~exact
        if rest.any():
            out["score"][mapped[rest]] = sw_score_windows(
                index, start[rest], oriented[rest], wlen, params, impl=impl)
    return out


# The device reference is word-packed: 8 bases per uint32 (4-bit codes,
# little nibble = lower ref offset).  A window gather fetches ~26 aligned
# int32 WORDS per lane instead of ~200 single bytes (one gather index per
# word, not per base; tools/profile_gather.py times the two), halves the
# reference's device-memory footprint, and keeps flat int32 WORD indices
# valid to 8.6 Gbp (so the
# human genome rides the flat fast path).  Past _BLOCK_GATE the words
# live as overlapping 2^_BLOCK_BITS-bp rows and a window start becomes a
# (row, word-offset, nibble) int32 triple.  The gate is monkeypatched
# small in tests to exercise the blocked path against the flat one.
_BLOCK_BITS = 27
_BLOCK_GATE = 2**33
_BLOCK_OVERLAP = 4096    # bp, > any wlen: a window never leaves its row


_REF_PAD = 5   # outside code space 0..4: padding never matches any read
_PAD_WORD = np.uint32(0x55555555)        # eight _REF_PAD nibbles


def _pack_ref_words(code: np.ndarray) -> np.ndarray:
    """(n,) uint8 codes -> (ceil(n/8),) uint32 words, nibble j of word w
    = code[8w + j]; the ragged tail is _REF_PAD-filled.  Chunked so the
    widened uint32 packing temp stays ~128 MB (4M words x 8 lanes x 4 B)
    even at genome scale."""
    n = len(code)
    nw = -(-n // 8)
    padded = np.full(nw * 8, _REF_PAD, np.uint8)
    padded[:n] = code
    out = np.empty(nw, np.uint32)
    step = 1 << 22
    for lo in range(0, nw, step):
        blk = padded[lo * 8: (lo + step) * 8].reshape(-1, 8).astype(
            np.uint32)
        acc = blk[:, 0]
        for j in range(1, 8):
            acc |= blk[:, j] << np.uint32(4 * j)
        out[lo: lo + len(acc)] = acc
    return out


def _ref_device(index: "ReferenceIndex"):
    """Device-resident word-packed reference: (array, blocked).  Flat
    padded uint32 vector below _BLOCK_GATE; overlapping (n_rows,
    words_per_row) matrix above."""
    import jax.numpy as jnp

    dev = getattr(index, "_ref_dev", None)
    if dev is not None:
        return dev, getattr(index, "_ref_blocked", False)
    n = len(index.ref)
    words = _pack_ref_words(encode(index.ref))
    ov_w = _BLOCK_OVERLAP // 8 + 8
    if n <= _BLOCK_GATE:
        index._ref_dev = jnp.asarray(np.concatenate(
            [words, np.full(ov_w, _PAD_WORD, np.uint32)]))
        index._ref_blocked = False
    else:
        S_w = 1 << (_BLOCK_BITS - 3)               # words per row
        n_rows = -(-len(words) // S_w)
        padded = np.concatenate(
            [words, np.full(S_w + ov_w, _PAD_WORD, np.uint32)])
        rows = np.lib.stride_tricks.as_strided(
            padded, shape=(n_rows, S_w + ov_w), strides=(4 * S_w, 4))
        index._ref_dev = jnp.asarray(np.ascontiguousarray(rows))
        index._ref_blocked = True
    return index._ref_dev, index._ref_blocked


def _pack_codes(reads: np.ndarray) -> np.ndarray:
    """(B, L) ASCII reads -> (B, ceil(L/2)) packed 4-bit codes (hi nibble
    = even column): half the host->device bytes of the code matrix."""
    codes = encode(reads.reshape(-1)).reshape(reads.shape)
    if codes.shape[1] % 2:
        codes = np.concatenate(
            [codes, np.full((len(codes), 1), _REF_PAD, np.uint8)], axis=1)
    return (codes[:, 0::2] << 4) | codes[:, 1::2]


def _split_starts(starts: np.ndarray, blocked: bool):
    """int64 bp window starts -> int32 device index arrays for the
    word-packed reference: flat (word, nibble) pair or blocked
    (row, word-offset, nibble) triple."""
    starts = np.asarray(starts, np.int64)
    nib = (starts & 7).astype(np.int32)
    if not blocked:
        return ((starts >> 3).astype(np.int32), nib)
    off = starts & ((1 << _BLOCK_BITS) - 1)
    return ((starts >> _BLOCK_BITS).astype(np.int32),
            (off >> 3).astype(np.int32), nib)


def _gather_windows(ref_dev, starts, packed_u8, wlen: int, qlen: int,
                    blocked: bool):
    """Device window gather: (B, wlen) reference codes at each start and
    the (B, qlen) read codes, both int32.  Traceable."""
    import jax.numpy as jnp

    # window = nw aligned uint32 words (8 bases each) straddling
    # [start, start + wlen); the +1 covers the worst-case nibble shift
    nw = (wlen + 7) // 8 + 1
    iota_w = jnp.arange(nw, dtype=jnp.int32)[None, :]
    if blocked:
        bid, w0, s = starts
        B = bid.shape[0]
        w = ref_dev[bid[:, None], w0[:, None] + iota_w]
    else:
        w0, s = starts
        B = w0.shape[0]
        w = ref_dev[w0[:, None] + iota_w]
    # unpack nibbles (little nibble = lower offset), then realign each
    # lane by its start's intra-word shift with 8 vectorized selects —
    # per-row dynamic slicing would defeat vectorization
    nib = (w[:, :, None] >> (jnp.uint32(4)
                             * jnp.arange(8, dtype=jnp.uint32)
                             )[None, None, :]) & jnp.uint32(0xF)
    flat = nib.reshape(B, nw * 8).astype(jnp.int32)
    win = flat[:, :wlen]
    for k in range(1, 8):
        win = jnp.where((s == k)[:, None], flat[:, k: k + wlen], win)
    # reads arrive as packed 4-bit codes (see _pack_codes)
    codes = jnp.stack([packed_u8 >> 4, packed_u8 & 0xF],
                      axis=-1).reshape(B, -1)[:, :qlen].astype(jnp.int32)
    return win, codes


def _windowed_scores_fn(wlen: int, qlen: int, params, impl: str = "auto",
                        blocked: bool = False):
    """jit-compiled: (ref_dev, starts, packed reads) -> (B,) int32 best SW
    score of each read against its window (ops/sw.best_scores)."""
    import jax
    import jax.numpy as jnp

    from mgl_tpu.ops.sw import best_scores

    @jax.jit
    def fn(ref_dev, starts, packed_u8):
        win, codes = _gather_windows(ref_dev, starts, packed_u8, wlen, qlen,
                                     blocked)
        B = win.shape[0]
        return best_scores(win, jnp.full((B,), wlen, jnp.int32), codes,
                           jnp.full((B,), qlen, jnp.int32), params,
                           impl=impl)

    return fn


def _windowed_traceback_fn(wlen: int, qlen: int, params, indel_init: bool,
                           blocked: bool = False):
    """jit-compiled: (ref_dev, starts, packed reads) -> the plain forward
    pass with traceback (ops/sw.SWForwardResult) over the windows."""
    import jax
    import jax.numpy as jnp

    from mgl_tpu.ops.sw import sw_forward

    @jax.jit
    def fn(ref_dev, starts, packed_u8):
        win, codes = _gather_windows(ref_dev, starts, packed_u8, wlen, qlen,
                                     blocked)
        B = win.shape[0]
        return sw_forward(win, jnp.full((B,), wlen, jnp.int32), codes,
                          jnp.full((B,), qlen, jnp.int32),
                          jnp.int32(params.match), jnp.int32(params.mismatch),
                          jnp.int32(params.gap_open),
                          jnp.int32(params.gap_extend), indel_init=indel_init)

    return fn


def _stage_windows(index: "ReferenceIndex", starts: np.ndarray,
                   reads: np.ndarray, grid: tuple[int, ...]):
    """Host staging of a window batch: device reference, padded start
    index arrays and packed read codes, with the lane count bucketed on
    ``grid`` so recompiles don't track every batch size."""
    import jax.numpy as jnp

    from mgl_tpu.batch.bucketing import bucket_dims

    ref_dev, blocked = _ref_device(index)
    B = len(reads)
    Bp = round_up(bucket_dims(B, grid), 1024)
    st = []
    for part in _split_starts(starts, blocked):
        a = np.zeros(Bp, np.int32)
        a[:B] = part
        st.append(jnp.asarray(a))
    packed = _pack_codes(reads)
    rd = np.zeros((Bp, packed.shape[1]), np.uint8)
    rd[:B] = packed
    return ref_dev, blocked, tuple(st), jnp.asarray(rd)


def _cached_fn(index: "ReferenceIndex", key, build):
    cache = getattr(index, "_win_fns", None)
    if cache is None:
        cache = index._win_fns = {}
    if key not in cache:
        cache[key] = build()
    return cache[key]


def _sw_score_windows_async(index: "ReferenceIndex", starts: np.ndarray,
                            reads: np.ndarray, wlen: int, params,
                            impl: str = "auto"):
    """Launch the device window-score pass without blocking; returns the
    device score handle and the real pair count (JAX dispatch is async,
    so host work for the next chunk overlaps this chunk's device time)."""
    from mgl_tpu.core.backend import resolve_impl

    ref_dev, blocked, st, rd = _stage_windows(
        index, starts, reads,
        (1024, 4096, 16384, 32768, 65536, 131072, 262144))
    L = reads.shape[1]
    impl = resolve_impl(impl)
    fn = _cached_fn(index, ("score", wlen, L, params, impl, blocked),
                    lambda: _windowed_scores_fn(wlen, L, params, impl,
                                                blocked))
    return fn(ref_dev, st, rd), len(reads)


def sw_score_windows(index: "ReferenceIndex", starts: np.ndarray,
                     reads: np.ndarray, wlen: int, params,
                     impl: str = "auto") -> np.ndarray:
    """Best SW score of each read vs its reference window, with the window
    gather running on device (reference resident in device memory)."""
    sc, B = _sw_score_windows_async(index, starts, reads, wlen, params, impl)
    return np.asarray(sc)[:B].astype(np.int64)


def _nm_at(ref: np.ndarray, pos: np.ndarray, oriented: np.ndarray
           ) -> np.ndarray:
    """Mismatch count of each oriented read vs the reference at its
    predicted start (out-of-range columns clamp to the last ref byte —
    such rows are edge-clipped and the caller handles them separately).
    Native single pass when available; NumPy gather fallback."""
    from mgl_tpu.native import exact_nm

    nm = exact_nm(oriented, ref, pos)
    if nm is not None:
        return nm.astype(np.int64)
    L = oriented.shape[1]
    rd_idx = pos[:, None] + np.arange(L)[None, :]
    eq = ref[np.clip(rd_idx, 0, len(ref) - 1)] == oriented
    return (L - eq.sum(axis=1)).astype(np.int64)


def map_reads_stream(index: ReferenceIndex, reads: np.ndarray,
                     chunk: int = 131072, window_pad: int = 24,
                     params=None, with_cigar: bool = False,
                     strategy=None, impl: str = "auto") -> dict:
    """Chunked score-mode mapping with host/device overlap: while the device
    verifies chunk k, the host seeds and exact-tiers chunk k+1 (JAX
    dispatch is asynchronous; results are materialized one chunk behind).

    Reads whose seeding found a competing locus (pos2) get that locus
    SW-scored in the SAME device launch as the primary windows, and their
    MAPQ is rescored from the score gap (mapq_rescore); unambiguous reads
    keep vote-based MAPQ.  Same outputs as map_reads without with_cigar,
    plus pos2/score2 diagnostics.

    ``with_cigar=True`` adds full CIGARs at streaming throughput via a
    certified-diagonal tier: the SW recurrence pins alignment starts to
    the matrix boundary (ref_impl/sw_scalar.py, sw.cpp:5-146), so a
    full-length diagonal alignment scores exactly
    ``(L-nm)*match + nm*mismatch`` — when the verified global best equals
    that, "<L>M" is provably an optimal CIGAR and no traceback is needed.
    Only reads where a gapped path beats the diagonal (indels,
    mis-seeds, window-edge clips) go through the plain traceback pass
    (sw_cigar_windows) in a bounded post-pass.  ``impl`` selects the
    window verify (core/backend.resolve_impl).
    """
    from mgl_tpu.core.params import OverhangStrategy, SWParameters
    from mgl_tpu.utils.metrics import METRICS

    params = params or SWParameters(25, -50, 110, 6)
    strategy = strategy or OverhangStrategy.SOFTCLIP
    # the certified tier's score model assumes the zero boundary rows of
    # the non-indel-init strategies; INDEL/LEADING_INDEL windows take the
    # traceback for every read
    cert_ok = not (strategy & (OverhangStrategy.INDEL
                               | OverhangStrategy.LEADING_INDEL))
    N, L = reads.shape
    wlen = L + 2 * window_pad
    out = {
        "pos": np.full(N, -1, np.int64),
        "score": np.full(N, -(2**30), np.int64),
        "votes": np.zeros(N, np.int32),
        "votes2": np.zeros(N, np.int32),
        "strand": np.zeros(N, np.int8),
        "mapq": np.zeros(N, np.int32),
        "offset": np.full(N, -1, np.int64),
        "pos2": np.full(N, -1, np.int64),
        "score2": np.full(N, -(2**30), np.int64),
        "window_pad": window_pad,
    }
    if with_cigar:
        out["cigar"] = np.array([""] * N, dtype=object)
    tb_idx: list = []            # reads needing the traceback tier
    pending = None

    def finalize(p):
        sc, B, n1, idx1, idx2, diag1 = p
        with METRICS.timer("map.sync"):
            scores = np.asarray(sc)[:B].astype(np.int64)
        out["score"][idx1] = scores[:n1]
        if with_cigar and n1:
            cert = cert_ok & (diag1 >= 0) & (scores[:n1] == diag1)
            for i in idx1[cert]:
                out["cigar"][i] = f"{L}M"
            out["offset"][idx1[cert]] = window_pad
            tb_idx.extend(idx1[~cert])
        if len(idx2):
            out["score2"][idx2] = scores[n1:]
            out["mapq"][idx2] = mapq_rescore(out["score"][idx2],
                                             scores[n1:],
                                             out["votes"][idx2], params)

    for lo in range(0, N, chunk):
        hi = min(lo + chunk, N)
        sub = reads[lo:hi]
        with METRICS.timer("map.seed"):
            pos, votes, strand, votes2, pos2, strand2 = seed_candidates(
                index, sub, L, both_strands=True, full=True)
        out["votes"][lo:hi] = votes
        out["votes2"][lo:hi] = votes2
        out["strand"][lo:hi] = strand
        out["mapq"][lo:hi] = mapq_from_votes(votes, votes2)
        mapped = np.nonzero(pos >= 0)[0]
        if len(mapped) == 0:
            if pending is not None:
                finalize(pending)
                pending = None
            continue
        with METRICS.timer("map.host_tier"):
            start = np.clip(pos[mapped] - window_pad, 0,
                            max(len(index.ref) - wlen, 0)).astype(np.int64)
            rsub = np.where(strand[mapped, None] == 1,
                            revcomp(sub[mapped]), sub[mapped])
            clipped = start != (pos[mapped] - window_pad)
            # seeds pin the exact best diagonal, so the exact tier needs
            # one equality check at the predicted read start (a read that
            # differs there can't be exact at any other offset); only
            # edge-clipped windows (rare) still take the full-range scan
            nm = _nm_at(index.ref, pos[mapped], rsub)
            exact = ~clipped & (nm == 0)
            exact_o = np.where(exact, np.int64(window_pad), np.int64(-1))
            # certified-diagonal score: what a full-length gap-free
            # alignment at the seeded diagonal scores (valid where the
            # window isn't edge-clipped)
            diag_score = np.where(
                clipped, np.int64(-1),
                (L - nm) * np.int64(params.match)
                + nm * np.int64(params.mismatch))
            if clipped.any():
                ci = np.nonzero(clipped)[0]
                wi = start[ci, None] + np.arange(wlen)[None, :]
                win_c = index.ref[np.clip(wi, 0, len(index.ref) - 1)]
                e2, o2 = _exact_tier(win_c, rsub[ci], window_pad, wlen, L,
                                     np.ones(len(ci), bool))
                exact[ci] = e2
                exact_o[ci] = o2
            # competitor loci of mapped reads ride the same launch
            amb = np.nonzero((pos >= 0) & (pos2 >= 0))[0]
            start2 = np.clip(pos2[amb] - window_pad, 0,
                             max(len(index.ref) - wlen, 0)).astype(np.int64)
            rsub2 = np.where(strand2[amb, None] == 1,
                             revcomp(sub[amb]), sub[amb])
        out["pos"][lo + mapped] = start
        out["pos2"][lo + amb] = start2
        out["offset"][lo + mapped[exact]] = exact_o[exact]
        out["score"][lo + mapped[exact]] = L * int(params.match)
        if with_cigar:
            for i in lo + mapped[exact]:
                out["cigar"][i] = f"{L}M"
        rest = ~exact
        launched = None
        if rest.any() or len(amb):
            with METRICS.timer("map.dispatch"):
                sc, B = _sw_score_windows_async(
                    index, np.concatenate([start[rest], start2]),
                    np.concatenate([rsub[rest], rsub2], axis=0),
                    wlen, params, impl)
            launched = (sc, B, int(rest.sum()), lo + mapped[rest], lo + amb,
                        diag_score[rest])
        if pending is not None:
            finalize(pending)
        pending = launched
    if pending is not None:
        finalize(pending)
    if with_cigar and tb_idx:
        # traceback tier: the minority of reads whose optimal alignment
        # isn't the seeded diagonal (indels / edge clips / mis-seeds)
        METRICS.count("map.tb_reads", len(tb_idx))
        with METRICS.timer("map.traceback"):
            tb = np.asarray(tb_idx, np.int64)
            rsub_tb = np.where(out["strand"][tb, None] == 1,
                               revcomp(reads[tb]), reads[tb])
            res = sw_cigar_windows(index, out["pos"][tb], rsub_tb, wlen,
                                   params, strategy)
            for j, i in enumerate(tb):
                out["cigar"][i], out["offset"][i] = res[j]
    return out


def sw_cigar_windows(index: "ReferenceIndex", starts: np.ndarray,
                     reads: np.ndarray, wlen: int, params,
                     strategy, chunk: int = 8192) -> list:
    """Full CIGARs of reads vs their reference windows: device-side window
    gather, the plain forward pass with traceback (ops/sw.sw_forward),
    then the host ScoreMax and CIGAR decode (ops/cigar.decode_batch).
    Processes fixed-size chunks so compiled shapes recur and the
    traceback transfer stays bounded."""
    if len(reads) > chunk:
        out = []
        for lo in range(0, len(reads), chunk):
            out.extend(sw_cigar_windows(index, starts[lo: lo + chunk],
                                        reads[lo: lo + chunk], wlen, params,
                                        strategy, chunk))
        return out
    from mgl_tpu.core.params import OverhangStrategy
    from mgl_tpu.ops.cigar import decode_batch
    from mgl_tpu.ops.sw import compute_score_max

    ref_dev, blocked, st, rd = _stage_windows(index, starts, reads,
                                              (1024, 4096, 8192))
    B, L = reads.shape
    indel_init = bool(
        strategy & (OverhangStrategy.INDEL | OverhangStrategy.LEADING_INDEL))
    fn = _cached_fn(index, ("tb", wlen, L, params, indel_init, blocked),
                    lambda: _windowed_traceback_fn(wlen, L, params,
                                                   indel_init, blocked))
    res = fn(ref_dev, st, rd)
    tlen = np.full(B, wlen, np.int32)
    qlen = np.full(B, L, np.int32)
    ez = compute_score_max(np.asarray(res.last_col[:, :B]),
                           np.asarray(res.last_row[:, :B]), tlen, qlen)
    return decode_batch(np.asarray(res.btr[:, :B]), ez, tlen, qlen, strategy)


def sw_score_batch(targets: np.ndarray, queries: np.ndarray, params,
                   impl: str = "auto") -> np.ndarray:
    """Best SW score per pair (max over last row/col) of host-side
    windows, score-only device pass — the mapper's verify stage."""
    import jax.numpy as jnp

    from mgl_tpu.ops.sw import best_scores

    B, T = targets.shape
    Q = queries.shape[1]
    return np.asarray(best_scores(
        jnp.asarray(targets.astype(np.int32)), jnp.full((B,), T, jnp.int32),
        jnp.asarray(queries.astype(np.int32)), jnp.full((B,), Q, jnp.int32),
        params, impl=impl)).astype(np.int64)
