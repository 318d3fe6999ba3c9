"""Genome-scale mapper regressions (CPU).

Covers the three scale hazards of BASELINE config 4 at full genome size:
- k-mer offsets past the int32 boundary (2.147 Gbp; human ref is 3.1 Gbp)
- the blocked device window gather (int32 device indices via (row, offset)
  pairs once the reference exceeds ``_BLOCK_GATE``)
- score-based MAPQ: the verify stage rescores the runner-up locus and a
  near-duplicate (small-indel) repeat no longer gets vote-level confidence.
"""

import numpy as np
import pytest

from mgl_tpu.pipelines import mapper as M
from mgl_tpu.pipelines.mapper import (ReferenceIndex, map_reads,
                                      map_reads_stream, mapq_rescore)

BASES = np.frombuffer(b"ACGT", np.uint8)


def _shifted_index(seg: np.ndarray, big_off: int, k: int = 16):
    """Index of ``seg`` embedded at offset ``big_off`` of a zeros (i.e.
    non-ACGT, unmatchable) reference — builds the small index and shifts
    its positions, so the test doesn't pay a 2 Gbp k-mer pass."""
    small = ReferenceIndex.build(seg, k=k)
    ref = np.zeros(big_off + len(seg) + 4096, np.uint8)
    ref[big_off: big_off + len(seg)] = seg
    shifted = small.positions.astype(np.int64) + big_off
    assert shifted.max() < 2**32
    return ReferenceIndex(
        k=k, ref=ref, sorted_kmers=small.sorted_kmers,
        positions=shifted.astype(np.uint32), max_hits=small.max_hits,
        prefix_table=None, canon_fwd=small.canon_fwd)


def test_native_radix_index_build_bit_identical(monkeypatch):
    """The native fused radix-sort index build (sorted_kmers, positions,
    canon_fwd, prefix_table) is bit-identical to the numpy argsort path,
    including N runs (invalid k-mers) and both k parities."""
    import mgl_tpu.native as nat

    rng = np.random.default_rng(7)
    ref = rng.choice(BASES, size=300_000)
    ref[rng.integers(0, len(ref), 200)] = ord("N")

    def build_with(native: str, k: int):
        monkeypatch.setenv("MGL_TPU_NATIVE", native)
        monkeypatch.setattr(nat, "_lib", None)
        monkeypatch.setattr(nat, "_tried", False)
        return ReferenceIndex.build(ref, k=k)

    for k in (16, 15, 12):
        a = build_with("1", k)
        if nat.get_lib() is None:
            pytest.skip("native lib unavailable")
        b = build_with("0", k)
        assert a.sorted_kmers.dtype == b.sorted_kmers.dtype == np.uint32
        assert np.array_equal(a.sorted_kmers, b.sorted_kmers)
        assert np.array_equal(a.positions, b.positions)
        assert np.array_equal(a.canon_fwd, b.canon_fwd)
        assert (a.prefix_table is None) == (b.prefix_table is None)
        if a.prefix_table is not None:
            assert np.array_equal(a.prefix_table, b.prefix_table)


def test_native_seed_vote_bit_identical(monkeypatch):
    """The fused native seeding engine (seed k-mers -> canonical lookup ->
    diagonal vote, native/src map_seed_vote) returns outputs bit-identical
    to the NumPy _seed_kmers/_vote_diagonals pipeline — including strand
    folding, runner-up loci, repeat tie-breaking, N bases, junk reads, and
    the prefix jump table vs pure-binary-search index shapes."""
    from mgl_tpu.native import exact_nm, get_lib

    if get_lib() is None:
        pytest.skip("native lib unavailable")
    rng = np.random.default_rng(21)
    ref = rng.choice(BASES, size=1_500_000)
    ref[3000:3300] = ref[90_000:90_300]           # duplicate locus
    ref[70_000:70_050] = ref[90_000:90_050]       # partial repeat
    ref[123_456:123_470] = ord("N")
    L, N = 150, 8192
    tp = rng.integers(0, len(ref) - L, N)
    reads = ref[tp[:, None] + np.arange(L)[None, :]].copy()
    mut = rng.random(reads.shape) < 0.02
    reads[mut] = rng.choice(BASES, size=int(mut.sum()))
    reads[N // 2:] = M.revcomp(reads[N // 2:])
    reads[:64] = rng.choice(BASES, size=(64, L))  # junk
    reads[64:96, 10] = ord("N")                   # ambiguous bases

    # with jump table (>=1M kmers) and without (forced small threshold)
    for idx in (ReferenceIndex.build(ref, k=16),
                ReferenceIndex.build(ref[:200_000], k=16)):
        monkeypatch.setenv("MGL_TPU_NATIVE_SEED", "1")
        a = M.seed_candidates(idx, reads, L, both_strands=True, full=True)
        monkeypatch.setenv("MGL_TPU_NATIVE_SEED", "0")
        b = M.seed_candidates(idx, reads, L, both_strands=True, full=True)
        for x, y in zip(a, b):
            assert np.array_equal(np.asarray(x), np.asarray(y))

    # the exact-tier mismatch counter matches the gather formula,
    # including edge clamping
    pos = np.clip(tp + rng.integers(-3, 4, N), 0, len(ref) - 1)
    pos[:8] = len(ref) - L + 100                  # clamp past the edge
    nm = exact_nm(reads, ref, pos.astype(np.int64))
    rd_idx = pos[:, None] + np.arange(L)[None, :]
    eq = ref[np.clip(rd_idx, 0, len(ref) - 1)] == reads
    assert np.array_equal(nm, (L - eq.sum(axis=1)).astype(np.int32))


def _indel_reads(rng, ref, L, N):
    """Reads at random loci with a deletion, an insertion, clipped heavy
    mismatches or several events, by index mod 5 (0: exact)."""
    tp = rng.integers(24, len(ref) - L - 24, N)
    reads = np.zeros((N, L), np.uint8)
    for i in range(N):
        s = tp[i]
        r = ref[s: s + L].copy()
        kind = i % 5
        if kind == 1:
            r = np.concatenate([ref[s: s + 50], ref[s + 53: s + L + 3]])
        elif kind == 2:
            r = np.concatenate([ref[s: s + 60], rng.choice(BASES, 4),
                                ref[s + 60: s + L - 4]])
        elif kind == 3:
            m = rng.random(L) < 0.1
            r[m] = rng.choice(BASES, int(m.sum()))
            r[:7] = rng.choice(BASES, 7)
        elif kind == 4:
            for o in (20, 45, 70, 95):
                r[o] = BASES[(int(np.searchsorted(BASES, r[o])) + 1) % 4]
            r = np.concatenate([r[:30], r[32:], ref[s + L: s + L + 2]])
        reads[i] = r[:L]
    return tp, reads


@pytest.mark.parametrize("strategy", ["SOFTCLIP", "INDEL", "LEADING_INDEL",
                                      "IGNORE"])
def test_cigar_windows_match_aligner(strategy):
    """sw_cigar_windows (device window gather + plain traceback + host
    decode) gives the CIGARs and offsets of SmithWatermanAligner on
    host-sliced windows, for deletions, insertions, clipped heavy-mismatch
    reads and multi-event reads, in every overhang strategy."""
    from mgl_tpu.api import SmithWatermanAligner
    from mgl_tpu.core.params import OverhangStrategy, SWParameters
    from mgl_tpu.pipelines.mapper import sw_cigar_windows

    rng = np.random.default_rng(5)
    ref = rng.choice(BASES, size=120_000)
    L, N = 120, 40
    wlen = L + 48
    tp, reads = _indel_reads(rng, ref, L, N)
    starts = (tp - 24).astype(np.int64)
    index = ReferenceIndex.build(ref, k=16)
    params = SWParameters(25, -50, 110, 6)
    strat = OverhangStrategy[strategy]
    got = sw_cigar_windows(index, starts, reads, wlen, params, strat)
    win = ref[starts[:, None] + np.arange(wlen)[None, :]]
    want = SmithWatermanAligner().align_batch(list(win), list(reads),
                                              params, strat)
    assert got == [(r.cigar, r.offset) for r in want]


def test_cigar_windows_keep_every_deletion():
    """Reads with 10-17 two-base deletions: the traceback tier keeps every
    deleted base end to end (the optimum may merge adjacent deletions, so
    bases are counted, not runs)."""
    import re

    from mgl_tpu.core.params import OverhangStrategy, SWParameters
    from mgl_tpu.pipelines.mapper import sw_cigar_windows

    rng = np.random.default_rng(17)
    ref = rng.choice(BASES, size=60_000)
    L, pad = 120, 40
    wlen = L + 2 * pad
    n_dels = list(range(10, 18)) * 2
    N = len(n_dels)
    tp = rng.integers(pad, len(ref) - 2 * wlen, N)
    reads = np.zeros((N, L), np.uint8)
    for i, nd in enumerate(n_dels):
        s = int(tp[i])
        chunk = L // (nd + 1)
        span, got, parts = s, 0, []
        for j in range(nd + 1):
            take = chunk if j < nd else L - got
            parts.append(ref[span: span + take])
            got += take
            span += take + 2                      # 2-bp deletion
        reads[i] = np.concatenate(parts)[:L]
    starts = (tp - pad).astype(np.int64)
    index = ReferenceIndex.build(ref, k=16)
    params = SWParameters(25, -50, 110, 6)
    res = sw_cigar_windows(index, starts, reads, wlen, params,
                           OverhangStrategy.SOFTCLIP)
    for i, nd in enumerate(n_dels):
        dels = sum(int(n) for n, op in
                   re.findall(r"(\d+)([MIDS])", res[i][0]) if op == "D")
        assert dels >= 2 * nd, (i, nd, res[i])


def test_positions_past_int32_boundary():
    """Reads placed beyond 2.147 Gbp map to the right (uint32) offsets:
    the voting/verify arithmetic must widen to int64 throughout."""
    rng = np.random.default_rng(11)
    seg = rng.choice(BASES, size=20_000)
    big_off = 2_600_000_123           # past int32 AND past 2.5 Gbp (the
    idx = _shifted_index(seg, big_off)  # 3.1 Gbp genome's upper half)

    N, L = 48, 100
    starts = rng.integers(64, len(seg) - L - 64, size=N)
    reads = seg[starts[:, None] + np.arange(L)[None, :]].copy()
    mut = rng.random((N, L)) < 0.01
    reads[mut] = rng.choice(BASES, size=int(mut.sum()))
    reads[N // 2:] = M.revcomp(reads[N // 2:])      # half reverse-strand

    out = map_reads(idx, reads, impl="xla")
    mapped = out["pos"] >= 0
    assert mapped.mean() > 0.95
    d = (big_off + starts[mapped]) - out["pos"][mapped]
    assert ((d >= 0) & (d <= 48)).all()
    assert (out["score"][mapped] >= 0.8 * 25 * L).all()
    assert (out["strand"][N // 2:] == 1).mean() > 0.9
    # locate() round-trips past the boundary
    cid, local = idx.locate(out["pos"][mapped])
    assert (cid == 0).all() and (local == out["pos"][mapped]).all()


def test_word_gather_all_shifts_and_edges():
    """The word-packed window gather (8 bp/uint32 + device unpack +
    nibble realign, mapper.py:_gather_windows) must be exact at
    every intra-word shift 0..7 and at both reference edges (start 0 and
    the last valid start) — compared against SW scores on host-sliced
    byte windows."""
    from mgl_tpu.core.params import SWParameters
    from mgl_tpu.pipelines.mapper import (ReferenceIndex, sw_score_batch,
                                          sw_score_windows)

    rng = np.random.default_rng(23)
    ref = rng.choice(BASES, size=50_011)          # odd length: ragged tail
    idx = ReferenceIndex.build(ref, k=16)
    L, wlen = 100, 148
    last = len(ref) - wlen
    starts = np.array(
        list(range(8)) + list(range(last - 7, last + 1))
        + [4096 + s for s in range(8)], np.int64)
    reads = np.zeros((len(starts), L), np.uint8)
    for i, s in enumerate(starts):
        r = ref[s + 24: s + 24 + L].copy()
        r[::17] = BASES[(np.searchsorted(BASES, r[::17]) + 1) % 4]
        reads[i] = r
    p = SWParameters(25, -50, 110, 6)
    dev = sw_score_windows(idx, starts, reads, wlen, p)
    win = ref[starts[:, None] + np.arange(wlen)[None, :]]
    host = sw_score_batch(win, reads, p)
    np.testing.assert_array_equal(dev, host)


def test_blocked_window_gather_matches_flat(monkeypatch):
    """The (row, offset) blocked device gather is bit-identical to the
    flat gather — exercised by shrinking the gate/block size so a small
    reference takes the genome-scale path."""
    rng = np.random.default_rng(12)
    ref = rng.choice(BASES, size=60_000)
    N, L = 64, 100
    starts = rng.integers(0, len(ref) - L, size=N)
    reads = ref[starts[:, None] + np.arange(L)[None, :]].copy()
    mut = rng.random((N, L)) < 0.02
    reads[mut] = rng.choice(BASES, size=int(mut.sum()))

    flat = map_reads_stream(ReferenceIndex.build(ref, k=16), reads)
    monkeypatch.setattr(M, "_BLOCK_GATE", 1)
    monkeypatch.setattr(M, "_BLOCK_BITS", 12)   # 4096-bp rows
    idx2 = ReferenceIndex.build(ref, k=16)
    blocked = map_reads_stream(idx2, reads)
    assert idx2._ref_blocked
    for key in ("pos", "score", "mapq", "strand", "offset"):
        np.testing.assert_array_equal(flat[key], blocked[key])


def _indel_repeat_fixture():
    """Reference with locus A and a near-duplicate B = A minus one base:
    the deletion shifts half of B's seed diagonals into the adjacent bin
    (posB % 8 == 0) and kills the straddling seed, so seed votes show a
    wide margin (8 vs 4 -> vote-MAPQ ~30, a 0.1% error claim) while the
    true SW score gap is one gap-open penalty (genuinely ambiguous)."""
    rng = np.random.default_rng(13)
    L = 128
    segA = rng.choice(BASES, size=L)
    segB = np.delete(segA, 60)                  # 1bp deletion
    posA, posB = 3_000, 16_000
    ref = rng.choice(BASES, size=40_000)
    ref[posA: posA + L] = segA
    ref[posB: posB + len(segB)] = segB
    return ReferenceIndex.build(ref, k=16), segA[None, :].copy(), posA


def test_score_mapq_not_overcalled_on_near_duplicate():
    idx, read, posA = _indel_repeat_fixture()
    out = map_reads_stream(idx, read)
    assert out["pos"][0] >= 0
    assert abs((out["pos"][0] + out["window_pad"]) - posA) <= 8
    # seeding found the duplicate as runner-up...
    assert out["pos2"][0] >= 0
    v1, v2 = out["votes"][0], out["votes2"][0]
    vote_q = M.mapq_from_votes(np.array([v1]), np.array([v2]))[0]
    # ...vote-only confidence is high (the overcall this guards against)
    assert vote_q >= 25
    # ...but the rescored MAPQ sees the tiny SW gap (one 4bp gap penalty)
    assert out["score2"][0] > -(2**29), "runner-up locus was not scored"
    gap = out["score"][0] - out["score2"][0]
    assert 0 < gap <= 200                       # ~ one gap-open penalty
    assert out["mapq"][0] <= 15
    assert out["mapq"][0] < vote_q - 10


def test_score_mapq_unique_read_stays_confident():
    rng = np.random.default_rng(14)
    ref = rng.choice(BASES, size=40_000)
    L = 128
    starts = rng.integers(0, len(ref) - L, size=8)
    reads = ref[starts[:, None] + np.arange(L)[None, :]].copy()
    idx = ReferenceIndex.build(ref, k=16)
    out = map_reads_stream(idx, reads)
    ok = out["pos"] >= 0
    assert ok.all()
    # unique reads: either no competitor found (vote MAPQ) or the
    # competitor's score gap is huge — confidence stays maximal
    assert (out["mapq"][ok] >= 50).all()


def test_cigar_stream_certified_and_traceback_tiers(tmp_path):
    """with_cigar=True streaming: exact reads and SNP-only reads take the
    certified-diagonal tier ("<L>M" without traceback, provably optimal
    because the diagonal score equals the verified global best); an
    indel read falls to the traceback tier; the SAM has no '*' CIGARs
    for mapped reads."""
    rng = np.random.default_rng(15)
    ref = rng.choice(BASES, size=50_000)
    idx = ReferenceIndex.build(ref, k=16)
    N, L = 48, 100
    starts = rng.integers(100, len(ref) - L - 100, size=N)
    reads = ref[starts[:, None] + np.arange(L)[None, :]].copy()
    # reads 0-15 exact; 16-31 get 2 interior SNPs; 32-47 get a 2bp
    # deletion (read skips 2 ref bases) -> traceback tier
    for i in range(16, 32):
        for p in (30, 61):
            reads[i, p] = BASES[(np.searchsorted(BASES, reads[i, p]) + 2) % 4]
    del_start = 50
    for i in range(32, 48):
        s = starts[i]
        seq = np.concatenate([ref[s: s + del_start],
                              ref[s + del_start + 2: s + L + 2]])
        reads[i] = seq
    out = map_reads_stream(idx, reads, with_cigar=True)
    assert (out["pos"] >= 0).all()
    for i in range(32):
        assert out["cigar"][i] == f"{L}M"
        assert out["offset"][i] == out["window_pad"]
    import re

    for i in range(32, 48):
        cig = out["cigar"][i]
        assert "D" in cig, f"read {i}: expected deletion, got {cig!r}"
        qlen = sum(int(n) for n, op in re.findall(r"(\d+)([MIS])", cig))
        assert qlen == L
        # the deletion shouldn't cost mapping confidence
        assert out["score"][i] >= 25 * L - 200
    # SAM emission: every mapped read carries a real CIGAR
    from mgl_tpu.io.sam import write_sam

    sam = tmp_path / "out.sam"
    write_sam(sam, idx, reads, out)
    body = [ln for ln in sam.read_text().splitlines()
            if not ln.startswith("@")]
    assert len(body) == N
    for ln in body:
        f = ln.split("\t")
        if int(f[1]) & 0x4 == 0:
            assert f[5] != "*"


def test_mapq_rescore_formula():
    from mgl_tpu.core.params import SWParameters

    p = SWParameters(25, -50, 110, 6)
    s1 = np.array([3200, 3200, 3200, 3200])
    s2 = np.array([3200, 3125, 2450, -(2**30)])   # 0, 1, 10 mismatches, none
    votes = np.array([8, 8, 8, 8])
    q = mapq_rescore(s1, s2, votes, p)
    assert q[0] == 0                      # exact repeat -> 0
    assert q[1] == 6                      # one substitution-equivalent
    assert q[2] == 60                     # clipped at 60
    # low absolute support halves confidence via the vote prior
    q_low = mapq_rescore(s1[2:3], s2[2:3], np.array([2]), p)
    assert q_low[0] == 30


def test_cigar_stream_reference_edge_reads():
    """Reads at the very start/end of the reference: their verify
    windows are edge-clipped, so the certified tier is skipped and the
    traceback tier must still produce correct CIGARs/offsets."""
    rng = np.random.default_rng(16)
    ref = rng.choice(BASES, size=30_000)
    idx = ReferenceIndex.build(ref, k=16)
    L = 100
    reads = np.stack([ref[:L], ref[len(ref) - L:], ref[5: 5 + L]])
    out = map_reads_stream(idx, reads, with_cigar=True)
    assert (out["pos"] >= 0).all()
    for i in range(3):
        assert out["cigar"][i], f"read {i} missing CIGAR"
        qlen = sum(int(n) for n, op in
                   __import__("re").findall(r"(\d+)([MIS])", out["cigar"][i]))
        assert qlen == L
    # effective positions recover the true placements
    eff = out["pos"] + np.where(out["offset"] >= 0, out["offset"],
                                out["window_pad"])
    assert eff[0] == 0 and eff[1] == len(ref) - L and eff[2] == 5
