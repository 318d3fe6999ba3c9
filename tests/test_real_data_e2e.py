"""Real-data end-to-end: the reference's HiSeq BAM fixture through
iter_bam -> mapper -> SAM and through PairHmmEngine with BAM-derived
quality tracks (VERDICT r2 item 8; SURVEY.md §4 notes the reference
ships this fixture but never exercises it).

No reference FASTA ships with the fixture, so the test reconstructs the
~30 kb chr1 region from the BAM's own alignments (majority-vote consensus
over CIGAR M runs at ~5.6x coverage) and closes the loop against it:
reads must map back to where the BAM says they belong.
"""

import pathlib
import re

import numpy as np
import pytest

REF_BAM = pathlib.Path(
    "/root/reference/src/test/resources/HiSeq.1mb.1RG.2k_lines.bam")

pytestmark = pytest.mark.skipif(not REF_BAM.exists(),
                                reason="reference fixture absent")


_CIG = re.compile(r"(\d+)([MIDNSHP=X])")


@pytest.fixture(scope="module")
def hiseq():
    """(records, consensus, base) — consensus[i] is the majority base at
    chr1 position base+i ('N' where uncovered)."""
    from mgl_tpu.io.bam import iter_bam
    from mgl_tpu.pipelines.mapper import _CODE

    recs = []
    for hdr, rec in iter_bam(REF_BAM):
        if hdr is None and len(rec["bases"]) == 101:
            recs.append(rec)
    lo = min(r["pos"] for r in recs) - 100
    hi = max(r["pos"] for r in recs) + 300
    counts = np.zeros((hi - lo, 4), np.int32)
    for r in recs:
        rp, qp = r["pos"] - lo, 0
        bases = np.asarray(r["bases"], np.uint8)
        for n, op in _CIG.findall(r["cigar"]):
            n = int(n)
            if op in "M=X":
                code = _CODE[bases[qp: qp + n]]
                ok = code < 4
                idx = rp + np.arange(n)
                np.add.at(counts, (idx[ok], code[ok]), 1)
                rp += n
                qp += n
            elif op in "DN":
                rp += n
            elif op in "IS":
                qp += n
    cons = np.full(hi - lo, ord("N"), np.uint8)
    covered = counts.sum(1) > 0
    cons[covered] = np.frombuffer(b"ACGT", np.uint8)[
        counts.argmax(1)[covered]]
    return recs, cons, lo


def test_hiseq_reads_map_back_to_bam_positions(hiseq, tmp_path):
    from mgl_tpu.io.sam import write_sam
    from mgl_tpu.pipelines.mapper import ReferenceIndex, map_reads_stream

    recs, cons, base = hiseq
    idx = ReferenceIndex.build(cons, k=16)
    reads = np.stack([np.asarray(r["bases"], np.uint8) for r in recs])
    out = map_reads_stream(idx, reads)

    mapped = out["pos"] >= 0
    assert mapped.mean() > 0.75, f"mapped only {mapped.mean():.2%}"
    # mapped reads land where the BAM put them (verify window must
    # contain the BAM's own alignment start)
    bam_pos = np.array([r["pos"] - base for r in recs])
    wlen = reads.shape[1] + 2 * out["window_pad"]
    inside = (bam_pos >= out["pos"] - 8) & \
             (bam_pos <= out["pos"] + wlen - reads.shape[1] + 8)
    agree = inside[mapped].mean()
    # disagreements concentrate on reads BOTH aligners call ambiguous
    # (repeats: BAM MAPQ median ~29, our seed votes median 3), so overall
    # agreement is bounded by the data, not the mapper
    assert agree > 0.90, f"only {agree:.2%} agree with BAM positions"
    bam_mapq = np.array([r["mapq"] for r in recs])
    conf = mapped & (out["mapq"] >= 20) & (bam_mapq >= 40)
    assert conf.sum() > 1000
    agree_conf = inside[conf].mean()
    assert agree_conf > 0.97, \
        f"confident calls agree only {agree_conf:.2%}"
    # strand recovery: BAM flag 0x10 marks reverse reads, but BAM stores
    # SEQ already reference-oriented, so re-mapping should call them
    # FORWARD against the consensus
    assert (out["strand"][mapped] == 0).mean() > 0.95

    # CIGAR mode on a slice: certified tier + traceback tier on real reads
    sub = slice(0, 192)
    outc = map_reads_stream(idx, reads[sub], with_cigar=True)
    m = outc["pos"] >= 0
    assert m.mean() > 0.7
    for i in np.nonzero(m)[0]:
        cig = outc["cigar"][i]
        assert cig, "mapped read without CIGAR"
        qlen = sum(int(n) for n, op in _CIG.findall(cig) if op in "MIS=X")
        assert qlen == reads.shape[1]

    # SAM out with real names/quals: no '*' CIGAR for mapped records
    quals = np.stack([np.asarray(r["quals"], np.uint8) for r in recs[sub]])
    names = [r["name"] for r in recs[sub]]
    sam = tmp_path / "hiseq_remap.sam"
    nrec = write_sam(sam, idx, reads[sub], outc, quals=quals, names=names)
    assert nrec == 192
    for ln in sam.read_text().splitlines():
        if ln.startswith("@"):
            continue
        f = ln.split("\t")
        assert len(f) == 11
        if int(f[1]) & 0x4 == 0:
            assert f[5] != "*"
            assert f[10] != "*" and len(f[10]) == len(f[9])


def test_hiseq_reads_pairhmm_with_bam_qualities(hiseq):
    """Likelihoods of real reads vs their own consensus haplotype window
    (BAM-derived base qualities) beat a decoy window, and the full
    engine cascade stays finite — likelihood sanity on real data."""
    from mgl_tpu.api import PairHmmEngine

    recs, cons, base = hiseq
    rng = np.random.default_rng(0)
    picks = [r for r in recs
             if (cons[r["pos"] - base: r["pos"] - base + 130] != ord("N"))
             .all()][:24]
    assert len(picks) >= 16
    reads, haps = [], []
    for r in picks:
        n = len(r["bases"])
        reads.append(dict(
            bases=np.asarray(r["bases"], np.uint8),
            q=np.clip(np.asarray(r["quals"], np.uint8), 6, 64),
            i=np.full(n, 45, np.uint8), d=np.full(n, 45, np.uint8),
            c=np.full(n, 10, np.uint8)))
        s = r["pos"] - base - 10
        haps.append(cons[max(s, 0): max(s, 0) + 130].copy())
    decoy = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=130)
    out = PairHmmEngine().compute_likelihoods(reads, haps + [decoy])
    assert np.all(np.isfinite(out))
    own = np.diag(out[:, : len(picks)])
    assert (own > out[:, -1] + 1.0).mean() > 0.9, \
        "own-window likelihood should dominate the decoy"
    # log10-likelihood of a ~Q30 101bp read vs its own window should be
    # no worse than a handful of mismatches' worth
    assert (own > -30).mean() > 0.9
