"""Package CLI entry points (installed as console scripts).

`mgl-map`: reference FASTA + reads FASTQ -> coordinate-sorted SAM — the
whole framework as one command (index -> two-strand seed -> exact tier ->
device SW verify -> coordinate sort -> SAM).  tools/mgl_map.py is the
in-repo shim for running from a checkout.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def map_main():

    ap = argparse.ArgumentParser()
    ap.add_argument("ref_fa")
    ap.add_argument("reads_fq")
    ap.add_argument("out_sam")
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--cigar", action="store_true",
                    help="emit real CIGARs (certified-diagonal tier + "
                         "traceback for indel/edge reads) instead "
                         "of score-only verification")
    ap.add_argument("--max-reads", type=int, default=None)
    args = ap.parse_args()

    from mgl_tpu.core.backend import enable_compile_cache
    from mgl_tpu.io.fasta import read_fasta, read_fastq
    from mgl_tpu.io.sam import write_sam
    from mgl_tpu.pipelines.align_sort import align_and_sort
    from mgl_tpu.pipelines.mapper import ReferenceIndex, map_reads_stream

    enable_compile_cache()
    contigs = list(read_fasta(args.ref_fa).items())
    total_bp = sum(len(s) for _, s in contigs)
    print(f"reference: {len(contigs)} contig(s), {total_bp/1e6:.1f} Mbp",
          flush=True)
    t0 = time.time()
    if len(contigs) == 1:
        index = ReferenceIndex.build(contigs[0][1], k=args.k)
        index.contig_names = [contigs[0][0]]
        index.contig_offsets = np.array([0], np.int64)
        index.contig_lengths = np.array([len(contigs[0][1])], np.int64)
    else:
        index = ReferenceIndex.build_multi(contigs, k=args.k)
    print(f"index built in {time.time()-t0:.1f}s", flush=True)

    names, bases, quals = [], [], []
    for name, b, q in read_fastq(args.reads_fq, max_reads=args.max_reads):
        names.append(name)
        bases.append(b)
        quals.append(q)
    if not names:
        sys.exit("no reads")
    lens = np.array([len(b) for b in bases])
    L = int(np.bincount(lens).argmax())
    reads = np.zeros((len(bases), L), np.uint8)
    qmat = np.zeros((len(bases), L), np.uint8)
    for i, (b, q) in enumerate(zip(bases, quals)):
        m = min(len(b), L)
        reads[i, :m] = b[:m]
        qmat[i, :m] = q[:m]
    print(f"{len(reads)} reads @ {L} bp", flush=True)

    t0 = time.time()
    if args.cigar:
        res = map_reads_stream(index, reads, with_cigar=True)
        order = None
    else:
        res = align_and_sort(index, reads)
        order = res["order"]
    dt = time.time() - t0
    mapped = (res["pos"] >= 0).mean()
    print(f"mapped {mapped:.1%} at {len(reads)/dt:.0f} reads/s", flush=True)

    n = write_sam(args.out_sam, index, reads, res, quals=qmat, names=names)
    print(f"wrote {n} records to {args.out_sam}")



if __name__ == "__main__":
    map_main()
