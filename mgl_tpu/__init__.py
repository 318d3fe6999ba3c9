"""mgl-tpu: genomics kernel engine on JAX.

A from-scratch rebuild of microsoft/mgl's capabilities (GATK's banded
Smith-Waterman and PairHMM cores) as JAX programs and Pallas kernels for
the GPU, with batching, read mapping, multi-device scaling, and global
sorting on top.

Primary entry points:

    from mgl_tpu.api import SmithWatermanAligner, PairHmmEngine
    from mgl_tpu.pipelines.mapper import ReferenceIndex, map_reads
    from mgl_tpu.pipelines.align_sort import align_and_sort
    from mgl_tpu.io import read_fasta, read_fastq, read_bam

See docs/DESIGN.md for architecture, docs/COVERAGE.md for the component
map vs the reference, docs/PARITY_NOTES.md for the behavioral contract.
"""

__version__ = "0.1.0"
