"""Public API, mirroring the GATK native-binding surface.

Equivalents of the reference Java layer:

* :class:`SmithWatermanAligner` — MicrosoftSmithWaterman.align
  (MicrosoftSmithWaterman.java:66-86): (ref, alt, params, strategy) ->
  (cigar, offset), plus the batched entry point the reference lacks.
* :class:`PairHmmEngine` — MicrosoftPairHmm.{initialize,computeLikelihoods}
  (MicrosoftPairHmm.java:44-120): reads x haps -> log10 likelihood matrix
  with the float->double rescue cascade.

Inputs are validated here (the kernels assume non-empty sequences, as does
GATK's wrapper which pre-checks substrings).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from mgl_tpu.batch.bucketing import bucket_pairs
from mgl_tpu.core.params import OverhangStrategy, SWParameters
from mgl_tpu.ops import sw as sw_ops

__all__ = [
    "SWResult",
    "SmithWatermanAligner",
    "PairHmmEngine",
    "OverhangStrategy",
    "SWParameters",
]


@dataclasses.dataclass(frozen=True)
class SWResult:
    cigar: str
    offset: int


def _as_u8(seq) -> np.ndarray:
    if isinstance(seq, np.ndarray):
        a = seq.astype(np.uint8)
    else:
        a = np.frombuffer(bytes(seq), dtype=np.uint8)
    if a.size == 0:
        raise ValueError("empty sequence")
    return a


def _norm_bases(a: np.ndarray) -> np.ndarray:
    # canonical alphabet lives with the engine (ops/pairhmm.BASE_NORM) so
    # direct compute_likelihoods callers get the same normalization
    from mgl_tpu.ops.pairhmm import BASE_NORM

    return BASE_NORM[a]


class SmithWatermanAligner:
    """Batched affine-gap SW aligner with exact reference CIGAR parity.

    Every bucket runs the plain forward pass with traceback
    (ops/sw.align_batch) and the host CIGAR decode: GATK's per-region
    calls are small, and no traceback kernel has been written for the
    GPU.  ``impl`` ('auto', 'pallas' or 'xla') is accepted for symmetry
    with the other entry points and validated.
    """

    def __init__(self, max_batch: int = 2048, impl: str = "auto"):
        from mgl_tpu.core.backend import check_impl

        self.max_batch = max_batch
        self.impl = check_impl(impl)

    def align(self, ref, alt, params: SWParameters,
              strategy: OverhangStrategy) -> SWResult:
        """Single-pair alignment (MicrosoftSmithWaterman.java:66-86 shape)."""
        return self.align_batch([ref], [alt], params, strategy)[0]

    def align_batch(self, refs, alts, params: SWParameters,
                    strategy: OverhangStrategy) -> list[SWResult]:
        refs = [_as_u8(r) for r in refs]
        alts = [_as_u8(a) for a in alts]
        if len(refs) != len(alts):
            raise ValueError("refs and alts must have equal length")
        from mgl_tpu.utils import debug_check
        from mgl_tpu.utils.logging import get_logger
        from mgl_tpu.utils.metrics import METRICS

        results: list[SWResult | None] = [None] * len(refs)
        buckets = bucket_pairs([len(r) for r in refs], [len(a) for a in alts],
                               max_batch=self.max_batch)
        METRICS.count("sw.pairs", len(refs))
        METRICS.count("sw.buckets", len(buckets))
        log = get_logger("engine")
        with METRICS.timer("sw.align_batch"):
            for (pt, pq), idxs in buckets:
                log.debug("sw bucket (%d, %d) x%d", pt, pq, len(idxs))
                got = sw_ops.align_batch(
                    [refs[i].tobytes() for i in idxs],
                    [alts[i].tobytes() for i in idxs],
                    params, strategy, pad_to=(pt, pq),
                )
                for i, (cig, off) in zip(idxs, got):
                    results[i] = SWResult(cig, off)
        if debug_check.enabled():
            debug_check.check_sw_results(
                [r.tobytes() for r in refs], [a.tobytes() for a in alts],
                params, strategy, results)
        return results  # type: ignore[return-value]


class PairHmmEngine:
    """PairHMM likelihood engine with the reference's precision cascade.

    ``fast_path`` enables the seed-extend tier-0 estimator (the reference
    ships it dormant; different numbers for well-matching pairs).
    """

    def __init__(self, use_double: bool = False, fast_path: bool = False,
                 impl: str = "auto"):
        from mgl_tpu.core.backend import check_impl

        self.use_double = use_double
        self.fast_path = fast_path
        self.impl = check_impl(impl)

    def compute_likelihoods(self, reads: list[dict], haps: list) -> np.ndarray:
        """reads: dicts with keys bases/q/i/d/c (uint8 arrays or bytes);
        haps: list of uint8 arrays or bytes.  Returns (R, H) float64 log10
        likelihood matrix (MicrosoftPairHmm.java:104-111 layout)."""
        from mgl_tpu.ops.pairhmm import compute_likelihoods

        norm_reads = []
        for rd in reads:
            bases = _norm_bases(_as_u8(rd["bases"]))
            n = len(bases)
            r = {"bases": bases}
            for k in ("q", "i", "d", "c"):
                a = np.asarray(rd[k], dtype=np.uint8)
                if a.shape != (n,):
                    raise ValueError(f"quality track '{k}' length {a.shape} != read length {n}")
                r[k] = a
            norm_reads.append(r)
        norm_haps = [_norm_bases(_as_u8(h)) for h in haps]
        return compute_likelihoods(norm_reads, norm_haps, self.use_double,
                                   use_fast_path=self.fast_path,
                                   impl=self.impl)

    def compute_likelihoods_stream(self, batches, depth: int = 2):
        """Pipelined likelihoods over a stream of (reads, haps) batches —
        GATK's actual call pattern (one computeLikelihoods per assembly
        region, thousands of regions per run).

        Here batch k+1's host packing and f32 dispatch run while the
        device still works on batch k (JAX dispatch is asynchronous), the
        batch-granular analogue of the reference's TBB parallel_for over
        reads within one call
        (com_microsoft_mgl_pairhmm_MicrosoftPairHmm.cc:131).  Yields
        (R, H) matrices in input order, bit-identical to sequential
        calls.
        """
        import collections

        depth = max(depth, 1)
        # three-stage pipeline: [dispatch f32] -> [fetch f32 + rescue]
        # -> [emit]; each stage runs one batch behind the previous, so
        # the device queue stays full while the host packs
        s1: collections.deque = collections.deque()
        s2: collections.deque = collections.deque()
        for reads, haps in batches:
            s1.append(self._dispatch(reads, haps))
            if len(s1) > depth:
                s2.append(s1.popleft()())
            if len(s2) > 1:
                yield s2.popleft()()
        while s1:
            s2.append(s1.popleft()())
            if len(s2) > 1:
                yield s2.popleft()()
        while s2:
            yield s2.popleft()()

    def _dispatch(self, reads: list[dict], haps: list):
        from mgl_tpu.ops.pairhmm import dispatch_likelihoods

        norm_reads = []
        for rd in reads:
            bases = _norm_bases(_as_u8(rd["bases"]))
            n = len(bases)
            r = {"bases": bases}
            for k in ("q", "i", "d", "c"):
                a = np.asarray(rd[k], dtype=np.uint8)
                if a.shape != (n,):
                    raise ValueError(
                        f"quality track '{k}' length {a.shape} != read "
                        f"length {n}")
                r[k] = a
            norm_reads.append(r)
        norm_haps = [_norm_bases(_as_u8(h)) for h in haps]
        return dispatch_likelihoods(norm_reads, norm_haps, self.use_double,
                                    use_fast_path=self.fast_path,
                                    impl=self.impl)

    def done(self) -> None:  # parity with PairHMMNativeBinding.done()
        pass
