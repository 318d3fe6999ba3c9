"""Bring-up timings on the GPU through the public entry points.

Times each path twice, once with the hand-written GPU kernels
(``impl="pallas"``) and once with the plain JAX path (``impl="xla"``),
at the widths the first benchmark will use, and prints one JSON line with
the device beside every number.  These are not benchmark cells: the
cells, their bounds and BENCHMARK.json come later.

    python bench.py            # on a machine with a GPU; fails without one

Every timed call returns host results (numpy), so the host clock around it
covers dispatch, device time and the fetch.  Each shape is run once
untimed first (compilation is set-up), then the best of ``REPEATS`` runs
is kept.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

REPEATS = 3
SW = (25, -50, 110, 6)


def device_info() -> dict:
    """Platform, kind and count as JAX reports them, plus the card's name
    and power limit; exits when the default device is not a GPU."""
    import jax

    d = jax.devices()[0]
    if d.platform != "gpu":
        sys.exit(f"no GPU: JAX's default device is {d.platform!r}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices()),
            "nvidia_smi": smi.stdout.strip().splitlines()[:1]}


def best_of(fn, repeats: int = REPEATS) -> tuple[float, float, object]:
    """(first-call seconds, best steady seconds, last result)."""
    t0 = time.perf_counter()
    out = fn()
    first = time.perf_counter() - t0
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn()
        best = min(best, time.perf_counter() - t0)
    return first, best, out


def sw_windows(n: int, T: int = 198, Q: int = 150, seed: int = 0):
    """(n, T) reference windows and (n, Q) reads drawn from their middle
    with 3% substitutions: the mapper's verify shape at the defaults
    (reads at offset 24 of a 198-base window)."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGT", np.uint8)
    win = alpha[rng.integers(0, 4, (n, T))]
    off = (T - Q) // 2
    reads = win[:, off: off + Q].copy()
    mut = rng.random(reads.shape) < 0.03
    reads[mut] = alpha[rng.integers(0, 4, int(mut.sum()))]
    return win, reads


def engine_fixture(n_reads=512, n_haps=12, rdlen=151, haplen=420, seed=7):
    """GATK-region-shaped batch: haplotypes that differ by single
    substitutions, reads drawn from them, and a 1/16 tail of unrelated
    high-quality reads that underflow f32 and ride the rescue tier."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    base = rng.choice(acgt, haplen)
    haps = [base.copy()]
    for p in sorted(int(x) for x in
                    rng.integers(haplen // 3, haplen - 10, n_haps - 1)):
        h = haps[-1].copy()
        h[p] = acgt[(int(np.searchsorted(acgt, h[p])) + 1) % 4]
        haps.append(h)
    reads = []
    for k in range(n_reads):
        st = int(rng.integers(0, haplen - rdlen))
        b = base[st: st + rdlen].copy()
        if k % 16 == 0:
            b = rng.choice(acgt, rdlen)
            q = rng.integers(45, 60, rdlen).astype(np.uint8)
        else:
            b[rng.integers(0, rdlen)] = acgt[rng.integers(0, 4)]
            q = rng.integers(15, 45, rdlen).astype(np.uint8)
        reads.append(dict(bases=b, q=q, i=q, d=q,
                          c=np.full(rdlen, 10, np.uint8)))
    return reads, haps


def pairhmm_product(n_reads=2048, n_haps=16, rdlen=150, haplen=400, seed=3):
    """n_reads x n_haps = 32,768 pairs at 150 x 400: haplotypes that differ
    from one base haplotype by 4 substitutions each (an assembly region's
    candidates), reads drawn from them with 2% substitutions, so every
    pair's score stays in f32 range and no pair takes the rescue tier."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    base = acgt[rng.integers(0, 4, haplen)]
    haps = []
    for _ in range(n_haps):
        h = base.copy()
        h[rng.integers(0, haplen, 4)] = acgt[rng.integers(0, 4, 4)]
        haps.append(h)
    reads = []
    for k in range(n_reads):
        st = int(rng.integers(0, haplen - rdlen))
        b = haps[k % n_haps][st: st + rdlen].copy()
        mut = rng.random(rdlen) < 0.02
        b[mut] = acgt[rng.integers(0, 4, int(mut.sum()))]
        q = rng.integers(20, 41, rdlen).astype(np.uint8)
        reads.append(dict(bases=b, q=q, i=np.full(rdlen, 45, np.uint8),
                          d=np.full(rdlen, 45, np.uint8),
                          c=np.full(rdlen, 10, np.uint8)))
    return reads, haps


def bench_sw_scores(impl: str, n: int = 131072) -> dict:
    from mgl_tpu.core.params import SWParameters
    from mgl_tpu.pipelines.mapper import sw_score_batch

    win, reads = sw_windows(n)
    first, best, _ = best_of(
        lambda: sw_score_batch(win, reads, SWParameters(*SW), impl=impl))
    cells = n * win.shape[1] * reads.shape[1]
    return {"pairs": n, "shape": list(win.shape[1:]) + [reads.shape[1]],
            "first_s": first, "s": best, "gcups": cells / best / 1e9}


def bench_engine(impl: str) -> dict:
    from mgl_tpu.api import PairHmmEngine

    eng = PairHmmEngine(impl=impl)
    reads, haps = pairhmm_product()
    first, best, _ = best_of(lambda: eng.compute_likelihoods(reads, haps))
    cells = len(reads) * len(haps) * 150 * 400
    out = {"product": {"pairs": len(reads) * len(haps), "first_s": first,
                       "s": best, "gcups": cells / best / 1e9}}
    reads, haps = engine_fixture()
    first, best, _ = best_of(lambda: eng.compute_likelihoods(reads, haps))
    out["region"] = {"pairs": len(reads) * len(haps), "first_s": first,
                     "s": best, "pairs_per_s": len(reads) * len(haps) / best}
    regions = [engine_fixture(seed=7 + k) for k in range(8)]
    first, best, _ = best_of(
        lambda: list(eng.compute_likelihoods_stream(iter(regions))))
    n = sum(len(r) * len(h) for r, h in regions)
    out["region_stream"] = {"regions": 8, "pairs": n, "first_s": first,
                            "s": best, "pairs_per_s": n / best}
    return out


def bench_mapper(impl: str, index, reads) -> dict:
    from mgl_tpu.pipelines.mapper import map_reads_stream
    from mgl_tpu.utils.metrics import METRICS

    out = {}
    for mode, cigar in (("score", False), ("cigar", True)):
        METRICS.reset()
        first, best, _ = best_of(
            lambda: map_reads_stream(index, reads, with_cigar=cigar,
                                     impl=impl), repeats=2)
        out[mode] = {"reads": len(reads), "first_s": first, "s": best,
                     "reads_per_s": len(reads) / best,
                     "tb_reads": int(METRICS.counters.get("map.tb_reads",
                                                          0)) // 3}
    return out


def bench_aligner(n: int = 2048) -> dict:
    from mgl_tpu.api import SmithWatermanAligner
    from mgl_tpu.core.params import OverhangStrategy, SWParameters

    win, reads = sw_windows(n, T=150, Q=150, seed=1)
    al = SmithWatermanAligner()
    first, best, _ = best_of(lambda: al.align_batch(
        list(win), list(reads), SWParameters(*SW), OverhangStrategy.SOFTCLIP))
    return {"pairs": n, "shape": [150, 150], "first_s": first, "s": best,
            "pairs_per_s": n / best}


def bench_sort(n: int = 10_000_000) -> dict:
    from mgl_tpu.parallel.sort import sort_records_single

    rng = np.random.default_rng(1)
    keys = rng.integers(0, 1 << 62, n).astype(np.uint64)
    vals = np.arange(n, dtype=np.int32)
    first, best, _ = best_of(lambda: sort_records_single(keys, vals))
    return {"keys": n, "first_s": first, "s": best,
            "mkeys_per_s": n / best / 1e6}


def main():
    import pathlib

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
    from mgl_tpu.core.backend import enable_compile_cache

    dev = device_info()
    enable_compile_cache()
    from mgl_tpu.pipelines.mapper import ReferenceIndex
    from tools.run_scale_configs import simulate_cigar

    ref, reads, _, _ = simulate_cigar(np.random.default_rng(4), 64_000_000,
                                      262_144)
    index = ReferenceIndex.build(ref, k=16)
    res = {"device": dev}
    for impl in ("pallas", "xla"):
        res[impl] = {"sw_scores": bench_sw_scores(impl),
                     "engine": bench_engine(impl),
                     "mapper": bench_mapper(impl, index, reads)}
        print(json.dumps({impl: res[impl]}), file=sys.stderr, flush=True)
    res["aligner"] = bench_aligner()
    res["sort"] = bench_sort()
    print(json.dumps(res))


if __name__ == "__main__":
    main()
