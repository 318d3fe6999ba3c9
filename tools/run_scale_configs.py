"""Scale runs for BASELINE.json configs 4 and 5.

Config 4 — seed-extend alignment of 1M simulated 150 bp reads against a
chr20-scale (64 Mbp) simulated reference, chunked through the device SW
verify stage.  Reports reads/s on this device and mapping accuracy against
the simulation truth (the per-host work unit of the data-parallel design:
each host runs exactly this loop on its shard with a replicated index).

Config 5 — global coordinate sort: the 1M mapped reads end-to-end, plus
sort-throughput scaling at 10M keys on one device and a 10M-key 8-way
virtual-mesh bitonic shard-merge (correctness + host-equivalence), the
N>=2-host path without multi-host hardware.

Usage:  python tools/run_scale_configs.py [--reads N] [--ref-mbp M]
            [--out report.json]
Prints a JSON report; with --out, also merges it into that file.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def simulate(rng, ref_len: int, n_reads: int, read_len: int,
             err: float = 0.01):
    alpha = np.frombuffer(b"ACGT", np.uint8)
    # uint8 index draw + table take: rng.choice materializes int64
    # indices (8 B/bp — 25 GB at genome scale); this stays at 2 B/bp peak
    ref = alpha[rng.integers(0, 4, size=ref_len, dtype=np.uint8)]
    true_pos = rng.integers(0, ref_len - read_len, size=n_reads)
    reads = ref[true_pos[:, None] + np.arange(read_len)[None, :]].copy()
    mut = rng.random(reads.shape) < err
    reads[mut] = alpha[(np.searchsorted(alpha, reads[mut]) +
                        rng.integers(1, 4, int(mut.sum()))) % 4]
    return ref, reads, true_pos


def simulate_cigar(rng, ref_len: int, n_reads: int, read_len: int = 150,
                   indel_frac: float = 0.02, err: float = 0.01,
                   max_indel: int = 2):
    """simulate() plus a deletion of 1..max_indel bp in the first
    ``indel_frac`` of the reads, so the traceback tier is exercised like
    real indel reads.  Returns (ref, reads, true_pos, n_indel_reads)."""
    ref, reads, true_pos = simulate(rng, ref_len, n_reads, read_len,
                                    err=err)
    n_ind = int(n_reads * indel_frac)
    dlen = rng.integers(1, max_indel + 1, n_ind)
    for i in range(n_ind):
        d = int(dlen[i])
        # clamp so the deleted read's reference footprint (read_len + d)
        # stays inside the reference
        s = min(int(true_pos[i]), ref_len - read_len - d)
        true_pos[i] = s
        reads[i] = np.concatenate([ref[s: s + 70],
                                   ref[s + 70 + d: s + read_len + d]])
    return ref, reads, true_pos, n_ind


def config4(n_reads: int, ref_len: int, chunk: int = 131072,
            read_len: int = 150, seed: int = 0, passes: int = 3):
    from mgl_tpu.pipelines.mapper import ReferenceIndex, map_reads_stream

    rng = np.random.default_rng(seed)
    print(f"simulating ref {ref_len/1e6:.0f} Mbp + {n_reads} reads ...",
          flush=True)
    ref, reads, true_pos = simulate(rng, ref_len, n_reads, read_len)

    t0 = time.time()
    index = ReferenceIndex.build(ref, k=16)
    t_index = time.time() - t0
    print(f"index build: {t_index:.1f}s ({len(index.sorted_kmers)} kmers)",
          flush=True)

    # warm the compiled shapes on the first chunk, then stream with
    # host/device overlap; several full passes — the median is the
    # headline, the trials stay in the report so variance is visible
    from mgl_tpu.utils.metrics import METRICS

    t_warm = time.time()
    map_reads_stream(index, reads[:chunk], chunk=chunk)
    t_warm = time.time() - t_warm
    trials, all_stages = [], []
    for p in range(max(passes, 1)):
        METRICS.reset()
        t0 = time.time()
        out = map_reads_stream(index, reads, chunk=chunk)
        t_map = time.time() - t0
        trials.append(round(n_reads / t_map, 1))
        stages = {k.split(".", 1)[1]: round(v, 2)
                  for k, v in METRICS.snapshot()["timers_s"].items()
                  if k.startswith("map.")}
        # host stage time that overlaps async device work: dispatch is
        # async, sync blocks on the device, seed/host_tier run while the
        # device verifies the previous chunk
        stages["host_while_device_busy"] = round(
            stages.get("seed", 0) + stages.get("host_tier", 0), 2)
        all_stages.append(stages)
        print(f"  pass {p}: mapped {n_reads} in {t_map:.1f}s "
              f"({n_reads/t_map:.0f} reads/s) stages={stages}", flush=True)
    med = float(np.median(trials))
    # stage breakdown of the median pass
    stages = all_stages[int(np.argsort(trials)[len(trials) // 2])]
    t_map = n_reads / med

    pos, score = out["pos"], out["score"]
    mapped = pos >= 0
    # window start is fuzzy by design (diagonal bin + pad); correct if the
    # true read start lies inside the verified window
    window = read_len + 2 * 24
    ok = mapped & (true_pos >= pos) & (true_pos <= pos + window - read_len)
    import resource

    return {
        "n_reads": int(n_reads),
        "ref_mbp": ref_len / 1e6,
        "index_build_s": round(t_index, 2),
        "map_s": round(t_map, 2),
        "reads_per_s": round(med, 1),
        "trials_reads_per_s": trials,
        "warmup_s": round(t_warm, 2),
        "mapped_frac": round(float(mapped.mean()), 4),
        "window_accuracy": round(float(ok.sum() / max(mapped.sum(), 1)), 4),
        "max_rss_gb": round(
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20, 2),
        "stage_s": stages,
    }, pos, score


def config4_cigar(n_reads: int = 262_144, ref_len: int = 64_000_000,
                  chunk: int = 131072, read_len: int = 150,
                  indel_frac: float = 0.02, err: float = 0.01,
                  max_indel: int = 2, seed: int = 4):
    """Full-CIGAR mapping at scale: every mapped read gets a real CIGAR
    (certified-diagonal tier for exact/SNP reads, banded traceback for
    the rest); measures reads/s and the tier split.  ``err``/``max_indel``
    sweep the error model: higher error rates shrink the certified tier
    (a gapped path beats the diagonal more often) and grow the traceback
    share, bounding the certified-tier claim with data."""
    from mgl_tpu.pipelines.mapper import ReferenceIndex, map_reads_stream
    from mgl_tpu.utils.metrics import METRICS

    rng = np.random.default_rng(seed)
    print(f"[cigar] simulating ref {ref_len/1e6:.0f} Mbp + {n_reads} reads"
          f" (err={err}, indel_frac={indel_frac}, max_indel={max_indel})",
          flush=True)
    ref, reads, true_pos, n_ind = simulate_cigar(
        rng, ref_len, n_reads, read_len, indel_frac, err, max_indel)
    index = ReferenceIndex.build(ref, k=16)
    map_reads_stream(index, reads[:chunk], chunk=chunk,
                     with_cigar=True)              # warm compiles
    METRICS.reset()
    t0 = time.time()
    out = map_reads_stream(index, reads, chunk=chunk, with_cigar=True)
    t_map = time.time() - t0
    mapped = out["pos"] >= 0
    have_cigar = np.array([bool(c) for c in out["cigar"]])
    n_tb = int(METRICS.counters.get("map.tb_reads", 0))
    tb_s = METRICS.timers.get("map.traceback", 0.0)
    assert (have_cigar[mapped]).all(), "mapped read without CIGAR"
    with_d = sum("D" in out["cigar"][i] or "I" in out["cigar"][i]
                 for i in range(n_ind) if mapped[i])
    n_mapped = int(mapped.sum())
    return {
        "n_reads": int(n_reads),
        "err": err,
        "max_indel": int(max_indel),
        "map_cigar_s": round(t_map, 2),
        "reads_per_s": round(n_reads / t_map, 1),
        "mapped_frac": round(float(mapped.mean()), 4),
        "cigar_complete": True,
        "indel_reads": int(n_ind),
        "indel_cigars_with_gap": int(with_d),
        "traceback_tier_reads": n_tb,
        "traceback_tier_share": round(n_tb / max(n_mapped, 1), 4),
        "traceback_tier_s": round(tb_s, 2),
    }


def config5(pos: np.ndarray, score: np.ndarray, n_sort: int = 10_000_000):
    import jax

    from mgl_tpu.parallel.sort import (join_u64, sort_records,
                                       sort_records_single, split_u64)
    from mgl_tpu.pipelines.align_sort import coordinate_keys

    n = len(pos)
    keys = coordinate_keys(np.zeros(n), pos, np.arange(n) & 0xFFFF)
    vals = np.arange(n, dtype=np.int32)

    # end-to-end: sort the real mapped coordinates on device; first call
    # includes compile, second shows the warmed-cache steady state
    t0 = time.time()
    skeys, order = sort_records_single(keys, vals)
    t_e2e = time.time() - t0
    t0 = time.time()
    skeys, order = sort_records_single(keys, vals)
    t_e2e_warm = time.time() - t0
    assert np.all(skeys[1:] >= skeys[:-1])
    assert np.array_equal(np.sort(keys), skeys)

    # scaling: 10M synthetic coordinate keys, one device, device-resident
    # (host<->device transfer excluded: a production pipeline keeps keys
    # on device)
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    big = ((rng.integers(0, 24, n_sort).astype(np.uint64) << np.uint64(48))
           | (rng.integers(0, 1 << 26, n_sort).astype(np.uint64) << np.uint64(16))
           | (np.arange(n_sort, dtype=np.uint64) & np.uint64(0xFFFF)))
    bvals = np.arange(n_sort, dtype=np.int32)
    hi, lo = split_u64(big)
    dsort = jax.jit(lambda h, l, v: jax.lax.sort((h, l, v), num_keys=2))
    dh, dl, dv = (jnp.asarray(a) for a in (hi, lo, bvals))
    t0 = time.time()
    out = dsort(dh, dl, dv)
    jax.block_until_ready(out)
    t_10m_first = time.time() - t0
    t0 = time.time()
    for _ in range(4):
        out = dsort(dh, dl, dv)
    jax.block_until_ready(out)
    t_10m = (time.time() - t0) / 4
    sbig = join_u64(np.asarray(out[0]), np.asarray(out[1]))
    assert np.all(sbig[1:] >= sbig[:-1])
    assert np.array_equal(sbig, np.sort(big))

    return {
        "e2e_reads": int(n),
        "e2e_sort_s": round(t_e2e, 3),
        "e2e_sort_warm_s": round(t_e2e_warm, 3),
        "note": "e2e_sort_s is cold-compile-dominated (first XLA sort "
                "compile at this shape); compare e2e_sort_warm_s run-to-run",
        "sort_10m_device_s": round(t_10m, 4),
        "sort_10m_first_call_s": round(t_10m_first, 3),
        "sort_10m_mkeys_per_s": round(n_sort / t_10m / 1e6, 1),
    }


def config5_mesh(n_sort: int = 10_000_000):
    """8-way distributed shard-merge sort at 10M keys (virtual CPU mesh)."""
    from mgl_tpu.parallel.mesh import make_mesh
    from mgl_tpu.parallel.sort import sort_records

    rng = np.random.default_rng(2)
    keys = rng.integers(0, 1 << 62, n_sort).astype(np.uint64)
    vals = np.arange(n_sort, dtype=np.int32)
    mesh = make_mesh(8, 1)
    t0 = time.time()
    skeys, svals = sort_records(keys, vals, mesh, "dp")
    t = time.time() - t0
    assert np.array_equal(skeys, np.sort(keys)), "mesh sort != host sort"
    assert np.array_equal(keys[svals], skeys), "payload permutation broken"
    return {"mesh_sort_10m_devices": 8, "mesh_sort_10m_s": round(t, 3),
            "mesh_sort_verified": True}


def _device() -> dict:
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def _write_report(rep: dict, out: str | None) -> None:
    if out is None:
        return
    path = pathlib.Path(out)
    if path.exists():
        old = json.loads(path.read_text())
        old.update(rep)
        rep = old
    path.write_text(json.dumps(rep, indent=1))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=1_048_576)
    ap.add_argument("--ref-mbp", type=float, default=64.0)
    ap.add_argument("--sort-keys", type=int, default=10_000_000)
    ap.add_argument("--mesh-only", action="store_true",
                    help="run only the virtual-mesh distributed sort")
    ap.add_argument("--sort-only", action="store_true",
                    help="rerun only config 5 with synthetic positions")
    ap.add_argument("--big", action="store_true",
                    help="run only the 512 Mbp reference config "
                         "(the BASELINE config-4 genome-scale step)")
    ap.add_argument("--big-mbp", type=float, default=512.0,
                    help="reference size for --big in Mbp (3100 = the "
                         "human-genome-scale north star; entry is named "
                         "config4_<size>)")
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--out", default=None,
                    help="merge the JSON report into this file")
    ap.add_argument("--cigar", action="store_true",
                    help="run only the full-CIGAR mapping config")
    ap.add_argument("--cigar-mode", default="all",
                    choices=["base", "1m", "hierr", "all"],
                    help="which CIGAR configs: base (262k), 1m (full "
                         "1M pass), hierr (5%% SNP + 1-8 bp indel "
                         "sweep), all")
    args = ap.parse_args()

    if args.cigar:
        rep = {"device": _device()}
        if args.cigar_mode in ("base", "all"):
            rep["config4_cigar"] = config4_cigar()
        if args.cigar_mode in ("1m", "all"):
            rep["config4_cigar_1m"] = config4_cigar(n_reads=1_048_576)
        if args.cigar_mode in ("hierr", "all"):
            # 5% SNPs + 10% of reads carrying 1-8 bp deletions: the
            # regime where the certified-diagonal tier stops absorbing
            # the load (reference CIGARs every pair at any error rate,
            # sw.cpp:149-255 — so must we, at a measured rate)
            rep["config4_cigar_hierr"] = config4_cigar(
                err=0.05, indel_frac=0.10, max_indel=8, seed=8)
        _write_report(rep, args.out)
        print(json.dumps({k: rep[k] for k in rep
                          if k.startswith("config4_cigar")}))
        return

    if args.big:
        c4, _, _ = config4(args.reads, int(args.big_mbp * 1e6), seed=3,
                           passes=args.passes)
        name = ("config4_3gbp" if args.big_mbp >= 3000
                else f"config4_{int(args.big_mbp)}mbp")
        rep = {"device": _device(), name: c4}
        _write_report(rep, args.out)
        print(json.dumps({name: c4}))
        return

    if args.mesh_only:
        rep = config5_mesh(args.sort_keys)
        print(json.dumps(rep))
        return

    rep = {"device": _device()}
    if args.sort_only:
        rng = np.random.default_rng(9)
        pos = rng.integers(0, 1 << 26, args.reads)
        score = np.zeros(args.reads, np.int64)
    else:
        c4, pos, score = config4(args.reads, int(args.ref_mbp * 1e6))
        rep["config4_seed_extend_1m"] = c4
    rep["config5_align_sort"] = config5(pos, score, args.sort_keys)
    _write_report(rep, args.out)
    print(json.dumps(rep))


if __name__ == "__main__":
    main()
