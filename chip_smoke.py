"""Smoke run of the main path on the GPU, through the public entry points.

    python chip_smoke.py             # one card: phases 0-5 below
    python chip_smoke.py --chips 4   # four cards: the sharded paths only

Phases (one card):
  0  device, versions, power limit, XLA flags, compile cache, native lib
  1  compile at real widths (SW window step, PairHMM f32 step, xfloat
     rescue), print memory_analysis(), run each kernel once vs the plain path
  2  SW: 1,972 goldens x their overhang strategies through
     SmithWatermanAligner (CIGAR and offset bit-exact); 131,072 random
     150 x 150 pairs, kernel == plain score
  3  PairHMM: KAT and goldens through PairHmmEngine (log10 within 1e-5),
     bitwise f32 and rescue-decision counts vs the goldens, the GATK-region
     fixture (one call, an 8-region stream, 256 pairs vs the scalar oracle)
  4  mapper: seeded 64 Mbp reference, 262,144 reads, map_reads_stream in
     score and CIGAR mode, kernel == plain for every read, 2,000
     traceback-tier reads == SmithWatermanAligner
  5  sort: 10M keys through sort_records_single == NumPy

Each phase prints one line; the first failure exits non-zero.  The last
line is the JSON device record.  Without a GPU, or outside a checkout of
the repository, the script fails before any phase.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
SW = (25, -50, 110, 6)
T0 = time.perf_counter()

# sizes of the default run (the first benchmark's widths)
N_WINDOWS = 131_072          # SW window step, 198 x 150
N_SW_PAIRS = 131_072         # random 150 x 150 pairs, score-only
PH_PRODUCT = (2048, 16)      # reads x haps = 32,768 pairs at 150 x 400
REF_BP = 64_000_000          # mapper reference
N_READS = 262_144            # mapper reads, 150 bp
N_TB_CHECK = 2000            # traceback-tier reads vs SmithWatermanAligner
N_SORT = 10_000_000          # sort keys
PIPE = dict(r_per_dev=1024, h_per_dev=8, read_len=151, hap_len=420)


class PhaseFailed(Exception):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise PhaseFailed(msg)


def report(phase: str, text: str) -> None:
    print(f"[{phase}] {text}  (t={time.perf_counter() - T0:.1f}s)",
          flush=True)


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


# ---------------------------------------------------------------- phase 0

def phase_device(n_chips: int):
    import jax
    import jaxlib

    devs = jax.devices()
    check(devs[0].platform == "gpu",
          f"JAX's default device is {devs[0].platform!r}, not a GPU")
    check(len(devs) >= n_chips, f"{len(devs)} devices, {n_chips} needed")
    from mgl_tpu.core.backend import enable_compile_cache
    from mgl_tpu.native import get_lib

    cache = enable_compile_cache()
    check(get_lib() is not None, "native host library did not build/load")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    report("0 device", f"kind={devs[0].device_kind} count={len(devs)} "
           f"jax={jax.__version__} jaxlib={jaxlib.__version__} "
           f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r} cache={cache} "
           f"native=ok")
    for line in smi.stdout.strip().splitlines():
        print(line, flush=True)
    return devs


# ---------------------------------------------------------------- phase 1

def phase_compile():
    import jax
    import jax.numpy as jnp

    from bench import engine_fixture, pairhmm_product, sw_windows
    from mgl_tpu.core.params import SWParameters
    from mgl_tpu.ops import pairhmm as ph
    from mgl_tpu.ops.sw import best_scores
    from mgl_tpu.ops.xfloat import pairhmm_forward_xf, xf_forward_args

    params = SWParameters(*SW)
    win, reads = sw_windows(N_WINDOWS)
    n, T = win.shape
    Q = reads.shape[1]
    args = (jnp.asarray(win.astype(np.int32)), jnp.full((n,), T, jnp.int32),
            jnp.asarray(reads.astype(np.int32)), jnp.full((n,), Q, jnp.int32))
    outs = {}
    for impl in ("pallas", "xla"):
        fn = jax.jit(lambda t, tl, q, ql, impl=impl: best_scores(
            t, tl, q, ql, params, impl=impl))
        comp, c_s = timed(lambda: fn.lower(*args).compile())
        out, r_s = timed(lambda: np.asarray(comp(*args)))
        outs[impl] = out
        report("1 compile", f"SW window step {impl} {n}x{T}x{Q}: compile "
               f"{c_s:.2f}s run {r_s:.3f}s mem={comp.memory_analysis()}")
    diff = int((outs["pallas"] != outs["xla"]).sum())
    check(diff == 0, f"SW kernel != plain on {diff} of {n} windows")
    report("1 compile", f"SW kernel == plain on all {n} windows (exact)")

    reads, haps = pairhmm_product(*PH_PRODUCT)
    pairs = [(r, h) for r in range(len(reads)) for h in range(len(haps))]
    pargs = ph.product_forward_args(reads, haps, pairs)
    outs = {}
    for impl in ("pallas", "xla"):
        comp, c_s = timed(lambda: ph.product_forward.lower(
            *pargs, impl=impl).compile())
        out, r_s = timed(lambda: np.asarray(comp(*pargs))[:len(pairs)])
        outs[impl] = out
        report("1 compile", f"PairHMM f32 step {impl} {len(pairs)} pairs "
               f"150x400: compile {c_s:.2f}s run {r_s:.3f}s "
               f"mem={comp.memory_analysis()}")
    k, p = outs["pallas"], outs["xla"]
    check(np.all(np.isfinite(k)) and np.all(k >= 0), "PairHMM kernel scores "
          "not finite and non-negative")
    check(np.array_equal(k == 0, p == 0), "PairHMM zero scores differ")
    nz = p > 0
    nbit = int((k.view(np.int32) != p.view(np.int32)).sum())
    rel = float(np.max(np.abs(k[nz] - p[nz]) / p[nz]))
    check(rel <= 1e-6, f"PairHMM kernel vs plain max rel {rel:.3g} > 1e-6")
    report("1 compile", f"PairHMM kernel vs plain on {len(pairs)} pairs "
           f"({int((~nz).sum())} underflow to 0): {nbit} "
           f"bitwise-different, max rel {rel:.3g} (tol 1e-6)")

    xf_reads, xf_haps = engine_fixture()
    xargs = xf_forward_args(xf_reads, xf_haps,
                            [(k, 0) for k in range(0, 512, 16)])
    comp, c_s = timed(lambda: pairhmm_forward_xf.lower(*xargs).compile())
    report("1 compile", f"xfloat rescue 32 pairs 151x420: compile {c_s:.2f}s"
           f" mem={comp.memory_analysis()}")


# ---------------------------------------------------------------- phase 2

def phase_sw():
    import jax.numpy as jnp

    from bench import sw_windows
    from mgl_tpu.api import SmithWatermanAligner
    from mgl_tpu.core.params import OverhangStrategy, SWParameters
    from mgl_tpu.ops.sw import best_scores

    rows = [json.loads(ln) for ln in
            (ROOT / "tests/golden/sw_golden.jsonl").read_text().splitlines()]
    groups: dict = {}
    for r in rows:
        key = (r["match"], r["mismatch"], r["open"], r["ext"], r["strategy"])
        groups.setdefault(key, []).append(r)
    al = SmithWatermanAligner()
    bad = 0

    def run():
        nonlocal bad
        for (m, x, o, e, s), rs in groups.items():
            res = al.align_batch([r["target"].encode() for r in rs],
                                 [r["query"].encode() for r in rs],
                                 SWParameters.normalized(m, x, o, e),
                                 OverhangStrategy(s))
            bad += sum(g.cigar != r["cigar_scalar"]
                       or g.offset != r["offset_scalar"]
                       for r, g in zip(rs, res))

    _, s = timed(run)
    strategies = sorted({r["strategy"] for r in rows})
    check(bad == 0, f"{bad} of {len(rows)} SW goldens differ")
    report("2 sw", f"{len(rows)} goldens (strategies {strategies}) through "
           f"SmithWatermanAligner: all CIGARs/offsets bit-exact ({s:.2f}s, "
           f"compiles included)")

    win, reads = sw_windows(N_SW_PAIRS, T=150, Q=150, seed=2)
    (n, T), Q = win.shape, reads.shape[1]
    args = (jnp.asarray(win.astype(np.int32)), jnp.full((n,), T, jnp.int32),
            jnp.asarray(reads.astype(np.int32)), jnp.full((n,), Q, jnp.int32),
            SWParameters(*SW))
    got = {}
    for impl in ("pallas", "xla"):
        got[impl], s = timed(lambda: np.asarray(best_scores(*args,
                                                            impl=impl)))
        _, s2 = timed(lambda: np.asarray(best_scores(*args, impl=impl)))
        report("2 sw", f"{n} pairs {T}x{Q} score-only {impl}: first "
               f"{s:.3f}s steady {s2:.4f}s")
    diff = int((got["pallas"] != got["xla"]).sum())
    check(diff == 0, f"SW kernel != plain on {diff} of {n} pairs")
    report("2 sw", f"{n} random {T}x{Q} pairs: kernel == plain (exact)")


# ---------------------------------------------------------------- phase 3

def _golden_read(r: dict) -> dict:
    return dict(bases=np.frombuffer(r["read"].encode(), np.uint8),
                q=np.array(r["q"], np.uint8), i=np.array(r["i"], np.uint8),
                d=np.array(r["d"], np.uint8), c=np.array(r["c"], np.uint8))


def phase_pairhmm():
    from bench import engine_fixture
    from mgl_tpu.api import PairHmmEngine
    from mgl_tpu.core.context import CTX_F32, CTX_F64, MIN_ACCEPTED
    from mgl_tpu.ops import pairhmm as ph
    from mgl_tpu.ref_impl.pairhmm_scalar import compute_score

    eng = PairHmmEngine()
    kat = json.loads((ROOT / "tests/golden/pairhmm_kat.json").read_text())
    gold = [json.loads(ln) for ln in (ROOT / "tests/golden/"
                                      "pairhmm_golden.jsonl")
            .read_text().splitlines()]

    def diag(cases):
        reads = [_golden_read(c) for c in cases]
        haps = [np.frombuffer(c["hap"].encode(), np.uint8) for c in cases]
        out = np.empty(len(cases))
        for k in range(len(cases)):      # each case is its own (1 x 1) call
            out[k] = eng.compute_likelihoods([reads[k]], [haps[k]])[0, 0]
        return out, reads, haps

    got, _ = timed(lambda: diag(kat)[0])
    want = np.array([c["expected_log10"] for c in kat])
    err = float(np.max(np.abs(got - want)))
    check(err < 1e-5, f"KAT max |log10 err| {err:.3g} >= 1e-5")
    report("3 pairhmm", f"{len(kat)} KAT cases through PairHmmEngine: max "
           f"|log10 err| {err:.3g} (tol 1e-5)")

    got, reads, haps = diag(gold)
    want = np.array([np.log10(float.fromhex(r["scalard"]))
                     - float(CTX_F64.log10_initial_constant) for r in gold])
    err = float(np.max(np.abs(got - want)))
    check(err < 1e-5, f"golden max |log10 err| {err:.3g} >= 1e-5")
    # the f32 pass itself vs the reference's f32 scalar kernel, bitwise
    f32 = np.asarray(ph.forward_scores_pairs(
        reads, haps, [(k, k) for k in range(len(gold))]))
    g32 = np.array([float.fromhex(r["scalarf"]) for r in gold], np.float32)
    nbit = int((f32.view(np.int32) != g32.view(np.int32)).sum())
    flips = int(((f32 < MIN_ACCEPTED) != (g32 < MIN_ACCEPTED)).sum())
    n_resc = int((g32 < MIN_ACCEPTED).sum())
    report("3 pairhmm", f"{len(gold)} goldens through PairHmmEngine: max "
           f"|log10 err| {err:.3g} vs reference f64 (tol 1e-5); f32 pass vs "
           f"reference f32 scalar: {nbit} bitwise-different, {flips} "
           f"rescue decisions flipped ({n_resc} golden pairs rescued)")

    reads, haps = engine_fixture()
    out, s1 = timed(lambda: eng.compute_likelihoods(reads, haps))
    _, s2 = timed(lambda: eng.compute_likelihoods(reads, haps))
    check(out.shape == (512, 12) and np.all(np.isfinite(out)),
          "region likelihoods not finite (512, 12)")
    # 256 sampled pairs vs the double scalar oracle
    rng = np.random.default_rng(0)
    ri = rng.integers(0, 512, 256)
    hi = rng.integers(0, 12, 256)
    ri[:32] = np.arange(0, 512, 16)       # include the rescue tail
    lic = float(CTX_F64.log10_initial_constant)
    want = np.array([np.log10(compute_score(
        haps[h], reads[r]["bases"], reads[r]["q"], reads[r]["i"],
        reads[r]["d"], reads[r]["c"], ctx=CTX_F64)) - lic
        for r, h in zip(ri, hi)])
    err = float(np.max(np.abs(out[ri, hi] - want)))
    check(err < 1e-5, f"region vs scalar oracle max err {err:.3g}")
    regions = [engine_fixture(seed=7 + k) for k in range(8)]
    seq = [eng.compute_likelihoods(r, h) for r, h in regions]
    piped, s3 = timed(lambda: list(eng.compute_likelihoods_stream(
        iter(regions))))
    check(all(np.array_equal(a, b) for a, b in zip(seq, piped)),
          "stream != sequential calls")
    report("3 pairhmm", f"GATK region 512x12 151x420: call first {s1:.2f}s "
           f"steady {s2:.3f}s; 256 pairs vs scalar oracle max |log10 err| "
           f"{err:.3g} (tol 1e-5); 8-region stream {s3:.3f}s, bit-identical "
           f"to sequential calls; log10 initial const f32 "
           f"{float(CTX_F32.log10_initial_constant):.4f}")


# ---------------------------------------------------------------- phase 4

def phase_mapper():
    from mgl_tpu.api import SmithWatermanAligner
    from mgl_tpu.core.params import OverhangStrategy, SWParameters
    from mgl_tpu.pipelines.mapper import (ReferenceIndex, map_reads_stream,
                                          revcomp)
    from mgl_tpu.utils.metrics import METRICS
    from tools.run_scale_configs import simulate_cigar

    L = 150
    (ref, reads, true_pos, n_ind), s_sim = timed(lambda: simulate_cigar(
        np.random.default_rng(4), REF_BP, N_READS, L))
    index, s_idx = timed(lambda: ReferenceIndex.build(ref, k=16))
    report("4 mapper", f"simulated {REF_BP / 1e6:.0f} Mbp + {len(reads)} "
           f"reads ({n_ind} "
           f"with 1-2 bp deletions, 1% substitutions) in {s_sim:.1f}s; index "
           f"{len(index.sorted_kmers)} k-mers in {s_idx:.1f}s")
    res = {}
    for cigar in (False, True):
        for impl in ("pallas", "xla"):
            METRICS.reset()
            out, s = timed(lambda: map_reads_stream(
                index, reads, with_cigar=cigar, impl=impl))
            n_tb = int(METRICS.counters.get("map.tb_reads", 0))
            res[(cigar, impl)] = out
            mapped = out["pos"] >= 0
            wlen = L + 2 * out["window_pad"]
            ok = (mapped & (true_pos >= out["pos"])
                  & (true_pos <= out["pos"] + wlen - L))
            report("4 mapper", f"map_reads_stream cigar={cigar} impl={impl}: "
                   f"{s:.2f}s (first call, compiles included), mapped "
                   f"{mapped.mean():.4f}, window accuracy "
                   f"{ok.sum() / max(mapped.sum(), 1):.4f}, traceback tier "
                   f"{n_tb} reads ({n_tb / max(mapped.sum(), 1):.4f})")
        a, b = res[(cigar, "pallas")], res[(cigar, "xla")]
        keys = ["pos", "score", "mapq", "offset", "strand"] + (
            ["cigar"] if cigar else [])
        for k in keys:
            same = (list(a[k]) == list(b[k]) if k == "cigar"
                    else np.array_equal(a[k], b[k]))
            check(same, f"mapper {k} differs between kernel and plain "
                  f"(cigar={cigar})")
        check((a["pos"] >= 0).mean() > 0.95, "mapped share below 0.95")
        report("4 mapper", f"cigar={cigar}: kernel == plain for all "
               f"{len(reads)} reads on {keys}")

    out = res[(True, "pallas")]
    tb = [i for i in range(len(reads)) if out["pos"][i] >= 0
          and out["cigar"][i] != f"{L}M"][:N_TB_CHECK]
    check(len(tb) >= N_TB_CHECK // 2, f"only {len(tb)} traceback-tier reads")
    wlen = L + 2 * out["window_pad"]
    wins = [ref[p: p + wlen] for p in out["pos"][tb]]
    rds = [revcomp(reads[i]) if out["strand"][i] else reads[i] for i in tb]
    al = SmithWatermanAligner().align_batch(
        wins, rds, SWParameters(*SW), OverhangStrategy.SOFTCLIP)
    bad = sum((r.cigar, r.offset) != (out["cigar"][i], out["offset"][i])
              for r, i in zip(al, tb))
    check(bad == 0, f"{bad} of {len(tb)} traceback reads != aligner")
    report("4 mapper", f"{len(tb)} traceback-tier reads == "
           f"SmithWatermanAligner on their windows")


# ---------------------------------------------------------------- phase 5

def phase_sort():
    from mgl_tpu.parallel.sort import sort_records_single

    n = N_SORT
    rng = np.random.default_rng(1)
    keys = rng.integers(0, 1 << 62, n).astype(np.uint64)
    keys[: n // 10] = keys[n // 2: n // 2 + n // 10]     # duplicate keys
    vals = np.arange(n, dtype=np.int32)
    (sk, sv), s1 = timed(lambda: sort_records_single(keys, vals))
    _, s2 = timed(lambda: sort_records_single(keys, vals))
    order = np.lexsort((vals, keys))
    check(np.array_equal(sk, keys[order]), "sorted keys != NumPy")
    check(np.array_equal(keys[sv], sk), "payload permutation broken")
    report("5 sort", f"sort_records_single {n} keys: first {s1:.2f}s steady "
           f"{s2:.3f}s; keys == NumPy lexsort, payload consistent")


# ---------------------------------------------------------- four cards

def phase_multichip():
    import jax

    from mgl_tpu.parallel.mesh import make_mesh
    from mgl_tpu.parallel.pipeline import make_example_inputs, pipeline_step
    from mgl_tpu.parallel.sort import join_u64, sort_records

    devs = jax.devices()[:4]
    for dp, hp in ((2, 2), (4, 1)):
        mesh = make_mesh(dp, hp, devices=devs)
        (out, s) = timed(lambda: jax.block_until_ready(pipeline_step(mesh)(
            *make_example_inputs(mesh, **PIPE))))
        mesh1 = make_mesh(1, 1, devices=devs[:1])
        out1 = pipeline_step(mesh1)(*make_example_inputs(
            mesh1, **{**PIPE, "r_per_dev": PIPE["r_per_dev"] * dp,
                      "h_per_dev": PIPE["h_per_dev"] * hp}))
        lik, lik1 = (np.asarray(o["likelihoods"]) for o in (out, out1))
        check(lik.shape == lik1.shape, f"shape {lik.shape} vs {lik1.shape}")
        check(np.all(lik > 0), "pipeline likelihoods underflow")
        check(np.allclose(lik, lik1, rtol=1e-6, atol=0.0),
              f"({dp},{hp}) likelihoods diverge from one card")
        k, k1 = (join_u64(np.asarray(o["sorted_key_hi"]),
                          np.asarray(o["sorted_key_lo"])) for o in (out, out1))
        check(np.array_equal(k, k1), f"({dp},{hp}) sort keys differ")
        check(np.array_equal(np.asarray(out["sw_scores"]),
                             np.asarray(out1["sw_scores"])),
              f"({dp},{hp}) SW scores differ")
        report("4x pipeline", f"pipeline_step mesh ({dp},{hp}) reads "
               f"{lik.shape[0]} haps {lik.shape[1]} {PIPE['read_len']}x"
               f"{PIPE['hap_len']}: {s:.2f}s first "
               f"call; == one-card replay (rtol 1e-6, keys bit-equal)")

    n = N_SORT
    rng = np.random.default_rng(2)
    keys = rng.integers(0, 1 << 62, n).astype(np.uint64)
    vals = np.arange(n, dtype=np.int32)
    mesh = make_mesh(4, 1, devices=devs)
    (sk, sv), s = timed(lambda: sort_records(keys, vals, mesh, "dp"))
    check(np.array_equal(sk, np.sort(keys)), "4-card sort != NumPy")
    check(np.array_equal(keys[sv], sk), "4-card sort payload broken")
    report("4x sort", f"sort_records {n} keys over dp=4: {s:.2f}s first "
           f"call; == NumPy")

    from mgl_tpu.pipelines.align_sort import align_and_sort
    from mgl_tpu.pipelines.mapper import ReferenceIndex
    from tools.run_scale_configs import simulate_cigar

    ref, reads, _, _ = simulate_cigar(np.random.default_rng(4), REF_BP,
                                      N_READS)
    index = ReferenceIndex.build(ref, k=16)
    a, s4 = timed(lambda: align_and_sort(index, reads, mesh=mesh))
    b, s1 = timed(lambda: align_and_sort(index, reads, mesh=None))
    for k in a:
        check(np.array_equal(np.asarray(a[k]), np.asarray(b[k])),
              f"align_and_sort {k}: 4-card mesh != mesh=None")
    report("4x align_sort", f"align_and_sort {len(reads)} reads "
           f"{REF_BP / 1e6:.0f} Mbp: "
           f"mesh dp=4 {s4:.2f}s, mesh=None {s1:.2f}s; outputs equal")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4))
    args = ap.parse_args()
    if not (ROOT / "mgl_tpu").is_dir():
        sys.exit("chip_smoke.py must run from a checkout of the repository")
    sys.path.insert(0, str(ROOT))
    try:
        devs = phase_device(args.chips)
        if args.chips == 4:
            phase_multichip()
        else:
            phase_compile()
            phase_sw()
            phase_pairhmm()
            phase_mapper()
            phase_sort()
    except PhaseFailed as e:
        print(f"FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
    d = devs[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devs)}}))


if __name__ == "__main__":
    main()
