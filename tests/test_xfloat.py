"""On-device extended-range rescue tier (ops/xfloat.py) vs the compiled
reference's double kernels (golden scalard/avxd dumps)."""

import math
import os

import numpy as np
import pytest

from mgl_tpu.core.context import CTX_F64, MIN_ACCEPTED

from conftest import as_u8


def _golden_reads_haps(rows):
    reads = [dict(bases=as_u8(r["read"]), q=np.array(r["q"], np.uint8),
                  i=np.array(r["i"], np.uint8), d=np.array(r["d"], np.uint8),
                  c=np.array(r["c"], np.uint8)) for r in rows]
    haps = [as_u8(r["hap"]) for r in rows]
    return reads, haps


def test_xf_ops_roundtrip_and_arithmetic():
    """xfloat mul/add agree with f64 over ~600 decades of dynamic range."""
    import jax.numpy as jnp

    from mgl_tpu.ops.xfloat import XF, xf_add, xf_mul, xf_split, xf_to_f64

    rng = np.random.default_rng(0)
    n = 4096
    # magnitudes spanning far beyond f32 range (1e-290 .. 1e290)
    a = rng.uniform(0.5, 2.0, n) * 10.0 ** rng.integers(-290, 290, n)
    b = rng.uniform(0.5, 2.0, n) * 10.0 ** rng.integers(-290, 290, n)
    a[:8] = 0.0  # zeros mixed in
    b[4:12] = 0.0

    xa = XF(*map(jnp.asarray, xf_split(a)))
    xb = XF(*map(jnp.asarray, xf_split(b)))

    # roundtrip keeps the full 48-bit double-float mantissa
    rt = xf_to_f64(*(np.asarray(x) for x in xa))
    nz = a != 0
    assert np.array_equal(rt == 0, a == 0)
    assert np.all(np.abs(rt[nz] / a[nz] - 1) < 2.0 ** -45)

    m = xf_mul(xa, xb)
    s = xf_add(xa, xb)
    got_m = xf_to_f64(*(np.asarray(x) for x in m))
    got_s = xf_to_f64(*(np.asarray(x) for x in s))
    want_m = a * b          # may over/underflow f64: compare where finite
    want_s = a + b
    ok = np.isfinite(want_m) & (want_m != 0)
    assert np.all(np.abs(got_m[ok] / want_m[ok] - 1) < 1e-13)
    ok = want_s != 0
    assert np.all(np.abs(got_s[ok] / want_s[ok] - 1) < 1e-13)
    # f64-underflowed products survive in xfloat (range check): 1e-300*1e-300
    tiny = XF(*map(jnp.asarray, xf_split(np.array([1e-300]))))
    t2 = xf_mul(tiny, tiny)
    assert float(np.asarray(t2.hi)[0]) != 0.0
    assert int(np.asarray(t2.e)[0]) < -1900


def test_xf_rescue_matches_reference_double_kernels(pairhmm_golden):
    """Full golden corpus through the device xfloat tier: log10 within 1e-5
    of the reference's own f64 kernels (scalard and the production avxd),
    with identical underflow-to-zero semantics."""
    from mgl_tpu.ops.xfloat import rescue_scores_xf

    rows = pairhmm_golden
    reads, haps = _golden_reads_haps(rows)
    got = rescue_scores_xf(reads, haps, [(k, k) for k in range(len(rows))])
    for k, r in enumerate(rows):
        want_s = float.fromhex(r["scalard"])
        want_a = float.fromhex(r["avxd"])
        if want_s == 0.0:
            assert got[k] == 0.0, k
            continue
        assert got[k] > 0.0, k
        dl = abs(math.log10(got[k]) - math.log10(want_s))
        da = abs(math.log10(got[k]) - math.log10(want_a))
        assert dl < 1e-5 and da < 1e-5, (k, got[k], want_s, want_a)


def test_rescue_decisions_and_tier_equivalence(pairhmm_golden):
    """Cascade with the device tier: rescue *decisions* come from the f32
    pass (unchanged); rescued scores agree with the scalar-f64 oracle tier
    to well within contract."""
    from mgl_tpu.ops.pairhmm import rescue_tier_scores

    rows = [r for r in pairhmm_golden
            if float.fromhex(r["scalarf"]) < float(MIN_ACCEPTED)]
    assert len(rows) >= 40  # the corpus has a real rescue tail
    reads, haps = _golden_reads_haps(rows)
    pairs = [(k, k) for k in range(len(rows))]

    old = os.environ.get("MGL_TPU_RESCUE")
    try:
        os.environ["MGL_TPU_RESCUE"] = "xf"
        xf = rescue_tier_scores(reads, haps, pairs)
        os.environ["MGL_TPU_RESCUE"] = "scalar"
        sc = rescue_tier_scores(reads, haps, pairs)
    finally:
        if old is None:
            os.environ.pop("MGL_TPU_RESCUE", None)
        else:
            os.environ["MGL_TPU_RESCUE"] = old
    nz = sc != 0
    assert np.array_equal(xf == 0, sc == 0)
    assert np.all(np.abs(np.log10(xf[nz]) - np.log10(sc[nz])) < 1e-9)


def test_use_double_cascade_via_xf(pairhmm_kat):
    """use_double=True routes everything through the device tier and still
    hits the KAT expectations (MicrosoftPairHmmUnitTest dataFileTest with
    useDoublePrecision=true)."""
    from mgl_tpu.api import PairHmmEngine

    from conftest import kat_read

    cases = pairhmm_kat[:12]
    reads = [kat_read(c) for c in cases]
    haps = [as_u8(c["hap"]) for c in cases]
    out = PairHmmEngine(use_double=True).compute_likelihoods(reads, haps)
    for k, c in enumerate(cases):
        assert abs(out[k, k] - c["expected_log10"]) < 1e-5
