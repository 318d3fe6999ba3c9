"""Parity of the GPU kernels on the card itself.

The compiled Triton kernels can differ from their interpret-mode runs in
what the GPU compiler does to arithmetic (multiply-add contraction,
denormal flushing), so these run only on a GPU:

    JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu -q

Elsewhere every test here skips (the ``gpu_device`` fixture decides).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from conftest import kat_read

pytestmark = [pytest.mark.gpu, pytest.mark.usefixtures("gpu_device")]

SW = (25, -50, 110, 6)


def _windows(n, T, Q, seed):
    rng = np.random.default_rng(seed)
    win = rng.integers(0, 4, (n, T)).astype(np.int32)
    reads = win[:, (T - Q) // 2: (T - Q) // 2 + Q].copy()
    mut = rng.random(reads.shape) < 0.05
    reads[mut] = rng.integers(0, 4, int(mut.sum()))
    return win, reads


@pytest.mark.parametrize("indel_init", [False, True])
def test_sw_kernel_equals_plain(indel_init):
    """Score-only kernel == plain forward pass, exactly, at the mapper's
    198 x 150 window shape with ragged lengths."""
    from mgl_tpu.core.params import SWParameters
    from mgl_tpu.ops.sw import best_scores

    win, reads = _windows(8192, 198, 150, seed=1)
    rng = np.random.default_rng(2)
    tl = rng.integers(100, 199, len(win)).astype(np.int32)
    ql = rng.integers(60, 151, len(win)).astype(np.int32)
    args = (jnp.asarray(win), jnp.asarray(tl), jnp.asarray(reads),
            jnp.asarray(ql), SWParameters(*SW))
    got = np.asarray(best_scores(*args, indel_init=indel_init,
                                 impl="pallas"))
    want = np.asarray(best_scores(*args, indel_init=indel_init, impl="xla"))
    np.testing.assert_array_equal(got, want)


def test_pairhmm_kernel_bitwise_equals_plain():
    """f32 kernel == lax.scan specification bit for bit on the card: XLA
    and Triton both keep every multiply and add rounded on its own."""
    from mgl_tpu.ops.pairhmm import forward_scores_pairs

    rng = np.random.default_rng(3)
    acgt = np.frombuffer(b"ACGTN", np.uint8)
    reads, haps = [], []
    for k in range(64):
        n = int(rng.integers(20, 152))
        q = rng.integers(5, 45, n).astype(np.uint8)
        reads.append(dict(bases=acgt[rng.integers(0, 5, n)], q=q, i=q, d=q,
                          c=np.full(n, 10, np.uint8)))
        haps.append(acgt[rng.integers(0, 4, int(rng.integers(30, 421)))])
    pairs = [(r, h) for r in range(64) for h in range(0, 64, 4)]
    got = np.asarray(forward_scores_pairs(reads, haps, pairs, impl="pallas"))
    want = np.asarray(forward_scores_pairs(reads, haps, pairs, impl="xla"))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_sw_goldens_through_aligner(sw_golden):
    """Every SW golden through SmithWatermanAligner: CIGAR and offset
    bit-exact against the reference scalar kernel."""
    from mgl_tpu.api import SmithWatermanAligner
    from mgl_tpu.core.params import OverhangStrategy, SWParameters

    groups = {}
    for r in sw_golden:
        key = (r["match"], r["mismatch"], r["open"], r["ext"], r["strategy"])
        groups.setdefault(key, []).append(r)
    al = SmithWatermanAligner()
    for (m, x, o, e, s), rows in groups.items():
        got = al.align_batch([r["target"].encode() for r in rows],
                             [r["query"].encode() for r in rows],
                             SWParameters.normalized(m, x, o, e),
                             OverhangStrategy(s))
        for r, g in zip(rows, got):
            assert (g.cigar, g.offset) == (r["cigar_scalar"],
                                          r["offset_scalar"]), r


def test_pairhmm_kat_through_engine(pairhmm_kat):
    """The known-answer cases through PairHmmEngine within 1e-5 log10."""
    from mgl_tpu.api import PairHmmEngine

    eng = PairHmmEngine()
    for case in pairhmm_kat:
        got = eng.compute_likelihoods(
            [kat_read(case)], [np.frombuffer(case["hap"].encode(),
                                             np.uint8)])[0, 0]
        assert abs(got - case["expected_log10"]) < 1e-5, case


def test_xfloat_rescue_matches_reference_double(pairhmm_golden):
    """The rescue tier's Dekker products survive the GPU compiler: the
    xfloat scan matches the reference's f64 scalar kernel within 1e-5
    log10 on every golden it rescues or could."""
    from mgl_tpu.ops.xfloat import rescue_scores_xf

    reads = [kat_read(r) for r in pairhmm_golden]
    haps = [np.frombuffer(r["hap"].encode(), np.uint8)
            for r in pairhmm_golden]
    got = rescue_scores_xf(reads, haps,
                           [(k, k) for k in range(len(pairhmm_golden))])
    for k, r in enumerate(pairhmm_golden):
        want = float.fromhex(r["scalard"])
        if want == 0.0:
            assert got[k] == 0.0, k
            continue
        assert abs(math.log10(got[k]) - math.log10(want)) < 1e-5, k
