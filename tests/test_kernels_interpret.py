"""GPU kernels in Pallas interpret mode (CPU) against the ops/ specs.

The kernels (kernels/sw_triton.py, kernels/pairhmm_triton.py) are written
for the Triton backend; ``interpret=True`` runs the same kernel bodies on
the CPU, so their indexing, strip hand-over, padding and masking are
checked here against ops/sw.sw_forward and ops/pairhmm.pairhmm_forward_f32.
Cases cover ragged lengths, pad lanes, batches that are not a multiple of
the block, strips that do not divide the rows, and both SW border rules.
Interpret mode skips the Triton lowering, so the kernels are also lowered
for CUDA here (no card needed) at the widths the mapper and engine use.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mgl_tpu.core.params import SWParameters
from mgl_tpu.kernels.pairhmm_triton import BASE_ENC, pairhmm_scores
from mgl_tpu.kernels.sw_triton import sw_scores
from mgl_tpu.ops.pairhmm import (forward_scores_pairs, forward_scores_xla,
                                 pack_pairs)
from mgl_tpu.ops.sw import best_scores, compute_score_max, sw_forward

P = SWParameters(25, -50, 110, 6)


def _sw_case(seed, B, T, Q, ragged):
    rng = np.random.default_rng(seed)
    tl = (rng.integers(1, T + 1, B) if ragged
          else np.full(B, T)).astype(np.int32)
    ql = (rng.integers(1, Q + 1, B) if ragged
          else np.full(B, Q)).astype(np.int32)
    tch = rng.integers(0, 4, (B, T)).astype(np.int32)
    q = rng.integers(0, 4, (B, Q)).astype(np.int32)
    n = min(T, Q)
    q[:, :n] = np.where(rng.random((B, n)) < 0.75, tch[:, :n], q[:, :n])
    tch = np.where(np.arange(T)[None] < tl[:, None], tch, 0)
    q = np.where(np.arange(Q)[None] < ql[:, None], q, 0)
    return tch, tl, q, ql


def _sw_spec_max(tch, tl, q, ql, indel_init):
    res = sw_forward(jnp.asarray(tch), jnp.asarray(tl), jnp.asarray(q),
                     jnp.asarray(ql), jnp.int32(P.match),
                     jnp.int32(P.mismatch), jnp.int32(P.gap_open),
                     jnp.int32(P.gap_extend), indel_init=indel_init,
                     with_traceback=False)
    return compute_score_max(np.asarray(res.last_col),
                             np.asarray(res.last_row), tl, ql)["max"]


@pytest.mark.parametrize("B,T,Q,ragged,strip,block", [
    (37, 30, 20, True, 4, 32),     # ragged, pad lanes, T not a strip multiple
    (50, 25, 33, True, 16, 64),    # one strip deeper than the matrix
    (129, 17, 9, False, 8, 128),   # one pair past a block
    (20, 12, 40, True, 1, 32),     # one-row strips, query longer than target
])
@pytest.mark.parametrize("indel_init", [False, True])
def test_sw_kernel_matches_spec(B, T, Q, ragged, strip, block, indel_init):
    tch, tl, q, ql = _sw_case(B * T + Q, B, T, Q, ragged)
    want = _sw_spec_max(tch, tl, q, ql, indel_init)
    got = sw_scores(jnp.asarray(tch.T), jnp.asarray(q.T), jnp.asarray(tl),
                    jnp.asarray(ql), match=P.match, mismatch=P.mismatch,
                    gap_open=P.gap_open, gap_ext=P.gap_extend,
                    indel_init=indel_init, strip=strip, block=block,
                    interpret=True)
    np.testing.assert_array_equal(np.asarray(got), want)


def test_best_scores_kernel_and_plain_agree():
    """ops/sw.best_scores gives the same scores through either impl,
    including pairs whose best score is negative."""
    tch, tl, q, ql = _sw_case(3, 40, 28, 22, True)
    q[:5] = (q[:5] + 1) % 4                  # hopeless pairs: negative best
    args = (jnp.asarray(tch), jnp.asarray(tl), jnp.asarray(q),
            jnp.asarray(ql), P)
    plain = np.asarray(best_scores(*args, impl="xla"))
    kern = np.asarray(best_scores(*args, impl="pallas", interpret=True))
    np.testing.assert_array_equal(plain, kern)
    np.testing.assert_array_equal(plain, _sw_spec_max(tch, tl, q, ql, False))
    assert (plain < 0).any()


def _ph_case(seed, n, rlen, hlen):
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGTN", np.uint8)
    reads, haps = [], []
    for k in range(n):
        nr = int(rng.integers(rlen[0], rlen[1] + 1))
        bases = alpha[rng.integers(0, 5 if k % 3 == 0 else 4, nr)]
        reads.append(dict(bases=bases,
                          q=rng.integers(5, 45, nr).astype(np.uint8),
                          i=rng.integers(20, 50, nr).astype(np.uint8),
                          d=rng.integers(20, 50, nr).astype(np.uint8),
                          c=np.full(nr, 10, np.uint8)))
        nh = int(rng.integers(hlen[0], hlen[1] + 1))
        hp = alpha[rng.integers(0, 4, nh)]
        m = min(nr, nh)
        hp[:m] = np.where(rng.random(m) < 0.8, bases[:m], hp[:m])
        haps.append(hp)
    return reads, haps


def _ph_kernel(batch, **kw):
    planes = np.stack([batch.p_mm, batch.p_gapm, batch.p_mx, batch.p_my,
                       batch.p_zz, batch.distm_match,
                       batch.distm_mis]).transpose(0, 2, 1)
    return np.asarray(pairhmm_scores(
        jnp.asarray(BASE_ENC[batch.rchar].T), jnp.asarray(planes),
        jnp.asarray(BASE_ENC[batch.hap].T), jnp.asarray(batch.rslen),
        jnp.asarray(batch.haplen), jnp.asarray(batch.y_init),
        interpret=True, **kw))


@pytest.mark.parametrize("n,rlen,hlen,strip,block", [
    (37, (5, 20), (10, 30), 16, 32),   # ragged, strip deeper than reads
    (70, (1, 9), (1, 12), 3, 16),      # length-1 reads/haps, odd strips
    (33, (12, 12), (24, 24), 4, 32),   # uniform, one pair past a block
])
def test_pairhmm_kernel_matches_spec(n, rlen, hlen, strip, block):
    """Same scores as the lax.scan specification.  On the GPU the two are
    bit-identical (no multiply-add contraction there); the CPU compiler
    contracts some multiply-adds differently in the two programs, so the
    CPU comparison allows a few ulps."""
    reads, haps = _ph_case(n + strip, n, rlen, hlen)
    batch = pack_pairs(reads, haps, [(k, k) for k in range(n)])
    want = forward_scores_xla(batch)
    got = _ph_kernel(batch, strip=strip, block=block)
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=0.0)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_device_product_expansion_matches_host_packing(impl):
    """forward_scores_pairs (tracks ship once, planes are built and
    gathered per pair on device) scores like the host-packed batch, for
    an arbitrary pair list with repeated reads and haps, through either
    impl."""
    reads, haps = _ph_case(11, 9, (6, 18), (8, 26))
    pairs = [(r, h) for r in range(9) for h in (r, (r * 5) % 9)]
    want = forward_scores_xla(pack_pairs(reads, haps, pairs))
    got = np.asarray(forward_scores_pairs(reads, haps, pairs, impl=impl,
                                          interpret=True))
    if impl == "xla":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=0.0)


def _lowers_for_gpu(fn, *shapes):
    args = [jax.ShapeDtypeStruct(shape, dtype) for shape, dtype in shapes]
    low = jax.jit(fn).trace(*args).lower(lowering_platforms=("cuda",))
    return "xla.gpu.triton" in low.as_text()


@pytest.mark.parametrize("indel_init", [False, True])
def test_sw_kernel_lowers_for_gpu(indel_init):
    """The mapper's window shape (198 x 150) through the Triton lowering."""
    fn = functools.partial(sw_scores, match=P.match, mismatch=P.mismatch,
                           gap_open=P.gap_open, gap_ext=P.gap_extend,
                           indel_init=indel_init)
    assert _lowers_for_gpu(fn, ((198, 300), jnp.int32),
                           ((150, 300), jnp.int32), ((300,), jnp.int32),
                           ((300,), jnp.int32))


def test_pairhmm_kernel_lowers_for_gpu():
    """A 151 x 420 region bucket through the Triton lowering."""
    B = 100
    assert _lowers_for_gpu(pairhmm_scores, ((152, B), jnp.int32),
                           ((7, 152, B), jnp.float32), ((420, B), jnp.int32),
                           ((B,), jnp.int32), ((B,), jnp.int32),
                           ((B,), jnp.float32))
