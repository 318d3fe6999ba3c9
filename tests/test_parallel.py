"""Distributed-layer tests on the virtual CPU mesh (8 devices)."""

import jax
import numpy as np
import pytest

from mgl_tpu.parallel.mesh import make_mesh
from mgl_tpu.parallel.pipeline import make_example_inputs, pipeline_step
from mgl_tpu.parallel.sort import sort_records


def _cpu_devices(n):
    devs = jax.devices("cpu")
    if len(devs) < n:
        pytest.skip(f"need {n} cpu devices, have {len(devs)}")
    return devs[:n]


def test_single_device_sort_full_uint64_range():
    """Keys above 2^32 (regression: JAX demotes uint64 to uint32)."""
    from mgl_tpu.parallel.sort import sort_records_single

    rng = np.random.default_rng(0)
    keys = rng.integers(0, 2**63, size=5000).astype(np.uint64)
    vals = np.arange(5000, dtype=np.int32)
    ks, vs = sort_records_single(keys, vals)
    assert np.array_equal(ks, np.sort(keys))
    assert np.array_equal(keys[vs], ks)


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_distributed_sort_matches_numpy(n_dev):
    mesh = make_mesh(n_dev, 1, devices=_cpu_devices(n_dev))
    rng = np.random.default_rng(n_dev)
    n = 1000 + n_dev * 37
    keys = rng.integers(0, 2**63, size=n).astype(np.uint64)
    vals = np.arange(n, dtype=np.int32)
    ks, vs = sort_records(keys, vals, mesh)
    order = np.argsort(keys, kind="stable")
    assert np.array_equal(ks, keys[order])
    # each value must still pair with its key
    assert np.array_equal(keys[vs], ks)


def test_pipeline_step_multidevice_matches_single():
    """N-device pipeline == 1-device pipeline on identical inputs
    (the multi-host parity test the reference never had, SURVEY.md §4)."""
    devs = _cpu_devices(8)
    mesh8 = make_mesh(4, 2, devices=devs)
    mesh1 = make_mesh(1, 1, devices=devs[:1])

    reads8, haps8, ref8 = make_example_inputs(mesh8, seed=3)
    out8 = pipeline_step(mesh8)(reads8, haps8, ref8)

    reads1, haps1, ref1 = make_example_inputs(mesh1, r_per_dev=32,
                                              h_per_dev=8, seed=3)
    out1 = pipeline_step(mesh1)(reads1, haps1, ref1)

    lik8 = np.asarray(out8["likelihoods"])
    lik1 = np.asarray(out1["likelihoods"])
    assert lik8.shape == lik1.shape == (32, 8)
    np.testing.assert_allclose(lik8, lik1, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(out8["best_hap_lik"]),
                               np.asarray(out1["best_hap_lik"]), rtol=1e-6)
    from mgl_tpu.parallel.sort import join_u64

    k8 = join_u64(np.asarray(out8["sorted_key_hi"]),
                  np.asarray(out8["sorted_key_lo"]))
    k1 = join_u64(np.asarray(out1["sorted_key_hi"]),
                  np.asarray(out1["sorted_key_lo"]))
    np.testing.assert_array_equal(k8, k1)
    np.testing.assert_allclose(np.asarray(out8["sw_scores"]),
                               np.asarray(out1["sw_scores"]))


def test_pipeline_likelihoods_match_engine():
    """Sharded block-parallel likelihoods == the single-chip engine path."""
    devs = _cpu_devices(4)
    mesh = make_mesh(2, 2, devices=devs)
    reads, haps, ref = make_example_inputs(mesh, r_per_dev=4, h_per_dev=2,
                                           seed=11)
    out = pipeline_step(mesh)(reads, haps, ref)
    lik = np.asarray(out["likelihoods"])

    # rebuild the same pairs through ops.pairhmm on one device
    from mgl_tpu.ops.pairhmm import pack_pairs, forward_scores_xla

    rchar = np.asarray(reads["rchar"])
    rslen = np.asarray(reads["rslen"])
    q_dummy = np.zeros(0, np.uint8)
    hap = np.asarray(haps["hap"])
    haplen = np.asarray(haps["haplen"])
    R, H = rchar.shape[0], hap.shape[0]

    # reconstruct read dicts is awkward (trans already precomputed), so
    # compare through pairhmm_forward_f32 directly with the same arrays
    import jax.numpy as jnp
    from mgl_tpu.ops.pairhmm import pairhmm_forward_f32

    trans = np.asarray(reads["trans"])
    y_init = np.asarray(haps["y_init"])
    got = np.zeros((R, H), np.float32)
    pairs_r = np.repeat(np.arange(R), H)
    pairs_h = np.tile(np.arange(H), R)
    scores = pairhmm_forward_f32(
        jnp.asarray(hap[pairs_h]), jnp.asarray(haplen[pairs_h]),
        jnp.asarray(rchar[pairs_r]), jnp.asarray(rslen[pairs_r]),
        *[jnp.asarray(trans[pairs_r, k]) for k in range(7)],
        jnp.asarray(y_init[pairs_h]),
    )
    got = np.asarray(scores).reshape(R, H)
    np.testing.assert_allclose(lik, got, rtol=1e-6)


def test_pipeline_pallas_kernels_match_xla():
    """The GPU kernels inside shard_map (Pallas interpret mode on a CPU
    mesh) give the likelihood block and SW scores of the lax.scan path.
    seed=7 data includes reads whose best SW score vs the window is
    negative — the case where unmasked-diagonal maxima would diverge.
    Likelihoods may differ in the last bits where the CPU compiler
    contracts a multiply-add differently in the two programs."""
    mesh = make_mesh(2, 2, devices=_cpu_devices(4))
    reads, haps, ref = make_example_inputs(mesh, r_per_dev=4, h_per_dev=2,
                                           seed=7)
    out_p = pipeline_step(mesh, impl="pallas", interpret=True)(reads, haps,
                                                               ref)
    out_x = pipeline_step(mesh, impl="xla")(reads, haps, ref)
    np.testing.assert_allclose(np.asarray(out_p["likelihoods"]),
                               np.asarray(out_x["likelihoods"]), rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(out_p["sw_scores"]),
                                  np.asarray(out_x["sw_scores"]))
    np.testing.assert_allclose(np.asarray(out_p["best_hap_lik"]),
                               np.asarray(out_x["best_hap_lik"]), rtol=1e-6)
