"""Sharded end-to-end pipeline step over a ('dp', 'hp') mesh.

The multi-chip execution model (new surface vs the single-process
reference — SURVEY.md §2 parallelism note):

* reads are data-parallel along 'dp' (each host/chip owns a read shard);
* haplotypes are model-parallel along 'hp' (each chip owns a hap shard and
  computes its block-column of the likelihood matrix);
* per-read reductions (best haplotype) ride a lax.pmax over 'hp';
* globally ordered output comes from the bitonic shard merge
  (parallel/sort.py) over 'dp'.

The per-device compute inside `shard_map` is the same as on one device:
the GPU kernels (kernels/pairhmm_triton.py, kernels/sw_triton.py) where
core/backend.resolve_impl picks them, the lax.scan specifications
otherwise; tests run the kernels on CPU meshes with ``interpret=True``.

`pipeline_step` is the jit/compile target for multi-device dry-runs and
the building block of multi-card deployment: one call = likelihoods for a
(reads x haps) tile + SW scores vs a reference window + globally sorted
coordinate keys.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mgl_tpu.ops.pairhmm import pairhmm_forward_f32
from mgl_tpu.ops.sw import best_scores
from mgl_tpu.parallel.sort import distributed_sort


def _pairhmm_block_kernel(rchar, rslen, trans, y_hap, hap, haplen,
                          interpret: bool):
    """Local (r_l x h_l) likelihood block via the GPU kernel, with the
    product expanded on device (lane b = read b // h_l, hap b % h_l).
    Transition rows beyond each read's length must be zero, as
    make_example_inputs / read_transition_rows produce."""
    from mgl_tpu.kernels.pairhmm_triton import BASE_ENC, pairhmm_scores

    r_l = rchar.shape[0]
    h_l = hap.shape[0]
    lane = jnp.arange(r_l * h_l, dtype=jnp.int32)
    ridx, hidx = lane // h_l, lane % h_l
    enc = jnp.asarray(BASE_ENC)
    score = pairhmm_scores(
        enc[rchar].T[:, ridx], trans.transpose(1, 2, 0)[:, :, ridx],
        enc[hap].T[:, hidx], rslen[ridx], haplen[hidx], y_hap[hidx],
        interpret=interpret)
    return score.reshape(r_l, h_l)


def _pairhmm_block_xla(rchar, rslen, trans, y_hap, hap, haplen):
    """lax.scan reference path for the likelihood block."""
    r_l = rchar.shape[0]
    h_l = hap.shape[0]
    rep = lambda a: jnp.repeat(a, h_l, axis=0)
    til = lambda a: jnp.tile(a, (r_l,) + (1,) * (a.ndim - 1))
    scores = pairhmm_forward_f32(
        til(hap), til(haplen),
        rep(rchar), rep(rslen),
        rep(trans[:, 0]), rep(trans[:, 1]), rep(trans[:, 2]),
        rep(trans[:, 3]), rep(trans[:, 4]),
        rep(trans[:, 5]), rep(trans[:, 6]),
        til(y_hap),
    )
    return scores.reshape(r_l, h_l)


def _sw_block(target, tlen, query, qlen, params, impl: str,
              interpret: bool):
    """Best SW score of each read vs the replicated reference window."""
    r_l = query.shape[0]
    T = target.shape[1]
    return best_scores(jnp.broadcast_to(target, (r_l, T)),
                       jnp.broadcast_to(tlen, (r_l,)), query, qlen, params,
                       impl=impl, interpret=interpret).astype(jnp.int32)


def pipeline_step(mesh: Mesh, impl: str = "auto", sw_params=None,
                  interpret: bool = False):
    """Build the jitted sharded step for ``mesh``.

    ``impl``: 'pallas' (GPU kernels), 'xla' (lax.scan specifications), or
    'auto' (core/backend.resolve_impl).  ``interpret`` runs the kernels
    in Pallas interpret mode (CPU tests).
    ``sw_params``: SWParameters for the verify stage (kernel sign
    convention, as in pipelines/mapper.py); defaults to the GATK NGS set.

    Returns fn(reads, haps, ref_window) -> dict of sharded outputs, where
      reads: dict of arrays leading dim R (sharded dp):
        rchar (R, rows) i32, rslen (R,) i32, trans (R, 7, rows) f32,
        query (R, Q) i32, qlen (R,) i32, key (R,) u64
      haps: dict leading dim H (sharded hp):
        hap (H, L) i32, haplen (H,) i32, y_init (H,) f32
      ref_window: dict (replicated): target (1, T) i32, tlen (1,) i32
    """
    from mgl_tpu.core.backend import resolve_impl
    from mgl_tpu.core.params import SWParameters

    params = sw_params or SWParameters(25, -50, 110, 6)
    impl = resolve_impl(impl)

    def step(rchar, rslen, trans, query, qlen, key_hi, key_lo,
             hap, haplen, y_init, target, tlen):
        # 1. likelihood block (dp x hp block of the R x H matrix)
        if impl == "pallas":
            lik = _pairhmm_block_kernel(rchar, rslen, trans, y_init,
                                        hap, haplen, interpret)
        else:
            lik = _pairhmm_block_xla(rchar, rslen, trans, y_init,
                                     hap, haplen)

        # 2. best-hap reduction across the hp axis (collective)
        local_best = jnp.max(lik, axis=1)
        best = jax.lax.pmax(local_best, "hp")

        # 3. SW score of each read against the reference window (dp-local)
        sw_best = _sw_block(target, tlen, query, qlen, params, impl,
                            interpret)

        # 4. global coordinate sort of read keys over dp (bitonic shard merge)
        r_l = query.shape[0]
        order_vals = jax.lax.axis_index("dp") * r_l + jnp.arange(
            r_l, dtype=jnp.int32)
        return lik, best, sw_best, key_hi, key_lo, order_vals

    dp, hp, rep = P("dp"), P("hp"), P()
    sharded = jax.shard_map(
        step, mesh=mesh,
        in_specs=(dp, dp, dp, dp, dp, dp, dp, hp, hp, hp, rep, rep),
        out_specs=(P("dp", "hp"), dp, dp, dp, dp, dp),
        check_vma=False,
    )

    def full(reads: dict, haps: dict, ref_window: dict):
        lik, best, sw_best, khi, klo, vals = sharded(
            reads["rchar"], reads["rslen"], reads["trans"],
            reads["query"], reads["qlen"],
            reads["key_hi"], reads["key_lo"],
            haps["hap"], haps["haplen"], haps["y_init"],
            ref_window["target"], ref_window["tlen"],
        )
        shi, slo, svals = distributed_sort(khi, klo, vals, mesh, "dp")
        return {"likelihoods": lik, "best_hap_lik": best,
                "sw_scores": sw_best, "sorted_key_hi": shi,
                "sorted_key_lo": slo, "sorted_order": svals}

    return full


def make_example_inputs(mesh: Mesh, r_per_dev=8, h_per_dev=4,
                        read_len=24, hap_len=40, seed=0):
    """Tiny sharded inputs for dry-runs and tests."""
    from mgl_tpu.core.context import CTX_F32, read_transition_rows

    dp = mesh.shape["dp"]
    hp = mesh.shape["hp"]
    R = r_per_dev * dp
    H = h_per_dev * hp
    rows = read_len + 1
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    # an assembly region's haplotypes: one base sequence with 2
    # substitutions each; reads are windows of the base with 3%
    # substitutions, so every pair's f32 likelihood stays in range
    base = rng.choice(acgt, size=max(hap_len, read_len))
    haps = np.tile(base[:hap_len], (H, 1))
    for h in range(H):
        haps[h, rng.integers(0, hap_len, 2)] = rng.choice(acgt, 2)
    haps = haps.astype(np.int32)
    src = rng.integers(0, len(base) - read_len + 1, R)
    bases = base[src[:, None] + np.arange(read_len)[None, :]]
    mut = rng.random((R, read_len)) < 0.03
    bases[mut] = rng.choice(acgt, int(mut.sum()))
    quals = rng.integers(20, 50, size=(R, read_len)).astype(np.uint8)
    gcp = np.full((R, read_len), 10, np.uint8)

    trans = np.zeros((R, 7, rows), np.float32)
    for r in range(R):
        t = read_transition_rows(quals[r], quals[r], quals[r], gcp[r], CTX_F32)
        distm = t[5]
        one = np.float32(1.0)
        third = np.float32(1.0) / np.float32(3.0)
        for k in range(5):
            trans[r, k] = t[k]
        trans[r, 5] = (one - distm).astype(np.float32)
        trans[r, 6] = (distm * third).astype(np.float32)

    rchar = np.zeros((R, rows), np.int32)
    rchar[:, 1:] = bases

    keys = rng.integers(0, 2**62, size=R).astype(np.uint64)
    from mgl_tpu.parallel.sort import split_u64

    key_hi, key_lo = split_u64(keys)
    reads = {
        "rchar": rchar,
        "rslen": np.full(R, read_len, np.int32),
        "trans": trans,
        "query": bases.astype(np.int32),
        "qlen": np.full(R, read_len, np.int32),
        "key_hi": key_hi,
        "key_lo": key_lo,
    }
    hap_d = {
        "hap": haps,
        "haplen": np.full(H, hap_len, np.int32),
        "y_init": (np.float32(CTX_F32.initial_constant) / np.float32(hap_len)
                   ) * np.ones(H, np.float32),
    }
    ref_window = {
        "target": rng.choice(acgt, size=(1, 64)).astype(np.int32),
        "tlen": np.full(1, 64, np.int32),
    }

    def put(d, spec_axis):
        out = {}
        for k, v in d.items():
            spec = P(spec_axis) if spec_axis else P()
            out[k] = jax.device_put(jnp.asarray(v), NamedSharding(mesh, spec))
        return out

    return put(reads, "dp"), put(hap_d, "hp"), put(ref_window, None)
