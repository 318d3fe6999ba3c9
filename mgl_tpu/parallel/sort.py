"""Distributed record sort: device-local sort + bitonic merge over the mesh.

The TPU-native replacement for host-side record sorting (BASELINE.json
config 5: global coordinate sort with shard merge).  Keys are uint64
(typically (contig << 48) | position << 16 | tiebreak); values ride along
as a parallel int32 payload (record index).

64-bit keys are carried on device as (hi32, lo32) uint32 pairs — JAX
demotes uint64 to uint32 without x64 mode — and compared lexicographically
via jax.lax.sort(num_keys=2).

Algorithm: each device sorts its shard locally, then a bitonic merge
network over the mesh axis exchanges whole shards with partners via
ppermute and keeps the lower/upper half of each merged pair (merge-split
comparators preserve sorting networks, so the block version sorts).
log2(P)*(log2(P)+1)/2 exchange stages; every stage moves one shard per
device over the interconnect.  Deterministic, fixed shapes, no host
round-trips.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def split_u64(keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    keys = keys.astype(np.uint64)
    return ((keys >> np.uint64(32)).astype(np.uint32),
            (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def join_u64(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    return ((np.asarray(hi, np.uint64) << np.uint64(32))
            | np.asarray(lo, np.uint64))


def _sort3(hi, lo, vals):
    return jax.lax.sort((hi, lo, vals), num_keys=2)


def _merge_keep(hi, lo, vals, ohi, olo, ovals, keep_low):
    """Merge two sorted shards lexicographically, keep low or high half."""
    n = hi.shape[0]
    mh, ml, mv = _sort3(jnp.concatenate([hi, ohi]),
                        jnp.concatenate([lo, olo]),
                        jnp.concatenate([vals, ovals]))
    pick = lambda a: jnp.where(keep_low, a[:n], a[n:])
    return pick(mh), pick(ml), pick(mv)


def _bitonic_stages(p: int):
    """(partner_xor, ascending_mask_bit) stages of a bitonic sorting
    network over p = 2^k participants."""
    k = p.bit_length() - 1
    for major in range(1, k + 1):
        for minor in range(major - 1, -1, -1):
            yield (1 << minor), (1 << major)


def distributed_sort(key_hi, key_lo, vals, mesh: Mesh, axis: str = "dp"):
    """Globally sort (keys, vals) sharded along ``axis``.

    key_hi/key_lo: uint32 halves of the uint64 keys.  Returns sorted
    (key_hi, key_lo, vals) with the same sharding: shard i holds the i-th
    contiguous slice of the global order.  Shard sizes must be equal.
    """
    p = mesh.shape[axis]
    if p & (p - 1):
        raise ValueError("device count on sort axis must be a power of two")

    def local(hi, lo, vals):
        hi, lo, vals = _sort3(hi, lo, vals)
        if p == 1:
            return hi, lo, vals
        idx = jax.lax.axis_index(axis)
        for partner_xor, major_bit in _bitonic_stages(p):
            ascending = (idx & major_bit) == 0
            is_lower = (idx & partner_xor) == 0
            keep_low = jnp.logical_not(jnp.logical_xor(is_lower, ascending))
            perm = [(j, j ^ partner_xor) for j in range(p)]
            ohi = jax.lax.ppermute(hi, axis, perm)
            olo = jax.lax.ppermute(lo, axis, perm)
            ovals = jax.lax.ppermute(vals, axis, perm)
            hi, lo, vals = _merge_keep(hi, lo, vals, ohi, olo, ovals, keep_low)
        return hi, lo, vals

    spec = P(axis)
    fn = jax.shard_map(local, mesh=mesh, in_specs=(spec, spec, spec),
                       out_specs=(spec, spec, spec), check_vma=False)
    return fn(key_hi, key_lo, vals)


def sort_records_single(keys: np.ndarray, vals: np.ndarray):
    """One-device on-device sort of uint64 keys (lexicographic hi/lo pair).
    Returns (sorted_keys uint64, sorted_vals)."""
    hi, lo = split_u64(keys)
    shi, slo, svals = jax.lax.sort(
        (jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(np.asarray(vals))),
        num_keys=2)
    return join_u64(np.asarray(shi), np.asarray(slo)), np.asarray(svals)


def sort_records(keys: np.ndarray, vals: np.ndarray, mesh: Mesh,
                 axis: str = "dp"):
    """Host convenience: pad to equal shards, sort, strip sentinels.
    Returns (sorted_keys uint64, sorted_vals)."""
    p = mesh.shape[axis]
    n = len(keys)
    per = -(-n // p)
    total = per * p
    kp = np.full(total, np.uint64(0xFFFFFFFFFFFFFFFF), dtype=np.uint64)
    vp = np.zeros(total, dtype=np.int32)
    kp[:n] = keys
    vp[:n] = vals
    hi, lo = split_u64(kp)
    sharding = NamedSharding(mesh, P(axis))
    put = lambda a: jax.device_put(jnp.asarray(a), sharding)
    shi, slo, svals = distributed_sort(put(hi), put(lo), put(vp), mesh, axis)
    ks = join_u64(np.asarray(shi), np.asarray(slo))[:n]
    vs = np.asarray(svals)[:n]
    return ks, vs
