"""Microbenchmark: the mapper's device window gather vs reference size.

Times, on whatever device JAX uses:
  (a) a flat byte gather (one ref byte per window column; built locally
      here since production no longer stores bytes on device),
  (b) the blocked (row, offset) byte gather,
  (c) the sorted-starts variant of (a) (locality probe),
  (d) the word-packed gather (8 bp per uint32, ~26 aligned words per
      window, device unpack + 8-way nibble-shift select — production),
  (e) the full production gather + SW verify (_windowed_scores_fn).

Usage: python tools/profile_gather.py [--mbp 64 512] [--lanes 131072]
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def run(ref_mbp: float, lanes: int, wlen: int = 198, qlen: int = 150,
        iters: int = 4):
    import jax
    import jax.numpy as jnp

    from mgl_tpu.pipelines import mapper as M
    from mgl_tpu.pipelines.mapper import ReferenceIndex

    n = int(ref_mbp * 1e6)
    rng = np.random.default_rng(0)
    ref = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=n)
    starts = rng.integers(0, n - wlen, lanes).astype(np.int64)
    reads = rng.choice(np.frombuffer(b"ACGT", np.uint8),
                       size=(lanes, qlen))
    code = M.encode(ref)

    # (a)/(c) old flat byte layout, built locally
    bytes_dev = jnp.asarray(np.concatenate(
        [code, np.full(M._BLOCK_OVERLAP, M._REF_PAD, np.uint8)]))

    @jax.jit
    def gather_flat(rd, st):
        win = rd[st[:, None] + jnp.arange(wlen, dtype=st.dtype)[None, :]]
        return win.sum(dtype=jnp.int32)

    @jax.jit
    def gather_blocked(rd2, bid, off):
        win = rd2[bid[:, None],
                  off[:, None] + jnp.arange(wlen, dtype=jnp.int32)[None, :]]
        return win.sum(dtype=jnp.int32)

    st32 = starts.astype(np.int32)
    out = {}

    def timeit(fn, *args):
        r = fn(*args)
        np.asarray(r).reshape(-1)[:1]
        best = float("inf")
        for _ in range(3):
            t0 = time.time()
            rs = [fn(*args) for _ in range(iters)]
            np.asarray(rs[-1]).reshape(-1)[:1]
            best = min(best, (time.time() - t0) / iters)
        return best * 1e3

    out["gather_flat_ms"] = timeit(gather_flat, bytes_dev,
                                   jnp.asarray(st32))
    out["gather_flat_sorted_ms"] = timeit(
        gather_flat, bytes_dev, jnp.asarray(np.sort(st32)))

    # (b) old blocked byte layout
    S = 1 << M._BLOCK_BITS
    n_rows = -(-n // S)
    padded = np.concatenate(
        [code, np.full(S + M._BLOCK_OVERLAP, M._REF_PAD, np.uint8)])
    rows = np.lib.stride_tricks.as_strided(
        padded, shape=(n_rows, S + M._BLOCK_OVERLAP), strides=(S, 1))
    rd2 = jnp.asarray(np.ascontiguousarray(rows))
    bid = (starts >> M._BLOCK_BITS).astype(np.int32)
    off = (starts & (S - 1)).astype(np.int32)
    out["gather_blocked_ms"] = timeit(gather_blocked, rd2, jnp.asarray(bid),
                                      jnp.asarray(off))

    # (d) production word-packed layout, gather + unpack + realign only
    idx = ReferenceIndex.__new__(ReferenceIndex)
    idx.ref = ref
    idx._ref_dev = None
    idx._ref_blocked = False
    words_dev, blocked = M._ref_device(idx)
    assert not blocked
    nw = (wlen + 7) // 8 + 1

    @jax.jit
    def gather_words(wd, w0, s):
        w = wd[w0[:, None] + jnp.arange(nw, dtype=jnp.int32)[None, :]]
        nib = (w[:, :, None] >> (jnp.uint32(4)
                                 * jnp.arange(8, dtype=jnp.uint32)
                                 )[None, None, :]) & jnp.uint32(0xF)
        flat = nib.reshape(w0.shape[0], nw * 8).astype(jnp.int32)
        win = flat[:, :wlen]
        for k in range(1, 8):
            win = jnp.where((s == k)[:, None], flat[:, k: k + wlen], win)
        return win.sum(dtype=jnp.int32)

    w0, s_nib = M._split_starts(starts, False)
    out["gather_words_ms"] = timeit(gather_words, words_dev,
                                    jnp.asarray(w0), jnp.asarray(s_nib))

    # (e) full production dispatch + SW (what map.dispatch measures)
    from mgl_tpu.core.params import SWParameters

    packed = M._pack_codes(reads)
    fn = M._windowed_scores_fn(wlen, qlen, SWParameters(25, -50, 110, 6),
                               blocked=False)
    args = (words_dev, (jnp.asarray(w0), jnp.asarray(s_nib)),
            jnp.asarray(packed))
    np.asarray(fn(*args)[:8])
    best = float("inf")
    for _ in range(3):
        t0 = time.time()
        rs = [fn(*args) for _ in range(iters)]
        np.asarray(rs[-1][:8])
        best = min(best, (time.time() - t0) / iters)
    out["gather_plus_sw_ms"] = best * 1e3
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mbp", type=float, nargs="+", default=[64, 512])
    ap.add_argument("--lanes", type=int, default=131072)
    args = ap.parse_args()
    for mbp in args.mbp:
        res = run(mbp, args.lanes)
        print(f"ref {mbp:6.0f} Mbp lanes {args.lanes}: "
              + " ".join(f"{k}={v:.1f}" for k, v in res.items()), flush=True)


if __name__ == "__main__":
    main()
