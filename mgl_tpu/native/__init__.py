"""Native (C++) host runtime: loader + ctypes bindings.

The equivalent of the reference's NativeLibraryLoader.java (L3 in
SURVEY.md §1): builds/loads libmgl_native.so and exposes typed wrappers.
Set MGL_TPU_NATIVE=0 to force the pure-Python fallbacks; set
MGL_TPU_NATIVE_PATH to load a prebuilt .so (the USE_LIBRARY_PATH analogue,
NativeLibraryLoader.java:21).
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess

import numpy as np

_DIR = pathlib.Path(__file__).parent
_SO = _DIR / "libmgl_native.so"
_SRC = _DIR / "src" / "mgl_native.cpp"

_lib = None
_tried = False


def _src_digest() -> str:
    import hashlib

    return hashlib.sha256(_SRC.read_bytes()).hexdigest()


def _build() -> bool:
    from mgl_tpu.utils.logging import get_logger

    log = get_logger("native")
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
             str(_SRC), "-o", str(_SO), "-pthread"],
            check=True, capture_output=True,
        )
        (_SO.parent / (_SO.name + ".srchash")).write_text(_src_digest())
        log.info("built native helper library at %s", _SO)
        return True
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        log.warning("native helper build failed (%s); falling back to "
                    "pure-Python paths", e)
        return False


def _stale(so: pathlib.Path) -> bool:
    """A cached .so is stale unless its recorded source hash matches.
    (mtime comparison is unreliable: git checkout writes both files with
    the same timestamp.)"""
    if not so.exists():
        return True
    sidecar = so.parent / (so.name + ".srchash")
    return (not sidecar.exists()
            or sidecar.read_text().strip() != _src_digest())


def get_lib():
    """Load (building on first use) the native library, or None."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if os.environ.get("MGL_TPU_NATIVE", "1") == "0":
        return None
    path = os.environ.get("MGL_TPU_NATIVE_PATH")
    if path:
        so = pathlib.Path(path)
    else:
        so = _SO
        if _stale(so) and not _build():
            return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError as e:
        from mgl_tpu.utils.logging import get_logger

        get_logger("native").warning("could not load %s (%s)", so, e)
        return None

    lib.pairhmm_f64_batch.argtypes = [
        ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
    ]
    lib.score_max_batch.argtypes = [ctypes.c_int32] + [ctypes.c_void_p] * 2 + [
        ctypes.c_int64] + [ctypes.c_void_p] * 3 + [ctypes.c_void_p] * 6
    lib.radix_sort_kmer_index.argtypes = [
        ctypes.c_int64, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.kmer_scan_canonical.argtypes = [
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.kmer_scan_canonical.restype = ctypes.c_int64
    lib.kmer_prefix_table.argtypes = [
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_int64, ctypes.c_void_p]
    lib.map_seed_vote.argtypes = [
        ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.exact_nm_batch.argtypes = [
        ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int32]
    _lib = lib
    return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def pairhmm_f64_rescue(reads: list[dict], haps: list[np.ndarray],
                       pairs: list[tuple[int, int]],
                       n_threads: int | None = None) -> np.ndarray | None:
    """Double-precision scores for the rescue tail.  Returns (B,) float64
    scaled scores, or None if the native lib is unavailable."""
    lib = get_lib()
    if lib is None or not pairs:
        return None
    from mgl_tpu.core.context import CTX_F64, read_transition_rows

    B = len(pairs)
    max_rows = max(len(reads[ri]["bases"]) for ri, _ in pairs) + 1

    read_blob, read_off = [], np.zeros(B, np.int64)
    hap_blob, hap_off = [], np.zeros(B, np.int64)
    rslen = np.zeros(B, np.int32)
    haplen = np.zeros(B, np.int32)
    trans = np.zeros((B, 7, max_rows), np.float64)
    y_init = np.zeros(B, np.float64)

    tcache: dict[int, tuple] = {}
    ro = ho = 0
    for b, (ri, hi) in enumerate(pairs):
        rd, hp = reads[ri], haps[hi]
        if ri not in tcache:
            t = read_transition_rows(rd["q"], rd["i"], rd["d"], rd["c"], CTX_F64)
            distm = t[5]
            dm = (1.0 - distm)
            dmm = distm * (1.0 / 3.0)
            tcache[ri] = t[:5] + (dm, dmm)
        n = len(rd["bases"])
        read_blob.append(np.asarray(rd["bases"], np.uint8))
        read_off[b] = ro
        ro += n
        rslen[b] = n
        hap_blob.append(np.asarray(hp, np.uint8))
        hap_off[b] = ho
        ho += len(hp)
        haplen[b] = len(hp)
        for k in range(7):
            trans[b, k, : n + 1] = tcache[ri][k]
        y_init[b] = float(CTX_F64.initial_constant) / float(len(hp))

    reads_cat = np.concatenate(read_blob) if read_blob else np.zeros(0, np.uint8)
    haps_cat = np.concatenate(hap_blob) if hap_blob else np.zeros(0, np.uint8)
    out = np.zeros(B, np.float64)
    nthr = n_threads or min(8, os.cpu_count() or 1)
    lib.pairhmm_f64_batch(
        B, _ptr(reads_cat), _ptr(read_off), _ptr(rslen),
        _ptr(haps_cat), _ptr(hap_off), _ptr(haplen),
        _ptr(trans), 7 * max_rows, max_rows, _ptr(y_init), _ptr(out), nthr,
    )
    return out


def kmer_index_rows(code: np.ndarray, k: int):
    """Sorted canonical k-mer index rows for a 2-bit coded reference
    (k <= 16): one C pass emits (canonical value, position, fwd-bit) for
    every valid (N-free) window, then the fused radix sort orders them.
    Returns (keys uint32, pos uint32, fwd bool) or None if the native
    lib is unavailable."""
    lib = get_lib()
    if lib is None or not (1 <= k <= 16) or len(code) >= 2**32:
        return None
    code = np.ascontiguousarray(code, np.uint8)
    cap = max(len(code) - k + 1, 0)
    keys = np.empty(cap, np.uint32)
    pos = np.empty(cap, np.uint32)
    fwd = np.empty(cap, np.uint8)
    n = lib.kmer_scan_canonical(len(code), _ptr(code), int(k),
                                _ptr(keys), _ptr(pos), _ptr(fwd))
    keys, pos, fwd = keys[:n], pos[:n], fwd[:n]
    radix_sort_kmers(keys, pos, fwd, 2 * k)
    return keys, pos, fwd.view(np.bool_)


def kmer_prefix_table(sorted_keys: np.ndarray, shift: int,
                      buckets: int) -> np.ndarray | None:
    """Prefix jump table (buckets+1 uint32 cumulative counts) over the
    sorted uint32 key column, or None if the native lib is unavailable."""
    lib = get_lib()
    if lib is None or len(sorted_keys) >= 2**32:
        return None
    assert sorted_keys.dtype == np.uint32 and sorted_keys.flags.c_contiguous
    table = np.empty(buckets + 1, np.uint32)
    lib.kmer_prefix_table(len(sorted_keys), _ptr(sorted_keys), int(shift),
                          int(buckets), _ptr(table))
    return table


def radix_sort_kmers(keys: np.ndarray, pos: np.ndarray, fwd: np.ndarray,
                     key_bits: int) -> bool:
    """In-place stable LSD radix sort of parallel (uint32 keys, uint32
    positions, uint8/bool strand bits) rows by key — the index-build sort
    with the permutation fused into the scatter (replaces np.argsort +
    three gathers).  Returns False if the native lib is unavailable; the
    arrays are untouched in that case."""
    lib = get_lib()
    if lib is None:
        return False
    assert keys.dtype == np.uint32 and pos.dtype == np.uint32
    assert fwd.dtype in (np.uint8, np.bool_) and fwd.itemsize == 1
    for a in (keys, pos, fwd):
        assert a.flags.c_contiguous and a.flags.writeable
    lib.radix_sort_kmer_index(len(keys), int(key_bits),
                              _ptr(keys), _ptr(pos), _ptr(fwd))
    return True


def map_seed_vote(reads: np.ndarray, index, stride: int,
                  n_threads: int | None = None):
    """Fused seed -> canonical lookup -> diagonal vote for a chunk of
    reads: the single-pass native form of mapper's _seed_kmers +
    ReferenceIndex.lookup + _vote_diagonals (two-strand canonical mode).
    Returns (pos, votes, votes2, pos2) with 2N rows (forward rows then
    reverse rows), bit-identical to the NumPy path, or None when the
    native lib or the index shape doesn't qualify."""
    lib = get_lib()
    if lib is None:
        return None
    if (index.canon_fwd is None or index.k > 16
            or index.sorted_kmers.dtype != np.uint32
            or index.positions.dtype != np.uint32
            or len(index.ref) >= 2**32):
        return None
    ptable = index.prefix_table
    if ptable is not None and ptable.dtype != np.uint32:
        return None
    reads = np.ascontiguousarray(reads, np.uint8)
    N, L = reads.shape
    fwd = np.ascontiguousarray(index.canon_fwd.view(np.uint8))
    pos = np.empty(2 * N, np.int64)
    votes = np.empty(2 * N, np.int32)
    votes2 = np.empty(2 * N, np.int32)
    pos2 = np.empty(2 * N, np.int64)
    # shift so (kmer >> shift) indexes the jump table's buckets
    pshift = (2 * index.k - ((len(ptable) - 1).bit_length() - 1)
              if ptable is not None else 0)
    lib.map_seed_vote(
        N, L, _ptr(reads), int(index.k), int(stride),
        _ptr(index.sorted_kmers), _ptr(index.positions), _ptr(fwd),
        len(index.sorted_kmers),
        _ptr(ptable) if ptable is not None else None, pshift,
        int(index.max_hits), len(index.ref),
        n_threads or min(8, os.cpu_count() or 1),
        _ptr(pos), _ptr(votes), _ptr(votes2), _ptr(pos2))
    return pos, votes, votes2, pos2


def exact_nm(reads: np.ndarray, ref: np.ndarray, pos: np.ndarray,
             n_threads: int | None = None) -> np.ndarray | None:
    """Mismatch count of each (oriented) read vs the reference at its
    predicted start, or None if the native lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    reads = np.ascontiguousarray(reads, np.uint8)
    N, L = reads.shape
    pos = np.ascontiguousarray(pos, np.int64)
    nm = np.empty(N, np.int32)
    lib.exact_nm_batch(N, L, _ptr(reads), _ptr(ref), len(ref), _ptr(pos),
                       _ptr(nm), n_threads or min(8, os.cpu_count() or 1))
    return nm


def score_max_bulk(last_col: np.ndarray, last_row: np.ndarray,
                   tlen: np.ndarray, qlen: np.ndarray):
    """Native ScoreMax over per-diagonal samples ((D, B) int32 arrays from
    the XLA forward).  Returns the ez dict or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    B = len(tlen)
    lc = np.ascontiguousarray(last_col, np.int32)
    lr = np.ascontiguousarray(last_row, np.int32)
    lane = np.arange(B, dtype=np.int32)
    i32 = lambda a: np.ascontiguousarray(a, np.int32)
    tl, ql = i32(tlen), i32(qlen)
    outs = {k: np.zeros(B, np.int32) for k in
            ("mqe", "mqe_t", "max", "max_t", "max_q", "seg_length")}
    lib.score_max_batch(
        B, _ptr(lc), _ptr(lr), lc.shape[1], _ptr(lane), _ptr(tl), _ptr(ql),
        _ptr(outs["mqe"]), _ptr(outs["mqe_t"]), _ptr(outs["max"]),
        _ptr(outs["max_t"]), _ptr(outs["max_q"]), _ptr(outs["seg_length"]))
    return {k: v.astype(np.int64) for k, v in outs.items()}
