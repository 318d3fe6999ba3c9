"""Multi-process scale-out launcher: transport + checkpoint + pipeline.

Composes the three tested pieces into one runtime (the last open
SURVEY.md §5 row — the reference is single-process, its only failure
analogue being the library-load fallback chain,
NativeLibraryLoader.java:51-87; pod-scale failure handling is designed
fresh here):

* ``parallel/elastic.ShardCoordinator`` over ``parallel/transport``
  (TCP JSON lines) — work distribution + heartbeat failure detection;
* ``pipelines/checkpoint`` — atomic chunk ledger (crash resume);
* ``parallel/pipeline.pipeline_step`` — the sharded device program.

Two deployment shapes:

1. **SPMD pod mode** — every process calls :func:`init_runtime`
   (the ``jax.distributed.initialize`` hook) and enters the SAME jitted
   ``pipeline_step`` over one global mesh spanning all processes'
   devices.  On GPU hosts the collectives go to NCCL; on CPU clusters
   (tests) they ride gloo over gRPC.  SPMD is gang-scheduled:
   one process failure aborts the step, and recovery is
   restart-plus-ledger (completed chunks are skipped).  Exercised
   cross-process in tests/test_launcher.py (2 OS processes, one global
   8-device mesh, cross-process psum/sort, output == single-process).

2. **Elastic shard mode** — :func:`run_scaleout` (driver) plus N
   :func:`worker_main` OS processes.  Each worker builds a *local* mesh
   over its own devices, drains chunk descriptors from the TCP
   coordinator, runs ``pipeline_step`` per chunk, and commits results
   with atomic renames.  Workers that die (kill -9, preemption, network
   loss) stop heartbeating; the coordinator re-dispatches their chunks;
   the final output is bit-identical to a single-process run.  This is
   the preemptible-fleet path for hosts that share no interconnect.

Both modes start one JAX process per worker.  A JAX process reserves most
of a GPU's memory when it first uses it, so on a GPU host each worker must
get a card of its own: whoever spawns the workers sets
``CUDA_VISIBLE_DEVICES`` for each (or ``XLA_PYTHON_CLIENT_MEM_FRACTION``
to share a card on purpose); otherwise every worker after the first fails
for want of memory.

Work travels as descriptors (chunk index ranges); bulk data rides the
shared filesystem (input .npz + per-chunk output .npz), exactly the
split parallel/transport.py documents.
"""

from __future__ import annotations

import argparse
import os
import pathlib
import sys
import time
from typing import Any

import numpy as np

READ_KEYS = ("rchar", "rslen", "trans", "query", "qlen", "key_hi", "key_lo")
HAP_KEYS = ("hap", "haplen", "y_init")
REF_KEYS = ("target", "tlen")
OUT_KEYS = ("likelihoods", "best_hap_lik", "sw_scores",
            "sorted_key_hi", "sorted_key_lo")
MAP_OUT_KEYS = ("pos", "score", "strand", "mapq", "offset",
                "pos2", "score2", "votes", "votes2")


def init_runtime(coordinator_address: str | None = None,
                 num_processes: int | None = None,
                 process_id: int | None = None,
                 local_device_count: int | None = None) -> None:
    """``jax.distributed``-shaped init hook for multi-process execution.

    Call BEFORE any other jax API.  On a real TPU pod, call with no
    arguments (jax autodetects the pod topology from the TPU metadata)
    or with the pod's coordinator; afterwards ``jax.devices()`` is the
    GLOBAL device list and meshes built from it span the pod.  On CPU
    clusters the same call brings up gloo collectives over gRPC —
    ``local_device_count`` sets this process's virtual device count
    (must be set before the backend initializes).
    """
    if local_device_count is not None:
        os.environ.setdefault("JAX_NUM_CPU_DEVICES", str(local_device_count))
    import jax

    kwargs: dict[str, Any] = {}
    if coordinator_address is not None:
        kwargs.update(coordinator_address=coordinator_address,
                      num_processes=num_processes, process_id=process_id)
    jax.distributed.initialize(**kwargs)


def shard_host_arrays(mesh, arrays: dict[str, np.ndarray], axis: str | None):
    """Host numpy dict -> global jax arrays sharded on ``axis`` (leading
    dim) or fully replicated.  Works identically on single-process and
    multi-process meshes (every process passes the same host values)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    spec = P(axis) if axis else P()
    out = {}
    for k, v in arrays.items():
        sh = NamedSharding(mesh, spec)
        out[k] = jax.make_array_from_callback(v.shape, sh,
                                              lambda idx, v=v: v[idx])
    return out


def collect_global(arr) -> np.ndarray | None:
    """Materialize a (possibly multi-process) global array on the host.

    Single-process meshes: plain np.asarray.  Multi-process: each process
    fills the slices it can address and leaves the rest zero — callers on
    a shared filesystem sum/compare per-process dumps (tests) or
    all-gather on device first (production).  Returns None if this
    process addresses no shard (pure evaluator processes).
    """
    import jax

    if getattr(arr, "is_fully_addressable", True):
        return np.asarray(arr)
    out = np.zeros(arr.shape, arr.dtype)
    seen = False
    for s in arr.addressable_shards:
        out[s.index] = np.asarray(s.data)
        seen = True
    return out if seen else None


def make_chunks(n_reads: int, chunk_size: int) -> list[dict]:
    """Equal-size chunk descriptors (equal so every chunk reuses one
    compiled program shape).  n_reads must divide evenly; pad the
    workload to a multiple upstream (make_workload does)."""
    if n_reads % chunk_size:
        raise ValueError(f"n_reads={n_reads} not a multiple of "
                         f"chunk_size={chunk_size}")
    return [{"chunk": c, "lo": c * chunk_size, "hi": (c + 1) * chunk_size}
            for c in range(n_reads // chunk_size)]


def make_workload(path: str | os.PathLike, n_reads: int = 64,
                  n_haps: int = 8, read_len: int = 24, hap_len: int = 40,
                  seed: int = 0) -> None:
    """Write a self-contained workload .npz (host arrays, unsharded) that
    workers mmap-load and slice per chunk."""
    from jax.sharding import Mesh

    import jax

    from mgl_tpu.parallel.pipeline import make_example_inputs

    # reuse the tested input builder on a 1x1 mesh, then strip to host
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("dp", "hp"))
    reads, haps, ref = make_example_inputs(
        mesh, r_per_dev=n_reads, h_per_dev=n_haps,
        read_len=read_len, hap_len=hap_len, seed=seed)
    out = {f"read_{k}": np.asarray(v) for k, v in reads.items()}
    out.update({f"hap_{k}": np.asarray(v) for k, v in haps.items()})
    out.update({f"ref_{k}": np.asarray(v) for k, v in ref.items()})
    np.savez(path, **out)


def load_workload(path: str | os.PathLike):
    with np.load(path) as z:
        reads = {k: z[f"read_{k}"] for k in READ_KEYS}
        haps = {k: z[f"hap_{k}"] for k in HAP_KEYS}
        ref = {k: z[f"ref_{k}"] for k in REF_KEYS}
    return reads, haps, ref


class ChunkRunner:
    """Compile-once pipeline executor for equal-size read chunks on one
    (local or global) mesh."""

    def __init__(self, mesh, haps: dict, ref: dict, impl: str = "auto"):
        from mgl_tpu.parallel.pipeline import pipeline_step

        self.mesh = mesh
        self.step = pipeline_step(mesh, impl=impl)
        self.haps = shard_host_arrays(mesh, haps, "hp")
        self.ref = shard_host_arrays(mesh, ref, None)

    def run(self, reads: dict, lo: int, hi: int) -> dict[str, np.ndarray]:
        sub = {k: np.ascontiguousarray(reads[k][lo:hi]) for k in READ_KEYS}
        sharded = shard_host_arrays(self.mesh, sub, "dp")
        out = self.step(sharded, self.haps, self.ref)
        return {k: collect_global(out[k]) for k in OUT_KEYS}


def worker_main(host: str, port: int, name: str, workload: str,
                out_dir: str, mesh_shape: tuple[int, int] = (2, 2),
                impl: str = "xla", heartbeat_ttl: float = 5.0,
                hang_chunk: int = -1) -> int:
    """Elastic worker process: local mesh, drain chunks, atomic commits.

    ``hang_chunk``: test hook — on leasing that chunk the worker wedges
    mid-shard (its heartbeat thread keeps the lease alive) so the harness
    can kill -9 it; only then do heartbeats stop and the lease re-queue.
    """
    import jax
    from jax.sharding import Mesh

    from mgl_tpu.parallel.transport import run_worker
    from mgl_tpu.pipelines.checkpoint import save_chunk_atomic
    from mgl_tpu.utils.logging import get_logger

    log = get_logger("launcher")
    dp, hp = mesh_shape
    devs = jax.devices()[: dp * hp]
    mesh = Mesh(np.array(devs).reshape(dp, hp), ("dp", "hp"))
    reads, haps, ref = load_workload(workload)
    runner = ChunkRunner(mesh, haps, ref, impl=impl)

    def work(payload):
        c = payload["chunk"]
        if c == hang_chunk:
            log.warning("%s wedging on chunk %d (test hook)", name, c)
            time.sleep(3600)
        arrays = runner.run(reads, payload["lo"], payload["hi"])
        save_chunk_atomic(out_dir, c, arrays)
        return c

    n = run_worker((host, port), work, name, heartbeat_ttl=heartbeat_ttl)
    log.info("%s committed %d chunks", name, n)
    return n


def serve_chunks(n_items: int, out_dir: str, chunk_size: int,
                 port: int = 0, lease_ttl: float = 10.0,
                 heartbeat_ttl: float = 5.0, tag: str = "scaleout"):
    """Driver core: serve pending chunk descriptors over TCP until
    workers finish them.

    Returns (server, run, chunks): the caller spawns/points workers at
    ``server.address``, then calls :func:`finish` to wait + assemble.
    Restart-safe: completed chunks (from the ledger OR orphaned chunk
    files of a previous crashed run) are never re-dispatched.
    """
    from mgl_tpu.parallel.elastic import ShardCoordinator
    from mgl_tpu.parallel.transport import CoordinatorServer
    from mgl_tpu.pipelines.checkpoint import CheckpointedRun

    chunks = make_chunks(n_items, chunk_size)
    run = CheckpointedRun(out_dir, len(chunks), tag=tag)
    run.rescan()
    pending = [chunks[c] for c in run.pending_chunks()]
    coord = ShardCoordinator(pending, lease_ttl=lease_ttl,
                             heartbeat_ttl=heartbeat_ttl)
    server = CoordinatorServer(coord, port=port)
    server.start()
    return server, run, chunks


def run_scaleout(workload: str, out_dir: str, chunk_size: int,
                 port: int = 0, lease_ttl: float = 10.0,
                 heartbeat_ttl: float = 5.0, tag: str = "scaleout"):
    """Pipeline (PairHMM + SW + sort) scale-out driver over a
    :func:`make_workload` .npz."""
    reads, _, _ = load_workload(workload)
    return serve_chunks(len(reads["rslen"]), out_dir, chunk_size,
                        port=port, lease_ttl=lease_ttl,
                        heartbeat_ttl=heartbeat_ttl, tag=tag)


def save_map_workload(path: str | os.PathLike, ref: np.ndarray,
                      reads: np.ndarray, k: int = 16) -> None:
    """Mapping workload .npz (BASELINE config 4 across hosts): one
    reference sequence + fixed-length reads.  Workers replicate the
    k-mer index from ``ref`` (SURVEY §5: reference/index replicated per
    host) and lease read-chunk descriptors."""
    np.savez(path, map_ref=np.asarray(ref, np.uint8),
             map_reads=np.asarray(reads, np.uint8), map_k=np.int64(k))


def load_map_workload(path: str | os.PathLike):
    with np.load(path) as z:
        return z["map_ref"], z["map_reads"], int(z["map_k"])


def map_worker_main(host: str, port: int, name: str, workload: str,
                    out_dir: str, with_cigar: bool = False,
                    heartbeat_ttl: float = 5.0, hang_chunk: int = -1) -> int:
    """Elastic mapping worker: build the index once (replicated per
    host), drain read-chunk leases through ``map_reads_stream``, commit
    chunk outputs atomically.  Same failure story as :func:`worker_main`:
    a killed worker stops heartbeating and its chunks re-dispatch."""
    from mgl_tpu.parallel.transport import run_worker
    from mgl_tpu.pipelines.checkpoint import save_chunk_atomic
    from mgl_tpu.pipelines.mapper import ReferenceIndex, map_reads_stream
    from mgl_tpu.utils.logging import get_logger

    log = get_logger("launcher")
    ref, reads, k = load_map_workload(workload)
    index = ReferenceIndex.build(ref, k=k)

    def work(payload):
        c = payload["chunk"]
        if c == hang_chunk:
            log.warning("%s wedging on chunk %d (test hook)", name, c)
            time.sleep(3600)
        lo, hi = payload["lo"], payload["hi"]
        out = map_reads_stream(index, reads[lo:hi], chunk=hi - lo,
                               with_cigar=with_cigar)
        arrays = {key: np.asarray(out[key]) for key in MAP_OUT_KEYS}
        if with_cigar:
            arrays["cigar"] = np.array([s.encode() for s in out["cigar"]],
                                       dtype=np.bytes_)
        save_chunk_atomic(out_dir, c, arrays)
        return c

    n = run_worker((host, port), work, name, heartbeat_ttl=heartbeat_ttl)
    log.info("%s committed %d map chunks", name, n)
    return n


def run_scaleout_map(workload: str, out_dir: str, chunk_size: int,
                     port: int = 0, lease_ttl: float = 10.0,
                     heartbeat_ttl: float = 5.0):
    """Mapping scale-out driver over a :func:`save_map_workload` .npz."""
    _, reads, _ = load_map_workload(workload)
    return serve_chunks(len(reads), out_dir, chunk_size, port=port,
                        lease_ttl=lease_ttl, heartbeat_ttl=heartbeat_ttl,
                        tag="scaleout-map")


def assemble_map_output(run) -> dict:
    """Chunk ledger -> global mapping output (chunk-ordered concat; read
    order is the workload order, so this is bit-comparable to a
    single-process ``map_reads_stream`` over the same chunk size)."""
    assert run.complete(), "chunk files missing"
    out = {k: run.assemble(k) for k in MAP_OUT_KEYS}
    if "cigar" in run.load_chunk(0):
        out["cigar"] = np.array([c.decode() for c in run.assemble("cigar")],
                                dtype=object)
    return out


def assemble_output(run) -> dict:
    """Chunk ledger -> global output: chunk-ordered concat of the dense
    arrays plus a global key order from merging the chunk-local device
    sorts (hierarchical sort — same result as one global sort)."""
    assert run.complete(), "chunk files missing"
    out = {k: run.assemble(k) for k in ("likelihoods", "best_hap_lik",
                                        "sw_scores")}
    his, los = [], []
    for c in range(run.n_chunks):
        z = run.load_chunk(c)
        his.append(z["sorted_key_hi"])
        los.append(z["sorted_key_lo"])
    hi = np.concatenate(his).astype(np.uint64)
    lo = np.concatenate(los).astype(np.uint64)
    keys = (hi << np.uint64(32)) | lo
    out["sorted_keys"] = keys[np.argsort(keys, kind="stable")]
    return out


def finish(server, run, poll: float = 0.1, timeout: float = 600.0,
           assemble=None) -> dict:
    """Wait for the coordinator to drain, reconcile the ledger, and
    assemble the global output (``assemble``: :func:`assemble_output`
    for pipeline runs — the default — or :func:`assemble_map_output`)."""
    deadline = time.monotonic() + timeout
    while not server.coord.done():
        if time.monotonic() > deadline:
            raise TimeoutError(f"scale-out stalled: {server.coord.stats()}")
        time.sleep(poll)
    server.stop()
    run.rescan()
    return (assemble or assemble_output)(run)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="mgl-scaleout")
    sub = p.add_subparsers(dest="role", required=True)
    w = sub.add_parser("worker", help="elastic shard worker")
    w.add_argument("host")
    w.add_argument("port", type=int)
    w.add_argument("name")
    w.add_argument("workload")
    w.add_argument("out_dir")
    w.add_argument("--mesh", default="2x2")
    w.add_argument("--impl", default="xla")
    w.add_argument("--heartbeat-ttl", type=float, default=5.0)
    w.add_argument("--hang-chunk", type=int, default=-1)
    m = sub.add_parser("map-worker", help="elastic mapping worker")
    m.add_argument("host")
    m.add_argument("port", type=int)
    m.add_argument("name")
    m.add_argument("workload")
    m.add_argument("out_dir")
    m.add_argument("--cigar", action="store_true")
    m.add_argument("--heartbeat-ttl", type=float, default=5.0)
    m.add_argument("--hang-chunk", type=int, default=-1)
    args = p.parse_args(argv)
    if args.role == "worker":
        dp, hp = (int(x) for x in args.mesh.split("x"))
        worker_main(args.host, args.port, args.name, args.workload,
                    args.out_dir, mesh_shape=(dp, hp), impl=args.impl,
                    heartbeat_ttl=args.heartbeat_ttl,
                    hang_chunk=args.hang_chunk)
        return 0
    if args.role == "map-worker":
        map_worker_main(args.host, args.port, args.name, args.workload,
                        args.out_dir, with_cigar=args.cigar,
                        heartbeat_ttl=args.heartbeat_ttl,
                        hang_chunk=args.hang_chunk)
        return 0
    return 2


if __name__ == "__main__":
    sys.exit(main())
