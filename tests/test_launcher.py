"""Multi-process scale-out launcher (VERDICT r2 item 1 — the last open
SURVEY §5 row): TCP coordinator + chunk checkpoints + sharded pipeline
composed across real OS processes, with kill -9 resilience, plus the
jax.distributed (SPMD pod-mode) path over a genuine cross-process global
mesh with gloo collectives."""

import os
import pathlib
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from mgl_tpu.parallel.launcher import (ChunkRunner, assemble_output, finish,
                                       load_workload, make_chunks,
                                       make_workload, run_scaleout)
from mgl_tpu.parallel.transport import CoordinatorClient
from mgl_tpu.pipelines.checkpoint import CheckpointedRun

REPO = pathlib.Path(__file__).resolve().parent.parent
HELPERS = pathlib.Path(__file__).parent / "helpers"


def _child_env():
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "JAX_NUM_CPU_DEVICES": "4",
           "PYTHONPATH": f"{REPO}:{os.environ.get('PYTHONPATH', '')}"}
    # workers size their own device pool; drop the test-process flag
    env["XLA_FLAGS"] = " ".join(
        f for f in env.get("XLA_FLAGS", "").split()
        if "xla_force_host_platform_device_count" not in f)
    return env


def _single_process_baseline(workload, out_dir, chunk_size):
    """Same chunking, same per-chunk program, one process."""
    import jax
    from jax.sharding import Mesh

    reads, haps, ref = load_workload(workload)
    mesh = Mesh(np.array(jax.devices("cpu")[:4]).reshape(2, 2), ("dp", "hp"))
    runner = ChunkRunner(mesh, haps, ref, impl="xla")
    chunks = make_chunks(len(reads["rslen"]), chunk_size)
    run = CheckpointedRun(out_dir, len(chunks), tag="scaleout")
    for ch in chunks:
        run.save_chunk(ch["chunk"], runner.run(reads, ch["lo"], ch["hi"]))
    return assemble_output(run)


def test_scaleout_kill9_bit_identical(tmp_path):
    """Two worker OS processes drain a chunked workload through the TCP
    coordinator; one is kill -9ed while wedged mid-chunk (heartbeats
    flowing -> only SIGKILL frees the lease).  The survivor finishes and
    the assembled output is bit-identical to a single-process run."""
    workload = str(tmp_path / "work.npz")
    make_workload(workload, n_reads=64, n_haps=8)
    chunk_size = 16

    base = _single_process_baseline(workload, tmp_path / "base", chunk_size)

    out_dir = tmp_path / "dist"
    out_dir.mkdir()
    hb_ttl = 1.0
    server, run, chunks = run_scaleout(workload, str(out_dir), chunk_size,
                                       lease_ttl=2.0, heartbeat_ttl=hb_ttl)
    host, port = server.address

    def spawn(name, *extra):
        return subprocess.Popen(
            [sys.executable, "-m", "mgl_tpu.parallel.launcher", "worker",
             host, str(port), name, workload, str(out_dir),
             "--impl", "xla", "--heartbeat-ttl", str(hb_ttl), *extra],
            env=_child_env(), cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    victim = spawn("victim", "--hang-chunk", "0")
    c = CoordinatorClient(server.address)
    deadline = time.time() + 120
    while time.time() < deadline:       # wait until the victim is wedged
        if c.stats()["leased"] >= 1:
            break
        time.sleep(0.05)
    assert c.stats()["leased"] >= 1, "victim never leased a chunk"
    survivor = spawn("survivor")
    time.sleep(0.5)
    victim.send_signal(signal.SIGKILL)

    out = finish(server, run, timeout=300)
    _, err = survivor.communicate(timeout=300)
    assert survivor.returncode == 0, err
    victim.wait(timeout=10)
    st = server.coord.stats()
    assert "victim" in st["dead_workers"]

    for k in ("likelihoods", "best_hap_lik", "sw_scores", "sorted_keys"):
        np.testing.assert_array_equal(out[k], base[k], err_msg=k)

    # restart safety: a new driver over the same ledger has nothing to do
    server2, run2, _ = run_scaleout(workload, str(out_dir), chunk_size)
    try:
        assert server2.coord.done()
        assert run2.pending_chunks() == []
    finally:
        server2.stop()


def test_spmd_two_process_global_mesh(tmp_path):
    """Pod-mode: two OS processes join one jax.distributed cluster (the
    init_runtime hook), build ONE global 8-device mesh, and run the same
    sharded pipeline_step — collectives (pmax over hp, bitonic sort over
    dp) cross the process boundary over gloo.  Per-process dumps of the
    addressable slices sum to exactly the single-process result."""
    workload = str(tmp_path / "work.npz")
    make_workload(workload, n_reads=32, n_haps=8)

    port = _free_port()
    procs, outs = [], []
    for pid in range(2):
        out_npz = tmp_path / f"spmd_{pid}.npz"
        outs.append(out_npz)
        procs.append(subprocess.Popen(
            [sys.executable, str(HELPERS / "spmd_worker.py"), str(pid), "2",
             str(port), workload, str(out_npz)],
            env=_child_env(), cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    errs = []
    for p in procs:
        _, err = p.communicate(timeout=300)
        errs.append(err)
        assert p.returncode == 0, err

    # single-process reference on an identical (4, 2) mesh
    import jax
    from jax.sharding import Mesh

    reads, haps, ref = load_workload(workload)
    mesh = Mesh(np.array(jax.devices("cpu")[:8]).reshape(4, 2),
                ("dp", "hp"))
    ref_out = ChunkRunner(mesh, haps, ref, impl="xla").run(
        reads, 0, len(reads["rslen"]))

    for k in ("likelihoods", "best_hap_lik", "sw_scores",
              "sorted_key_hi", "sorted_key_lo"):
        with np.load(outs[0]) as z0, np.load(outs[1]) as z1:
            merged = z0[k] + z1[k]      # disjoint addressable slices
        np.testing.assert_array_equal(merged, ref_out[k], err_msg=k)


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_scaleout_map_kill9_bit_identical(tmp_path, monkeypatch):
    """Elastic mapping mode (BASELINE config 4 'data-parallel across
    hosts'): worker OS processes replicate the reference index, lease
    read chunks over TCP, and commit full mapper outputs (incl. CIGARs)
    atomically; one worker is kill -9ed while wedged mid-chunk and the
    assembled output is bit-identical to a single-process
    map_reads_stream over the same chunk size."""
    from mgl_tpu.parallel.launcher import (MAP_OUT_KEYS,
                                           assemble_map_output,
                                           run_scaleout_map,
                                           save_map_workload)
    from mgl_tpu.pipelines.mapper import ReferenceIndex, map_reads_stream

    rng = np.random.default_rng(21)
    BASES = np.frombuffer(b"ACGT", np.uint8)
    ref = rng.choice(BASES, size=50_000)
    N, L, chunk_size = 192, 100, 64
    starts = rng.integers(100, len(ref) - L - 100, size=N)
    reads = ref[starts[:, None] + np.arange(L)[None, :]].copy()
    for i in range(0, N, 3):            # SNP reads (certified-diagonal tier)
        p = int(rng.integers(10, L - 10))
        reads[i, p] = BASES[(int(np.searchsorted(BASES, reads[i, p])) + 1) % 4]
    for i in range(1, N, 16):           # 2bp-deletion reads (traceback tier)
        s = int(starts[i])
        reads[i] = np.concatenate([ref[s: s + 50], ref[s + 52: s + L + 2]])

    workload = tmp_path / "map.npz"
    save_map_workload(workload, ref, reads)

    idx = ReferenceIndex.build(ref, k=16)
    base = map_reads_stream(idx, reads, chunk=chunk_size, with_cigar=True)
    assert (base["pos"] >= 0).mean() > 0.95

    out_dir = tmp_path / "dist"
    out_dir.mkdir()
    hb_ttl = 1.0
    server, run, chunks = run_scaleout_map(str(workload), str(out_dir),
                                           chunk_size, lease_ttl=2.0,
                                           heartbeat_ttl=hb_ttl)
    host, port = server.address
    env = _child_env()

    def spawn(name, *extra):
        return subprocess.Popen(
            [sys.executable, "-m", "mgl_tpu.parallel.launcher", "map-worker",
             host, str(port), name, str(workload), str(out_dir), "--cigar",
             "--heartbeat-ttl", str(hb_ttl), *extra],
            env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    victim = spawn("victim", "--hang-chunk", "0")
    c = CoordinatorClient(server.address)
    deadline = time.time() + 180
    while time.time() < deadline:       # wait until the victim is wedged
        if c.stats()["leased"] >= 1:
            break
        time.sleep(0.05)
    assert c.stats()["leased"] >= 1, "victim never leased a chunk"
    survivor = spawn("survivor")
    time.sleep(0.5)
    victim.send_signal(signal.SIGKILL)

    from mgl_tpu.parallel.launcher import finish as _finish

    out = _finish(server, run, timeout=600, assemble=assemble_map_output)
    _, err = survivor.communicate(timeout=300)
    assert survivor.returncode == 0, err
    victim.wait(timeout=10)
    assert "victim" in server.coord.stats()["dead_workers"]

    for k in MAP_OUT_KEYS:
        np.testing.assert_array_equal(out[k], base[k], err_msg=k)
    assert list(out["cigar"]) == list(base["cigar"])
