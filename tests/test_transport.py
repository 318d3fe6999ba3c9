"""Elastic coordinator over real TCP: in-process protocol tests plus the
2-process kill -9 integration (VERDICT r1 item 8)."""

import os
import pathlib
import signal
import subprocess
import sys
import time

import pytest

from mgl_tpu.parallel.elastic import ShardCoordinator
from mgl_tpu.parallel.transport import (CoordinatorClient, CoordinatorServer,
                                        run_worker)

HELPER = pathlib.Path(__file__).parent / "helpers" / "elastic_worker.py"


def test_transport_roundtrip_and_idempotent_commit():
    coord = ShardCoordinator([{"x": i} for i in range(4)], lease_ttl=5.0,
                             heartbeat_ttl=5.0)
    with CoordinatorServer(coord) as srv:
        c = CoordinatorClient(srv.address)
        sid, payload = c.lease("w1")
        assert payload == {"x": sid}
        c.heartbeat("w1")
        assert c.complete("w1", sid, payload["x"] * 10) is True
        # double completion does not overwrite
        assert c.complete("w2", sid, -1) is False
        assert c.done() is False
        st = c.stats()
        assert st["done"] == 1 and st["queued"] == 3
        # drain the rest through the worker loop
        n = run_worker(srv.address, lambda p: p["x"] * 10, "w1",
                       heartbeat_ttl=5.0)
        assert n == 3
        assert c.results() == {i: i * 10 for i in range(4)}
        c.close()


def test_transport_client_reconnects():
    coord = ShardCoordinator([{"x": 1}], lease_ttl=5.0, heartbeat_ttl=5.0)
    with CoordinatorServer(coord) as srv:
        c = CoordinatorClient(srv.address, retry_wait=0.05)
        assert c.done() is False
        c._sock.close()                    # sever the connection under it
        assert c.done() is False           # transparent reconnect
        c.close()


def test_two_process_kill9_failover():
    """Two real worker *processes*; one is SIGKILLed mid-shard.  The
    coordinator reaps its lease after the heartbeat TTL and the surviving
    process completes every shard."""
    hb_ttl = 1.0
    shards = [{"x": i, "t": 0.05} for i in range(10)]
    shards[0]["hang_for"] = "victim"       # victim grabs this and stalls
    coord = ShardCoordinator(shards, lease_ttl=2.0, heartbeat_ttl=hb_ttl)
    with CoordinatorServer(coord) as srv:
        host, port = srv.address
        env = {**os.environ, "JAX_PLATFORMS": "cpu"}

        def spawn(name):
            return subprocess.Popen(
                [sys.executable, str(HELPER), host, str(port), name,
                 str(hb_ttl)], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

        victim = spawn("victim")
        # wait until the victim holds the hang shard
        c = CoordinatorClient(srv.address)
        deadline = time.time() + 60
        while time.time() < deadline:
            if c.stats()["leased"] >= 1:
                break
            time.sleep(0.05)
        assert c.stats()["leased"] >= 1, "victim never leased"
        survivor = spawn("survivor")
        time.sleep(0.3)
        victim.send_signal(signal.SIGKILL)

        out, err = survivor.communicate(timeout=150)
        assert survivor.returncode == 0, err
        assert coord.done(), coord.stats()
        res = coord.results()
        assert res == {i: shards[i]["x"] ** 2 for i in range(10)}
        st = coord.stats()
        assert st["attempts"] >= 11        # the hang shard was re-leased
        assert "victim" in st["dead_workers"]
        victim.wait(timeout=10)
        c.close()
