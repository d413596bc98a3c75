"""The port's cross-process transport: frames, handshake, PlanServer, workers.

Mirrors ``tests/test_transport.py`` on ``repro_torch.core.transport`` (a
verbatim copy) and ``repro_torch.launch.replica_worker``: the frame codec
and handshake, byte-identical plans over the wire, typed rejection frames,
and a process group that survives a ``SIGKILL`` with nothing lost.  A
worker is the port's (``-m repro_torch.launch.replica_worker``) and imports
neither torch nor JAX: the import boundary is checked in a fresh
interpreter and, through ``python -X importtime``, in a spawned worker.
Every socket read, wait and subprocess carries its own timeout.
"""
import os
import pickle
import socket
import struct
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

import repro.core as ref_core
from repro_torch.core import (
    AdmissionRejectedError,
    FaultInjector,
    PartitionService,
    synthetic_mesh_graph,
    synthetic_random_graph,
)
from repro_torch.core.transport import (
    WIRE_MAGIC,
    DeadlineExceeded,
    PlanServer,
    ProtocolError,
    RemoteReplica,
    ReplicaConnection,
    WireError,
    _check_handshake,
    recv_frame,
    send_frame,
)
from repro_torch.launch import replica_worker
from repro_torch.launch.replica_worker import spawn_process_group, spawn_worker

ROOT = Path(__file__).resolve().parents[1]
_LEN = struct.Struct(">I")


def _wait(pred, timeout=10.0, dt=0.005):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred():
            return True
        time.sleep(dt)
    return pred()


def _foreign(modules) -> list:
    return sorted(m for m in modules
                  if m.split(".")[0] in ("torch", "jax", "jaxlib", "repro", "triton"))


class TestFrameCodec:
    def test_round_trip_preserves_arrays(self):
        a, b = socket.socketpair()
        try:
            payload = {"labels": np.arange(257, dtype=np.int32),
                       "nested": {"k": 4, "fp": "abc" * 40}}
            send_frame(a, payload)
            got = recv_frame(b, deadline_s=5.0)
            np.testing.assert_array_equal(got["labels"], payload["labels"])
            assert got["nested"] == payload["nested"]
        finally:
            a.close()
            b.close()

    def test_truncated_frame_raises_protocol_error(self):
        a, b = socket.socketpair()
        try:
            a.sendall(_LEN.pack(1 << 20) + b"severed")
            a.close()
            with pytest.raises(ProtocolError, match="mid-frame"):
                recv_frame(b, deadline_s=5.0)
        finally:
            b.close()

    def test_oversized_length_prefix_rejected(self):
        a, b = socket.socketpair()
        try:
            a.sendall(_LEN.pack((1 << 30) + 1))
            with pytest.raises(ProtocolError, match="exceeds cap"):
                recv_frame(b, deadline_s=5.0)
        finally:
            a.close()
            b.close()

    def test_undecodable_body_raises_protocol_error(self):
        a, b = socket.socketpair()
        try:
            body = b"\x00\x01not a pickle"
            a.sendall(_LEN.pack(len(body)) + body)
            with pytest.raises(ProtocolError, match="undecodable"):
                recv_frame(b, deadline_s=5.0)
        finally:
            a.close()
            b.close()

    def test_recv_deadline_raises_deadline_exceeded(self):
        a, b = socket.socketpair()
        try:
            with pytest.raises(DeadlineExceeded):
                recv_frame(b, deadline_s=0.05)
        finally:
            a.close()
            b.close()

    def test_handshake_version_and_magic_checked(self):
        with pytest.raises(ProtocolError, match="version"):
            _check_handshake({"magic": WIRE_MAGIC, "version": 99}, "peer")
        with pytest.raises(ProtocolError, match="protocol"):
            _check_handshake({"magic": "something-else", "version": 1}, "peer")
        with pytest.raises(ProtocolError):
            _check_handshake(b"GET / HTTP/1.1", "peer")


@pytest.fixture
def inproc_server():
    svc = PartitionService(workers=1)
    server = PlanServer(svc).start()
    yield svc, server
    server.shutdown()
    svc.close()


class TestPlanServerInProcess:
    def test_submit_over_wire_is_byte_identical(self, inproc_server):
        svc, server = inproc_server
        rep = RemoteReplica(server.address)
        try:
            sp = rep.submit(synthetic_mesh_graph(18, seed=7), 4).result(60)
            local = svc.plan_cache.peek(sp.fingerprint)
            assert local is not None and local is not sp
            assert sp.fingerprint == local.fingerprint
            np.testing.assert_array_equal(sp.result.labels, local.result.labels)
            for name in ("x_gidx", "y_gidx", "x_lidx", "y_lidx"):
                np.testing.assert_array_equal(getattr(sp.plan, name) if sp.plan else None,
                                              getattr(local.plan, name) if local.plan else None)
        finally:
            rep.close()

    def test_wire_plan_equals_reference_plan(self, inproc_server):
        """A plan that crossed the port's wire equals the JAX package's plan
        for the same graph."""
        _svc, server = inproc_server
        rep = RemoteReplica(server.address)
        try:
            sp = rep.submit(synthetic_random_graph(120, 400, seed=5), 4).result(60)
        finally:
            rep.close()
        with ref_core.PartitionService(workers=1) as ref_svc:
            want = ref_svc.submit(ref_core.synthetic_random_graph(120, 400, seed=5),
                                  4).result(60)
        assert sp.fingerprint == want.fingerprint
        np.testing.assert_array_equal(sp.result.labels, want.result.labels)

    def test_bad_handshake_dropped_server_keeps_serving(self, inproc_server):
        _svc, server = inproc_server
        raw = socket.create_connection(server.address, timeout=5)
        try:
            send_frame(raw, {"magic": WIRE_MAGIC, "version": 99}, 5.0)
            raw.settimeout(5)
            assert raw.recv(1) == b""
        finally:
            raw.close()
        conn = ReplicaConnection(server.address)
        assert conn.call("ping")["pid"] == os.getpid()
        conn.close()

    def test_severed_connection_keeps_tickets(self, inproc_server):
        _svc, server = inproc_server
        rep = RemoteReplica(server.address)
        try:
            t = rep.submit(synthetic_random_graph(150, 500, seed=11), 4)
            rep.sever_connection(mid_frame=True)
            sp = t.result(60)
            assert sp is not None and sp.fingerprint
            assert rep._conn.reconnects >= 1
        finally:
            rep.close()

    def test_gossip_pull_push_round_trip(self, inproc_server):
        _svc, server = inproc_server
        rep = RemoteReplica(server.address)
        svc2 = PartitionService(workers=1)
        server2 = PlanServer(svc2).start()
        rep2 = RemoteReplica(server2.address)
        try:
            sp = rep.submit(synthetic_mesh_graph(16, seed=3), 4).result(60)
            assert sp.fingerprint in rep.gossip_fingerprints()
            entries = rep.gossip_pull([sp.fingerprint])
            assert [e[0] for e in entries] == [sp.fingerprint]
            assert rep2.gossip_push(entries) == 1
            assert sp.fingerprint in rep2.gossip_fingerprints()
            pulled = rep2.gossip_pull([sp.fingerprint])[0][3]
            np.testing.assert_array_equal(pulled.result.labels, sp.result.labels)
        finally:
            rep2.close()
            server2.shutdown()
            svc2.close()
            rep.close()

    def test_unknown_op_and_unknown_ticket_raise_wire_error(self, inproc_server):
        _svc, server = inproc_server
        conn = ReplicaConnection(server.address)
        with pytest.raises(WireError, match="unknown op"):
            conn.call("bogus")
        with pytest.raises(WireError, match="unknown ticket"):
            conn.call("poll", {"ticket": 999_999})
        assert conn.call("ping")["closed"] is False
        conn.close()


class TestOverloadOverWire:
    def test_rejection_is_typed_frame_not_severed_connection(self):
        svc = PartitionService(workers=1, max_queue_depth=1)
        gate, started = threading.Event(), threading.Event()

        def hook(_key):
            started.set()
            gate.wait(10)

        svc.scheduler.pre_job_hook = hook
        server = PlanServer(svc).start()
        rep = RemoteReplica(server.address)
        try:
            graphs = [synthetic_mesh_graph(14 + 2 * i, seed=40 + i) for i in range(3)]
            t0 = rep.submit(graphs[0], 4)
            assert started.wait(10)
            t1 = rep.submit(graphs[1], 4)
            with pytest.raises(AdmissionRejectedError) as ei:
                rep.submit(graphs[2], 4)
            err = ei.value
            assert err.reason == "queue_full" and err.tenant == "default"
            assert err.retry_after_s > 0
            assert rep._conn.reconnects == 0 and rep._conn._fails == 0
            back = pickle.loads(pickle.dumps(err))
            assert back.__reduce__()[1] == err.__reduce__()[1]
            gate.set()
            assert t0.result(60).fingerprint and t1.result(60).fingerprint
            assert rep.submit(graphs[2], 4).result(60).fingerprint
            assert rep._conn.reconnects == 0
        finally:
            gate.set()
            rep.close()
            server.shutdown()
            svc.close()

    def test_worker_process_surfaces_rejection(self):
        h = spawn_worker(queue_bound=1, stalls=[(1.0, 0, 1 << 30)], startup_timeout_s=60.0)
        rep = RemoteReplica(h.address, process=h.proc, pid=h.pid)
        try:
            assert _wait(rep.heartbeat, 10)
            graphs = [synthetic_mesh_graph(14 + 2 * i, seed=50 + i) for i in range(3)]
            rep.submit(graphs[0], 4)
            time.sleep(0.25)
            rep.submit(graphs[1], 4)
            with pytest.raises(AdmissionRejectedError) as ei:
                rep.submit(graphs[2], 4)
            assert ei.value.reason == "queue_full" and ei.value.retry_after_s > 0
            assert rep._conn.reconnects == 0
        finally:
            rep.close()
        assert _wait(lambda: h.proc.poll() is not None, 10)


class TestWorkerProcess:
    def test_worker_command_names_the_port(self, monkeypatch):
        seen = {}

        class Stop(Exception):
            pass

        def fake_popen(cmd, **kw):
            seen["cmd"], seen["env"] = cmd, kw["env"]
            raise Stop

        monkeypatch.setattr(replica_worker.subprocess, "Popen", fake_popen)
        with pytest.raises(Stop):
            spawn_worker()
        assert seen["cmd"][1:3] == ["-m", "repro_torch.launch.replica_worker"]
        assert seen["env"]["PYTHONPATH"].split(os.pathsep)[0] == str(ROOT / "src")

    def test_core_and_worker_import_no_torch_or_jax(self):
        code = ("import sys, repro_torch.core, repro_torch.launch.replica_worker; "
                "print(sorted(m for m in sys.modules if m.split('.')[0] in "
                "('torch', 'jax', 'jaxlib', 'repro', 'triton')))")
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
        out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                             env=env, timeout=120)
        assert out.returncode == 0, out.stderr
        assert out.stdout.strip() == "[]"

    def test_spawned_worker_imports_no_torch_or_jax(self, tmp_path):
        """A worker that partitions a graph and sends it over the wire has
        imported neither torch nor JAX (its ``-X importtime`` log)."""
        log = tmp_path / "imports.log"
        wrapper = tmp_path / "python"
        wrapper.write_text(f'#!/bin/sh\nexec "{sys.executable}" -X importtime "$@" '
                           f'2> "{log}"\n')
        wrapper.chmod(0o755)
        h = spawn_worker(python=str(wrapper), startup_timeout_s=60.0)
        rep = RemoteReplica(h.address, process=h.proc, pid=h.pid)
        try:
            assert _wait(rep.heartbeat, 10)
            assert rep.submit(synthetic_mesh_graph(16, seed=2), 4).result(60).fingerprint
        finally:
            rep.close()
        assert _wait(lambda: h.proc.poll() is not None, 10)
        imported = [line.rsplit("|", 1)[-1].strip() for line in log.read_text().splitlines()
                    if line.startswith("import time:") and "|" in line]
        assert "repro_torch.core.transport" in imported
        assert _foreign(imported) == []

    def test_remote_worker_byte_identical_and_kill(self):
        edges = synthetic_mesh_graph(18, seed=7)
        local = PartitionService(workers=1)
        try:
            ref = local.submit(edges, 4).result(120)
        finally:
            local.close()
        h = spawn_worker(startup_timeout_s=60.0)
        rep = RemoteReplica(h.address, process=h.proc, pid=h.pid)
        try:
            assert _wait(rep.heartbeat, 10)
            assert rep.pid != os.getpid()
            sp = rep.submit(edges, 4).result(120)
            assert sp.fingerprint == ref.fingerprint
            np.testing.assert_array_equal(sp.result.labels, ref.result.labels)
            rep.sigkill()
            assert _wait(lambda: not rep.heartbeat(), 10)
            with pytest.raises((WireError, ConnectionError, OSError)):
                rep.submit(edges, 8)
        finally:
            rep.close()
        assert _wait(lambda: h.proc.poll() is not None, 10)

    def test_process_group_sigkill_failover_loses_nothing(self):
        inj = FaultInjector(seed=0).sigkill_after_jobs("r1", 1)
        stalls = [[(0.15, 0, 3)], [(0.15, 0, 3)]]
        with spawn_process_group(
                2, injector=inj, hedge=False, retry_budget=5,
                backoff_base_s=0.01, heartbeat_deadline_s=1.0,
                stalls_per_replica=stalls) as g:
            graphs = [synthetic_random_graph(150 + 10 * i, 500, seed=20 + i) for i in range(6)]
            tickets = [g.submit(e, 4, tenant=f"t{i % 2}") for i, e in enumerate(graphs)]
            plans = [t.result(180) for t in tickets]
            assert all(sp is not None and sp.fingerprint for sp in plans)
            assert len({sp.fingerprint for sp in plans}) == len(plans)
            assert not any(t.stale for t in tickets)
            assert any(e[0] == "sigkill" for e in inj.events)
            rm = g.replica_metrics()
            assert rm.lost == 0
            killed = next(r for r in g._replicas if r.rid == "r1")
            assert _wait(lambda: killed.svc.process.poll() is not None, 10)
