# Copied verbatim from src/repro/core/transport.py; keep the two in step.
"""Cross-process replica transport: socket-backed ``PartitionService``.

``ReplicaGroup`` (core/replica.py) was built so a replica is anything that
duck-types the small service surface its driver loop touches.  This module
provides that surface over a real network boundary:

* **Frame protocol** — length-prefixed (4-byte big-endian) pickled frames
  over local TCP.  The first frame each way is a handshake carrying a
  protocol magic + version (:data:`WIRE_MAGIC` / :data:`WIRE_VERSION`); a
  mismatch fails loudly before any RPC flows.  Plan payloads reuse the
  ``plan_cache`` persistence format — gossip frames carry the exact
  ``{"magic", "version", "entries"}`` envelope :meth:`PlanCache.save`
  writes to disk, validated by the same code on the way in.
* **Per-RPC deadlines** — every call carries a deadline; the socket is
  armed with it on both send and receive, so a stalled (``SIGSTOP``-ed)
  worker surfaces as :class:`DeadlineExceeded` instead of a hang.  A
  deadline miss also drops the connection: the late reply would otherwise
  desync the request/response stream.
* **Connection supervisor** — :class:`ReplicaConnection` reconnects lazily
  with capped exponential backoff.  A severed or reset connection is
  re-established on the next call; while the backoff window is open, calls
  fail fast with :class:`WireError` (which the group treats as failover).
* **Server** — :class:`PlanServer` hosts one ``PartitionService`` behind an
  accept loop (one handler thread per connection; the ticket table is
  server-global, so a reconnecting client can keep polling tickets it
  submitted on a previous connection — a severed socket loses no work).
* **Adapter** — :class:`RemoteReplica` implements the replica surface the
  group uses (``submit`` / ``update_async`` / ``plan_cache`` peek+put /
  ``metrics`` / ``stats`` / ``close``) plus the wire-only extensions:
  rate-limited ``heartbeat()`` pings (the group only credits a beat when
  the worker answers), ``gossip_*`` for pairwise plan-store anti-entropy,
  and process-level fault probes (``sigkill`` / ``sigstop`` / a mid-frame
  socket sever) for the chaos bench.

The subprocess entrypoint that pairs with this lives in
``repro.launch.replica_worker`` (core must not depend on launch).
"""
from __future__ import annotations

import os
import pickle
import signal
import socket
import struct
import threading
import time
from typing import Any, Callable, Optional

from .partition_service import PartitionService, ServiceStats
from .plan_cache import PERSIST_MAGIC, PERSIST_VERSION
from .plan_scheduler import ServiceClosedError, ServiceMetrics, _latency_summary

__all__ = [
    "WIRE_MAGIC",
    "WIRE_VERSION",
    "WireError",
    "ProtocolError",
    "DeadlineExceeded",
    "send_frame",
    "recv_frame",
    "ReplicaConnection",
    "PlanServer",
    "RemoteReplica",
]

WIRE_MAGIC = "repro-plan-wire"
WIRE_VERSION = 1

_LEN = struct.Struct(">I")
MAX_FRAME_BYTES = 1 << 30


class WireError(ConnectionError):
    """Transport-level failure: connect refused, reset, or backoff open."""


class ProtocolError(WireError):
    """Malformed traffic: bad handshake, truncated frame, undecodable body."""


class DeadlineExceeded(TimeoutError):
    """A per-RPC deadline expired before the peer answered."""


# ---------------------------------------------------------------------------
# Frame codec
# ---------------------------------------------------------------------------


def send_frame(sock: socket.socket, obj: Any, deadline_s: float | None = None) -> None:
    """Pickle ``obj`` and write it as one length-prefixed frame."""
    body = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    if len(body) > MAX_FRAME_BYTES:
        raise ProtocolError(f"frame too large: {len(body)} bytes")
    sock.settimeout(deadline_s)
    try:
        sock.sendall(_LEN.pack(len(body)) + body)
    except socket.timeout as e:
        raise DeadlineExceeded(f"send deadline ({deadline_s}s) expired") from e


def _recv_exact(sock: socket.socket, n: int, what: str,
                deadline_s: float | None) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except socket.timeout as e:
            raise DeadlineExceeded(
                f"recv deadline ({deadline_s}s) expired reading {what}") from e
        if not chunk:
            raise ProtocolError(
                f"connection closed mid-{what} ({len(buf)}/{n} bytes)")
        buf += chunk
    return bytes(buf)


def recv_frame(sock: socket.socket, deadline_s: float | None = None) -> Any:
    """Read one length-prefixed frame and unpickle it.

    A short read (peer died or severed the socket mid-frame) raises
    :class:`ProtocolError`; an expired deadline raises
    :class:`DeadlineExceeded`.
    """
    sock.settimeout(deadline_s)
    (n,) = _LEN.unpack(_recv_exact(sock, _LEN.size, "header", deadline_s))
    if n > MAX_FRAME_BYTES:
        raise ProtocolError(f"frame length {n} exceeds cap {MAX_FRAME_BYTES}")
    body = _recv_exact(sock, n, "frame", deadline_s)
    try:
        return pickle.loads(body)
    except Exception as e:  # corrupt body is a protocol failure, not a crash
        raise ProtocolError(f"undecodable frame body: {e!r}") from e


def _handshake_frame() -> dict:
    return {"magic": WIRE_MAGIC, "version": WIRE_VERSION, "pid": os.getpid()}


def _check_handshake(frame: Any, who: str) -> dict:
    if not isinstance(frame, dict) or frame.get("magic") != WIRE_MAGIC:
        raise ProtocolError(f"{who} did not speak the plan-wire protocol")
    if frame.get("version") != WIRE_VERSION:
        raise ProtocolError(
            f"{who} protocol version {frame.get('version')!r} "
            f"not supported (expected {WIRE_VERSION})")
    return frame


# ---------------------------------------------------------------------------
# Client connection supervisor
# ---------------------------------------------------------------------------


class ReplicaConnection:
    """One client connection to a :class:`PlanServer`, with supervision.

    Calls are serialized under a lock (one in-flight RPC per connection).
    The socket is (re)established lazily: after a failure, reconnect
    attempts are paced by capped exponential backoff — inside the backoff
    window calls raise :class:`WireError` immediately, which the replica
    group treats like any other lane failure.
    """

    def __init__(
        self,
        address: tuple[str, int],
        *,
        connect_timeout_s: float = 5.0,
        default_deadline_s: float = 10.0,
        reconnect_base_s: float = 0.05,
        reconnect_cap_s: float = 2.0,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.address = (address[0], int(address[1]))
        self.connect_timeout_s = connect_timeout_s
        self.default_deadline_s = default_deadline_s
        self.reconnect_base_s = reconnect_base_s
        self.reconnect_cap_s = reconnect_cap_s
        self._clock = clock
        self._lock = threading.RLock()
        self._sock: Optional[socket.socket] = None
        self._next_id = 1
        self._fails = 0
        self._next_attempt_t = 0.0
        self._ever_connected = False
        self.server_pid: Optional[int] = None
        self.reconnects = 0

    @property
    def connected(self) -> bool:
        return self._sock is not None

    def _drop_locked(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _connect_locked(self) -> None:
        now = self._clock()
        if self._fails > 0 and now < self._next_attempt_t:
            raise WireError(
                f"reconnect to {self.address} backing off another "
                f"{self._next_attempt_t - now:.3f}s (attempt {self._fails})")
        try:
            sock = socket.create_connection(
                self.address, timeout=self.connect_timeout_s)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            send_frame(sock, _handshake_frame(), self.connect_timeout_s)
            hello = _check_handshake(
                recv_frame(sock, self.connect_timeout_s), "server")
        except (OSError, WireError, DeadlineExceeded) as e:
            self._fails += 1
            delay = min(self.reconnect_cap_s,
                        self.reconnect_base_s * (2.0 ** (self._fails - 1)))
            self._next_attempt_t = now + delay
            raise WireError(f"connect to {self.address} failed: {e}") from e
        if self._ever_connected or self._fails > 0:
            self.reconnects += 1  # re-established, whether severed or refused
        self._ever_connected = True
        self._fails = 0
        self.server_pid = hello.get("pid")
        self._sock = sock

    def call(self, op: str, args: dict | None = None,
             deadline_s: float | None = None) -> Any:
        """One RPC round trip; returns the response value or raises the
        server-side exception (transported pickled)."""
        deadline = deadline_s if deadline_s is not None else self.default_deadline_s
        with self._lock:
            if self._sock is None:
                self._connect_locked()
            rid = self._next_id
            self._next_id += 1
            try:
                send_frame(self._sock, {"id": rid, "op": op,
                                        "args": args or {},
                                        "deadline_s": deadline}, deadline)
                resp = recv_frame(self._sock, deadline)
            except DeadlineExceeded:
                # The reply may still arrive later and would desync the
                # stream; a deadline miss costs the connection.
                self._drop_locked()
                raise
            except (ProtocolError, OSError) as e:
                self._drop_locked()
                raise WireError(f"rpc {op!r} to {self.address} failed: {e}") from e
            if not isinstance(resp, dict) or resp.get("id") != rid:
                self._drop_locked()
                raise ProtocolError(f"rpc id mismatch answering {op!r}")
            if not resp.get("ok"):
                err = resp.get("error")
                if isinstance(err, BaseException):
                    raise err
                raise WireError(f"rpc {op!r} failed remotely: {err}")
            return resp.get("value")

    def sever(self, mid_frame: bool = True) -> None:
        """Fault probe: cut the connection, optionally mid-frame.

        ``mid_frame=True`` writes a length prefix promising bytes that never
        come, so the *server* exercises its truncated-read recovery path too
        (handler drops the connection; the accept loop keeps serving)."""
        with self._lock:
            if self._sock is None:
                return
            if mid_frame:
                try:
                    self._sock.settimeout(0.5)
                    self._sock.sendall(_LEN.pack(1 << 20) + b"severed")
                except OSError:
                    pass
            self._drop_locked()

    def close(self) -> None:
        with self._lock:
            self._drop_locked()


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------


class PlanServer:
    """Hosts one ``PartitionService`` behind the frame protocol.

    One handler thread per accepted connection; the ticket table is shared
    across connections so a client that reconnects (severed socket, process
    restart on the client side) can keep polling tickets it already
    submitted.  A malformed or truncated frame drops that connection only.
    """

    def __init__(self, service: PartitionService, host: str = "127.0.0.1",
                 port: int = 0) -> None:
        self.service = service
        self._listener = socket.create_server((host, port))
        self.address: tuple[str, int] = self._listener.getsockname()[:2]
        self._tickets: dict[int, Any] = {}
        self._next_tid = 1
        self._lock = threading.Lock()
        self._shutdown = threading.Event()
        self._accept_thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self.address[1]

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "PlanServer":
        """Run the accept loop on a daemon thread (in-process use/tests)."""
        self._accept_thread = threading.Thread(
            target=self.serve_forever, name="plan-server-accept", daemon=True)
        self._accept_thread.start()
        return self

    def serve_forever(self) -> None:
        """Blocking accept loop; returns after :meth:`shutdown`."""
        self._listener.settimeout(0.2)
        try:
            while not self._shutdown.is_set():
                try:
                    conn, _addr = self._listener.accept()
                except socket.timeout:
                    continue
                except OSError:
                    break
                threading.Thread(target=self._handle, args=(conn,),
                                 name="plan-server-conn", daemon=True).start()
        finally:
            try:
                self._listener.close()
            except OSError:
                pass

    def shutdown(self) -> None:
        self._shutdown.set()

    # -- per-connection handler --------------------------------------------

    def _handle(self, conn: socket.socket) -> None:
        try:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            _check_handshake(recv_frame(conn, 10.0), "client")
            send_frame(conn, _handshake_frame(), 10.0)
            while not self._shutdown.is_set():
                try:
                    msg = recv_frame(conn, None)
                except (ProtocolError, DeadlineExceeded):
                    return  # truncated/corrupt/idle-severed: drop this conn
                resp: dict = {"id": msg.get("id") if isinstance(msg, dict) else None}
                try:
                    if not isinstance(msg, dict):
                        raise ProtocolError("rpc frame is not a dict")
                    resp["value"] = self._dispatch(msg.get("op"),
                                                   msg.get("args") or {})
                    resp["ok"] = True
                except BaseException as e:
                    resp["ok"] = False
                    resp["error"] = e
                try:
                    send_frame(conn, resp, 10.0)
                except ProtocolError:
                    return
                except Exception:
                    # Unpicklable error/value: still answer, degraded.
                    send_frame(conn, {"id": resp["id"], "ok": False,
                                      "error": WireError(
                                          f"unserializable response for "
                                          f"{msg.get('op')!r}")}, 10.0)
        except (OSError, WireError, DeadlineExceeded):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    # -- ops ----------------------------------------------------------------

    def _register(self, ticket: Any) -> int:
        with self._lock:
            tid = self._next_tid
            self._next_tid += 1
            self._tickets[tid] = ticket
            return tid

    def _dispatch(self, op: str, args: dict) -> Any:
        svc = self.service
        if op == "ping":
            return {"pid": os.getpid(), "closed": svc.closed}
        if op == "submit":
            # An admission rejection raised here leaves _dispatch as a
            # typed error frame ({"ok": False, "error": e}) — the client
            # re-raises it with retry_after_s intact; the connection stays
            # up (rejection is an answer, not a transport failure).
            ticket = svc.submit(
                args["edges"], args["k"], method=args.get("method", "ep"),
                opts=args.get("opts"), seed=args.get("seed", 0),
                pad=args.get("pad", 128), coo=args.get("coo"),
                tenant=args.get("tenant", "default"),
                priority=args.get("priority", 0),
                timeout=args.get("timeout"))
            return {"ticket": self._register(ticket),
                    "cache_hit": ticket.cache_hit}
        if op == "update":
            ticket = svc.update_async(
                args["base_fingerprint"], args["k"],
                insert_u=args.get("insert_u"), insert_v=args.get("insert_v"),
                delete_ids=args.get("delete_ids"),
                method=args.get("method", "ep"), opts=args.get("opts"),
                seed=args.get("seed", 0), pad=args.get("pad", 128),
                tenant=args.get("tenant", "default"),
                priority=args.get("priority", 0),
                timeout=args.get("timeout"))
            return {"ticket": self._register(ticket),
                    "cache_hit": ticket.cache_hit}
        if op == "poll":
            tid = args["ticket"]
            with self._lock:
                ticket = self._tickets.get(tid)
            if ticket is None:
                raise WireError(f"unknown ticket {tid}")
            if not ticket.done():
                return {"done": False}
            with self._lock:
                self._tickets.pop(tid, None)
            try:
                plan = ticket.result(0)
            except BaseException as e:
                return {"done": True, "ok": False, "error": e}
            return {"done": True, "ok": True, "plan": plan,
                    "cache_hit": ticket.cache_hit}
        if op == "cancel":
            with self._lock:
                ticket = self._tickets.pop(args["ticket"], None)
            return {"cancelled": bool(ticket.cancel()) if ticket is not None
                    else False}
        if op == "fingerprints":
            return svc.plan_cache.fingerprints()
        if op == "gossip_pull":
            return svc.plan_cache.snapshot_payload(args.get("fingerprints"))
        if op == "gossip_push":
            return {"admitted": svc.plan_cache.admit_payload(
                args["payload"], source="gossip frame")}
        if op == "metrics":
            return svc.metrics()
        if op == "stats":
            return svc.stats
        if op == "default_opts":
            return svc.default_opts
        if op == "close":
            svc.close()
            self.shutdown()
            return {"closed": True}
        raise WireError(f"unknown op {op!r}")


# ---------------------------------------------------------------------------
# Client-side ticket + adapter
# ---------------------------------------------------------------------------


class _RemoteTicket:
    """``PlanTicket``-shaped client future, resolved by polling the worker.

    A broken connection resolves the ticket with ``ServiceClosedError`` —
    exactly what a drained local queue raises — so the group driver's
    existing failover path handles a dead worker without a special case.
    A *deadline* miss (stalled worker) leaves the ticket pending: the
    heartbeat machinery, not the ticket, decides that replica is suspect.
    """

    def __init__(self, conn: ReplicaConnection, tid: int,
                 poll_deadline_s: float) -> None:
        self._conn = conn
        self._tid = tid
        self._poll_deadline_s = poll_deadline_s
        self._done = False
        self._value: Any = None
        self._error: Optional[BaseException] = None
        self.cache_hit = False
        self.cancelled = False

    def done(self) -> bool:
        if self._done:
            return True
        try:
            v = self._conn.call("poll", {"ticket": self._tid},
                                deadline_s=self._poll_deadline_s)
        except DeadlineExceeded:
            return False
        except (WireError, ConnectionError, OSError) as e:
            self._error = ServiceClosedError(
                f"replica connection lost polling ticket {self._tid}: {e}")
            self._done = True
            return True
        if v["done"]:
            if v["ok"]:
                self._value = v["plan"]
                self.cache_hit = bool(v.get("cache_hit", self.cache_hit))
            else:
                self._error = v["error"]
            self._done = True
        return self._done

    def cancel(self, buffer=None) -> bool:
        self.cancelled = True
        try:
            v = self._conn.call("cancel", {"ticket": self._tid},
                                deadline_s=self._poll_deadline_s)
            return bool(v.get("cancelled"))
        except (WireError, ConnectionError, OSError, DeadlineExceeded):
            return False

    def result(self, timeout: float | None = None) -> Any:
        deadline = None if timeout is None else time.monotonic() + timeout
        while not self.done():
            if deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError("partition not ready")
            time.sleep(0.002)
        if self._error is not None:
            raise self._error
        return self._value


class _RemoteCacheView:
    """``plan_cache``-shaped peek/put over the gossip RPCs, so the group's
    update path (seed the base plan into whichever replica computes) works
    unchanged against a remote worker."""

    def __init__(self, replica: "RemoteReplica") -> None:
        self._replica = replica

    def peek(self, fingerprint: str):
        plans = self._replica.gossip_pull([fingerprint])
        for fp, _tenant, _pinned, plan in plans:
            if fp == fingerprint:
                return plan
        return None

    def put(self, plan, tenant: str = "default") -> None:
        self._replica.gossip_push([(plan.fingerprint, tenant, False, plan)])


class _RemoteSchedulerStub:
    """Accepts the ``pre_job_hook`` assignment the group makes when a
    FaultInjector is attached.  The hook cannot cross the process boundary
    — worker-side stalls are configured at spawn time
    (``replica_worker --stall``) — so the assignment is kept but unused."""

    def __init__(self) -> None:
        self.pre_job_hook: Optional[Callable[[Any], None]] = None


def _empty_metrics() -> ServiceMetrics:
    return ServiceMetrics(
        queue_depth=0, workers=0, busy_workers=0, utilization=0.0,
        executor="remote", jobs_completed=0, jobs_failed=0,
        cancelled_queued=0, cancelled_inflight=0, coalesced=0,
        latency_s=_latency_summary([]), queue_wait_s=_latency_summary([]),
        tenants={})


_UNSET = object()


class RemoteReplica:
    """Client adapter: one socket-backed replica worker process.

    Duck-types the surface ``ReplicaGroup._Replica`` bookkeeping touches on
    a local ``PartitionService`` — hand a list of these to
    ``ReplicaGroup(replicas=[...])`` and failover, hedging, health, and
    stale-serve run unchanged over the wire.  ``metrics()``/``stats`` on an
    unreachable worker degrade to empty snapshots rather than raising, so
    group aggregation survives a dead member.
    """

    def __init__(
        self,
        address: tuple[str, int],
        *,
        process=None,
        pid: Optional[int] = None,
        rpc_deadline_s: float = 10.0,
        poll_deadline_s: float = 1.0,
        heartbeat_deadline_s: float = 0.25,
        heartbeat_interval_s: float = 0.05,
        connect_timeout_s: float = 5.0,
        reconnect_base_s: float = 0.05,
        reconnect_cap_s: float = 2.0,
    ) -> None:
        self._conn = ReplicaConnection(
            address, connect_timeout_s=connect_timeout_s,
            default_deadline_s=rpc_deadline_s,
            reconnect_base_s=reconnect_base_s, reconnect_cap_s=reconnect_cap_s)
        self.process = process
        self._pid = pid
        self.rpc_deadline_s = rpc_deadline_s
        self.poll_deadline_s = poll_deadline_s
        self.heartbeat_deadline_s = heartbeat_deadline_s
        self.heartbeat_interval_s = heartbeat_interval_s
        self._closed = False
        self._default_opts: Any = _UNSET
        self._hb_lock = threading.Lock()
        self._hb_t = -1e18
        self._hb_ok = False
        self.scheduler = _RemoteSchedulerStub()
        self.plan_cache = _RemoteCacheView(self)

    # -- identity -----------------------------------------------------------

    @property
    def address(self) -> tuple[str, int]:
        return self._conn.address

    @property
    def pid(self) -> Optional[int]:
        if self._pid is not None:
            return self._pid
        if self.process is not None:
            return self.process.pid
        return self._conn.server_pid

    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def default_opts(self):
        if self._default_opts is _UNSET:
            try:
                self._default_opts = self._conn.call(
                    "default_opts", deadline_s=self.rpc_deadline_s)
            except (WireError, ConnectionError, OSError, DeadlineExceeded):
                return None
        return self._default_opts

    # -- service surface ----------------------------------------------------

    def submit(self, edges, k, method="ep", opts=None, seed=0, pad=128,
               coo=None, buffer=None, tenant="default", priority=0,
               timeout=None) -> _RemoteTicket:
        v = self._conn.call("submit", {
            "edges": edges, "k": k, "method": method, "opts": opts,
            "seed": seed, "pad": pad, "coo": coo, "tenant": tenant,
            "priority": priority, "timeout": timeout},
            deadline_s=self.rpc_deadline_s)
        ticket = _RemoteTicket(self._conn, v["ticket"], self.poll_deadline_s)
        ticket.cache_hit = bool(v["cache_hit"])
        return ticket

    def update_async(self, base_fingerprint, k, insert_u=None, insert_v=None,
                     delete_ids=None, method="ep", opts=None, seed=0, pad=128,
                     buffer=None, tenant="default", priority=0,
                     timeout=None) -> _RemoteTicket:
        v = self._conn.call("update", {
            "base_fingerprint": base_fingerprint, "k": k,
            "insert_u": insert_u, "insert_v": insert_v,
            "delete_ids": delete_ids, "method": method, "opts": opts,
            "seed": seed, "pad": pad, "tenant": tenant,
            "priority": priority, "timeout": timeout},
            deadline_s=self.rpc_deadline_s)
        ticket = _RemoteTicket(self._conn, v["ticket"], self.poll_deadline_s)
        ticket.cache_hit = bool(v["cache_hit"])
        return ticket

    def metrics(self) -> ServiceMetrics:
        try:
            return self._conn.call("metrics", deadline_s=self.rpc_deadline_s)
        except (WireError, ConnectionError, OSError, DeadlineExceeded):
            return _empty_metrics()

    @property
    def stats(self) -> ServiceStats:
        try:
            return self._conn.call("stats", deadline_s=self.rpc_deadline_s)
        except (WireError, ConnectionError, OSError, DeadlineExceeded):
            return ServiceStats()

    # -- wire-only surface --------------------------------------------------

    def heartbeat(self) -> bool:
        """Rate-limited liveness ping; True iff the worker answered.

        The group credits a beat only on True, so heartbeats genuinely
        travel over the wire: a ``SIGKILL``-ed worker fails the ping
        (connect refused), a ``SIGSTOP``-ed one times out the short
        deadline.  Between pings the last outcome is returned, bounding how
        long the group lock can be held on a stalled worker.
        """
        with self._hb_lock:
            now = time.monotonic()
            if now - self._hb_t < self.heartbeat_interval_s:
                return self._hb_ok
            self._hb_t = now
            try:
                self._conn.call("ping", deadline_s=self.heartbeat_deadline_s)
                self._hb_ok = True
            except (WireError, ConnectionError, OSError, DeadlineExceeded):
                self._hb_ok = False
            return self._hb_ok

    def gossip_fingerprints(self) -> list[str]:
        return list(self._conn.call("fingerprints",
                                    deadline_s=self.rpc_deadline_s))

    def gossip_pull(self, fingerprints: list[str]) -> list[tuple]:
        """Pull the named plans as persistence-format entries."""
        if not fingerprints:
            return []
        payload = self._conn.call("gossip_pull",
                                  {"fingerprints": list(fingerprints)},
                                  deadline_s=self.rpc_deadline_s)
        if (not isinstance(payload, dict)
                or payload.get("magic") != PERSIST_MAGIC
                or payload.get("version") != PERSIST_VERSION):
            raise ProtocolError("gossip frame is not a plan-cache payload")
        return list(payload["entries"])

    def gossip_push(self, entries: list[tuple]) -> int:
        """Push persistence-format ``(fp, tenant, pinned, plan)`` entries."""
        if not entries:
            return 0
        payload = {"magic": PERSIST_MAGIC, "version": PERSIST_VERSION,
                   "entries": list(entries)}
        v = self._conn.call("gossip_push", {"payload": payload},
                            deadline_s=self.rpc_deadline_s)
        return int(v.get("admitted", 0))

    # -- fault probes -------------------------------------------------------

    def sigkill(self) -> None:
        """Process probe: ``kill -9`` the worker (no cleanup, no goodbye)."""
        pid = self.pid
        if pid is not None:
            os.kill(pid, signal.SIGKILL)

    def sigstop(self) -> None:
        """Process probe: pause the worker; it holds sockets but answers
        nothing, so only the per-RPC deadlines reveal it."""
        pid = self.pid
        if pid is not None:
            os.kill(pid, signal.SIGSTOP)

    def sigcont(self) -> None:
        pid = self.pid
        if pid is not None:
            os.kill(pid, signal.SIGCONT)

    def sever_connection(self, mid_frame: bool = True) -> None:
        """Network probe: cut this client's socket, by default mid-frame so
        the server side exercises truncated-read recovery too."""
        self._conn.sever(mid_frame=mid_frame)

    # -- lifecycle ----------------------------------------------------------

    def close(self, timeout_s: float = 5.0) -> None:
        """Graceful remote close, then reap the worker process (SIGKILL
        fallback covers workers that are stopped or already gone)."""
        if self._closed:
            return
        self._closed = True
        try:
            self._conn.call("close", deadline_s=2.0)
        except (WireError, ConnectionError, OSError, DeadlineExceeded):
            pass
        self._conn.close()
        proc = self.process
        if proc is not None and proc.poll() is None:
            try:
                proc.wait(timeout=timeout_s)
            except Exception:
                try:
                    os.kill(proc.pid, signal.SIGKILL)
                    proc.wait(timeout=timeout_s)
                except Exception:
                    pass

    def __enter__(self) -> "RemoteReplica":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
