# Copied verbatim from src/repro/core/replica.py; keep the two in step.
"""Replicated plan service: N ``PartitionService`` replicas, one facade.

The paper's bet is that scheduling work pays only if the partition plan is
*always there* on the hot path; a single service process makes every tenant
one crash away from cold-start latency.  :class:`ReplicaGroup` runs N
replicas behind the same submit/get surface ``GraphServer`` already speaks:

* **Health** — built on :class:`~repro.runtime.fault.HeartbeatRegistry`.
  A replica beats once per group-observed job completion (idle replicas are
  beaten on the pump so silence means *stuck*, not *unused*); a missed
  deadline marks it suspect and drains its routing weight to zero until it
  beats again.
* **Failover** — a ticket in flight on a crashed or suspect replica is
  resubmitted to a healthy one.  Resubmission is idempotent by plan
  fingerprint (the same request re-keys to the same plan, so the target's
  cache/coalescing absorbs duplicates), paced by exponential backoff with
  seeded jitter, and bounded by a per-ticket retry budget — exhaustion
  raises the typed :class:`ReplicaExhaustedError`.
* **Hedging** — when the primary lane is slower than a p99-derived hedge
  delay, a secondary submit fires on a different replica; first complete
  wins and the loser is cancelled through the existing ``PlanScheduler``
  cancellation path (queued → dropped, in-flight → marked, coalesced →
  detached).
* **Shared plan store** — completed plans are published into a group-owned
  :class:`~repro.core.plan_cache.PlanCache`; the anti-entropy pump copies
  fingerprints each replica is missing back into its local cache on a sync
  interval, so a warm hit on any replica is a warm hit on all.  Replicas
  behind a process boundary (``core/transport.py``'s ``RemoteReplica``)
  sync by pairwise gossip instead: fingerprint-digest exchange, then
  pull/push only the missing entries over the wire.
* **Graceful degradation** — when every replica is suspect/crashed, the
  group serves the freshest cached plan with ``ticket.stale = True``
  (surfaced as ``ServeInfo.stale`` by the request layer) instead of
  erroring; only with nothing cached does it raise.

Every group request is driven by a small state machine on a dedicated
daemon thread (submit → poll → hedge → failover → resolve), so callers keep
the plain future surface (``ticket.result(timeout)``) and identical
concurrent requests coalesce onto one driver.  :class:`FaultInjector`
provides deterministic, seeded crash/stall/heartbeat-drop schedules (with an
injectable clock) for the tests and ``benchmarks/svc_chaos.py``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from collections import deque
from typing import Any, Callable, Optional, Sequence

import numpy as np

from ..runtime.fault import CircuitBreaker, HeartbeatRegistry, OverloadSchedule
from .graph import EdgeList, affinity_graph_from_coo
from .partition import MultilevelOptions
from .partition_service import (
    DoubleBuffer,
    PartitionService,
    ServicePlan,
    ServiceStats,
    graph_fingerprint,
)
from .plan_cache import PlanCache
from .plan_scheduler import (
    AdmissionRejectedError,
    PlanTicket,
    ServiceClosedError,
    ServiceMetrics,
    _latency_summary,
)

__all__ = [
    "FaultInjector",
    "ReplicaExhaustedError",
    "ReplicaGroup",
    "ReplicaMetrics",
    "ReplicaStats",
    "ReplicaTicket",
]


class ReplicaExhaustedError(RuntimeError):
    """No replica could complete the request within the retry budget, and no
    cached plan was available to serve stale."""


def _pct(xs: list[float], p: float) -> float:
    if not xs:
        return 0.0
    ys = sorted(xs)
    return ys[min(len(ys) - 1, int(p * len(ys)))]


# ---------------------------------------------------------------------------
# Deterministic fault injection
# ---------------------------------------------------------------------------


class FaultInjector:
    """Seeded, deterministic fault schedules for a :class:`ReplicaGroup`.

    Three fault kinds, all scheduled up front so a chaos run replays
    identically:

    * ``crash_after_jobs(rid, n)`` / ``crash_at(rid, t_s)`` — the group
      kills the replica once it has completed ``n`` group-observed jobs /
      once ``t_s`` seconds (injected clock) have passed since :meth:`arm`.
    * ``stall_jobs(rid, delay_s, first, last)`` — jobs ``first..last``
      (0-based, per-replica dispatch order) sleep ``delay_s`` before
      executing, via ``PlanScheduler.pre_job_hook`` — a straggler, not a
      corpse: the work still completes.
    * ``drop_heartbeats(rid, count)`` — the next ``count`` beats for the
      replica are swallowed, so a live replica goes suspect exactly when
      the schedule says.

    Process-level probes (meaningful for socket-backed replicas, see
    ``core/transport.py``) schedule real OS faults by completed-job count:

    * ``sigkill_after_jobs(rid, n)`` — ``kill -9`` the worker process: no
      drain, no goodbye; only wire errors and missed heartbeats reveal it.
    * ``sigstop_after_jobs(rid, n)`` — pause the worker: it holds its
      sockets but answers nothing, so per-RPC deadlines are the only
      detection signal.
    * ``sever_after_jobs(rid, n)`` — cut the replica's client socket
      mid-frame; the connection supervisor must reconnect and no ticket
      may be lost.

    The group fires these from the pump (``process_fault_due``) against
    replicas that expose the matching probe surface; for in-process
    replicas ``sigkill`` degrades to a plain :meth:`ReplicaGroup.kill`
    and the other two are no-ops.

    The injector records every fired event in ``events`` (kind, replica,
    t_rel) for assertions and bench reporting.
    """

    def __init__(self, seed: int = 0, clock: Callable[[], float] = time.monotonic) -> None:
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.clock = clock
        self._t0: Optional[float] = None
        self._crash_jobs: dict[str, int] = {}
        self._crash_at: dict[str, float] = {}
        self._stalls: dict[str, list[tuple[int, int, float]]] = {}
        self._drops: dict[str, int] = {}
        self._dispatched: dict[str, int] = {}
        self._process_faults: dict[str, list[tuple[str, int]]] = {}
        self._overload: Optional[OverloadSchedule] = None
        self._flood_logged: set[str] = set()
        self._lock = threading.Lock()
        self.events: list[tuple[str, str, float]] = []

    # -- schedule builders (chainable) --------------------------------------

    def crash_after_jobs(self, replica: str, jobs: int) -> "FaultInjector":
        self._crash_jobs[replica] = int(jobs)
        return self

    def crash_at(self, replica: str, t_s: float) -> "FaultInjector":
        self._crash_at[replica] = float(t_s)
        return self

    def stall_jobs(self, replica: str, delay_s: float, first: int = 0,
                   last: Optional[int] = None) -> "FaultInjector":
        hi = (1 << 30) if last is None else int(last)
        self._stalls.setdefault(replica, []).append((int(first), hi, float(delay_s)))
        return self

    def drop_heartbeats(self, replica: str, count: int) -> "FaultInjector":
        self._drops[replica] = self._drops.get(replica, 0) + int(count)
        return self

    def sigkill_after_jobs(self, replica: str, jobs: int) -> "FaultInjector":
        self._process_faults.setdefault(replica, []).append(
            ("sigkill", int(jobs)))
        return self

    def sigstop_after_jobs(self, replica: str, jobs: int) -> "FaultInjector":
        self._process_faults.setdefault(replica, []).append(
            ("sigstop", int(jobs)))
        return self

    def sever_after_jobs(self, replica: str, jobs: int) -> "FaultInjector":
        self._process_faults.setdefault(replica, []).append(
            ("sever", int(jobs)))
        return self

    def flood(self, tenant: str, factor: float, start_s: float = 0.0,
              duration_s: float = 1.0) -> "FaultInjector":
        """Arm a per-tenant overload window: during ``[start_s, start_s +
        duration_s)`` of injected time, :meth:`flood_factor` reports
        ``factor`` — the rate multiplier a bench's load generator applies to
        that tenant.  Windows compose via :class:`OverloadSchedule`, so a
        chaos run's flood phase replays identically."""
        if self._overload is None:
            self._overload = OverloadSchedule(clock=self.now)
        self._overload.add(tenant, start_s, duration_s, factor)
        return self

    def flood_factor(self, tenant: str) -> float:
        """Current load multiplier for ``tenant`` (1.0 outside windows).
        The first in-window probe per tenant logs a ``flood`` event."""
        if self._overload is None:
            return 1.0
        f = self._overload.factor_at(tenant)
        if f != 1.0:
            with self._lock:
                first = tenant not in self._flood_logged
                self._flood_logged.add(tenant)
            if first:
                self._log("flood", tenant)
        return f

    # -- group-facing probes ------------------------------------------------

    def arm(self) -> None:
        """Start the injected clock; called by the group at construction."""
        if self._t0 is None:
            self._t0 = self.clock()

    def now(self) -> float:
        return 0.0 if self._t0 is None else self.clock() - self._t0

    def _log(self, kind: str, replica: str) -> None:
        self.events.append((kind, replica, self.now()))

    def job_dispatched(self, replica: str) -> float:
        """Per-replica dispatch tick; returns the stall delay for this job."""
        with self._lock:
            i = self._dispatched.get(replica, 0)
            self._dispatched[replica] = i + 1
            for first, last, delay in self._stalls.get(replica, ()):
                if first <= i <= last:
                    self._log("stall", replica)
                    return delay
        return 0.0

    def crash_due(self, replica: str, jobs_completed: int) -> bool:
        """True once the replica's scheduled crash point has been reached."""
        with self._lock:
            jobs = self._crash_jobs.get(replica)
            if jobs is not None and jobs_completed >= jobs:
                del self._crash_jobs[replica]
                self._log("crash", replica)
                return True
            t = self._crash_at.get(replica)
            if t is not None and self.now() >= t:
                del self._crash_at[replica]
                self._log("crash", replica)
                return True
        return False

    def process_fault_due(self, replica: str, jobs_completed: int) -> Optional[str]:
        """The next due process-level fault kind for the replica, or None.
        Each scheduled fault fires exactly once (and is logged)."""
        with self._lock:
            for i, (kind, jobs) in enumerate(self._process_faults.get(replica, ())):
                if jobs_completed >= jobs:
                    del self._process_faults[replica][i]
                    self._log(kind, replica)
                    return kind
        return None

    def take_heartbeat(self, replica: str) -> bool:
        """False when this beat is scheduled to be dropped."""
        with self._lock:
            left = self._drops.get(replica, 0)
            if left > 0:
                self._drops[replica] = left - 1
                self._log("drop_beat", replica)
                return False
        return True


# ---------------------------------------------------------------------------
# Tickets and metrics
# ---------------------------------------------------------------------------


class ReplicaTicket:
    """Group-level future; same waiting surface as ``PlanTicket``.

    Extra fields over a plain ticket: ``stale`` (resolved from the shared
    store because no replica was healthy), ``retries`` (failover
    resubmissions consumed), ``hedged`` (a secondary lane fired), and
    ``replica`` (the id that served it; None for store hits).  Group tickets
    are not cancellable — the group itself owns lane lifecycle — so
    :meth:`cancel` only detaches a caller's buffer.
    """

    def __init__(self, tenant: str = "default", priority: int = 0) -> None:
        self._event = threading.Event()
        self._value: Optional[ServicePlan] = None
        self._error: Optional[BaseException] = None
        self._buffers: list = []
        self._lock = threading.Lock()
        self.cache_hit = False
        self.stale = False
        self.cancelled = False
        self.tenant = tenant
        self.priority = priority
        self.retries = 0
        self.hedged = False
        self.replica: Optional[str] = None

    def _resolve(self, value: ServicePlan) -> None:
        with self._lock:
            buffers = list(self._buffers)
        for buf in buffers:
            buf.publish(value)
        self._value = value
        self._event.set()

    def _fail(self, err: BaseException) -> None:
        self._error = err
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def cancel(self, buffer: DoubleBuffer | None = None) -> bool:
        if buffer is not None:
            with self._lock:
                if buffer in self._buffers:
                    self._buffers.remove(buffer)
        return False

    def result(self, timeout: float | None = None) -> ServicePlan:
        if not self._event.wait(timeout):
            raise TimeoutError("partition not ready")
        if self._error is not None:
            raise self._error
        return self._value  # type: ignore[return-value]


@dataclasses.dataclass
class ReplicaStats:
    """Point-in-time view of one replica inside the group."""

    replica: str
    state: str  # "healthy" | "suspect" | "crashed"
    weight: float
    beats: int
    jobs_completed: int
    failovers_from: int
    hedges_to: int
    p50_ms: float
    p99_ms: float
    rejections: int = 0  # admission rejections this replica answered
    breakers_open: int = 0  # per-tenant breakers currently not closed
    breaker_trips: int = 0  # total open transitions across tenants

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class ReplicaMetrics:
    """Group-level snapshot: per-replica rows + failover/hedge counters.

    ``lost`` is the invariant the chaos bench gates on: group tickets that
    will never resolve (submitted minus resolved minus failed minus still
    pending) — it must be zero through any crash schedule.
    """

    replicas: list[ReplicaStats]
    submitted: int
    resolved: int
    failed: int
    pending: int
    coalesced: int
    failovers: int
    retries: int
    hedges_fired: int
    hedges_won: int
    hedges_lost: int
    stale_serves: int
    store_entries: int
    store_publishes: int

    @property
    def lost(self) -> int:
        return max(0, self.submitted - self.resolved - self.failed - self.pending)

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["replicas"] = [r.as_dict() if isinstance(r, ReplicaStats) else r
                         for r in self.replicas]
        d["lost"] = self.lost
        return d


# ---------------------------------------------------------------------------
# Internal request/lane records
# ---------------------------------------------------------------------------


class _Lane:
    """One attempt of a group request on one replica."""

    __slots__ = ("rid", "ticket", "kind", "t_start")

    def __init__(self, rid: str, ticket: PlanTicket, kind: str, t_start: float) -> None:
        self.rid = rid
        self.ticket = ticket
        self.kind = kind  # "primary" | "failover" | "hedge"
        self.t_start = t_start


class _GroupRequest:
    """One coalesced group-level request, driven by a dedicated thread."""

    __slots__ = ("key", "fingerprint", "base_plan", "submit_fn", "match_fn",
                 "tenant", "priority", "ticket", "waiters", "t_submit",
                 "deadline", "timeout_s", "last_rejection")

    def __init__(self, key, fingerprint, base_plan, submit_fn, match_fn,
                 tenant, priority, t_submit, deadline=None,
                 timeout_s=None) -> None:
        self.key = key
        self.fingerprint = fingerprint  # known up front for full submits
        self.base_plan = base_plan  # stale-serve fallback for updates
        self.submit_fn = submit_fn  # svc -> PlanTicket
        self.match_fn = match_fn  # plan -> bool: usable as a stale stand-in?
        self.tenant = tenant
        self.priority = priority
        self.ticket = ReplicaTicket(tenant=tenant, priority=priority)
        self.waiters = 1
        self.t_submit = t_submit
        self.deadline = deadline  # absolute (group clock); None = unbounded
        self.timeout_s = timeout_s  # the caller's timeout, for the error text
        # Freshest AdmissionRejectedError any replica answered: when the
        # retry budget dies on overload, the caller gets the typed rejection
        # (with its retry_after_s hint) instead of a generic exhaustion.
        self.last_rejection: Optional[AdmissionRejectedError] = None


class _Replica:
    """Book-keeping for one member service."""

    __slots__ = ("rid", "svc", "crashed", "inflight", "jobs_completed",
                 "beats", "failovers_from", "hedges_to", "latencies",
                 "rejections", "breakers")

    def __init__(self, rid: str, svc: PartitionService) -> None:
        self.rid = rid
        self.svc = svc
        self.crashed = False
        self.inflight = 0
        self.jobs_completed = 0
        self.beats = 0
        self.failovers_from = 0
        self.hedges_to = 0
        self.latencies: deque[float] = deque(maxlen=512)
        self.rejections = 0  # admission rejections answered by this replica
        # (tenant -> CircuitBreaker): per-tenant so a flooding tenant's
        # rejections open *its* breaker without blacklisting the replica
        # for well-behaved tenants.
        self.breakers: dict[str, CircuitBreaker] = {}


# ---------------------------------------------------------------------------
# ReplicaGroup
# ---------------------------------------------------------------------------


class ReplicaGroup:
    """N ``PartitionService`` replicas behind one submit/get facade.

    Duck-type compatible with ``PartitionService`` where ``GraphServer`` and
    the launch demos touch it: ``submit`` / ``get`` / ``get_spmv_plan`` /
    ``update_async`` / ``update`` / ``metrics()`` / ``stats`` / ``close()``
    / context manager.  Replicas must be identically configured — the group
    fingerprints requests against replica 0's defaults and treats the
    fingerprint as the idempotency key across all members.

    ``replicas`` is either a count (members built via ``factory`` or as
    plain ``PartitionService(**service_kwargs)``) or an explicit sequence of
    services — including ``core.transport.RemoteReplica`` adapters for
    workers in separate OS processes (``launch.replica_worker``), which
    slot in behind the same driver loop: heartbeats become wire pings,
    store sync becomes gossip, and a dead worker is just a replica whose
    lanes fail.  Health checking and anti-entropy run on the *pump*, which is
    called opportunistically by every submit and every driver poll tick —
    no background thread, so tests with an injected ``clock`` stay
    deterministic by calling :meth:`pump` themselves.
    """

    def __init__(
        self,
        replicas: int | Sequence[PartitionService] = 2,
        *,
        factory: Optional[Callable[[int], PartitionService]] = None,
        heartbeat_deadline_s: float = 2.0,
        sync_interval_s: float = 0.05,
        hedge: bool = True,
        hedge_delay_s: Optional[float] = None,
        hedge_p99_factor: float = 1.5,
        hedge_min_delay_s: float = 0.05,
        retry_budget: int = 3,
        backoff_base_s: float = 0.01,
        backoff_cap_s: float = 0.25,
        backoff_jitter: float = 0.5,
        breaker_failures: int = 3,
        breaker_cooldown_s: float = 1.0,
        store: Optional[PlanCache] = None,
        store_entries: int = 256,
        allow_stale: bool = True,
        injector: Optional[FaultInjector] = None,
        seed: int = 0,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
        poll_interval_s: float = 0.002,
        **service_kwargs,
    ) -> None:
        if isinstance(replicas, int):
            if replicas < 1:
                raise ValueError("need at least one replica")
            make = factory or (lambda i: PartitionService(**service_kwargs))
            services = [make(i) for i in range(replicas)]
        else:
            services = list(replicas)
            if not services:
                raise ValueError("need at least one replica")
        self._replicas = [_Replica(f"r{i}", svc) for i, svc in enumerate(services)]
        self._by_rid = {rep.rid: rep for rep in self._replicas}
        self.hedge = hedge
        self.hedge_delay_s = hedge_delay_s
        self.hedge_p99_factor = hedge_p99_factor
        self.hedge_min_delay_s = hedge_min_delay_s
        self.retry_budget = int(retry_budget)
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        self.backoff_jitter = backoff_jitter
        self.breaker_failures = int(breaker_failures)
        self.breaker_cooldown_s = breaker_cooldown_s
        self.allow_stale = allow_stale
        self.sync_interval_s = sync_interval_s
        self.poll_interval_s = poll_interval_s
        self._clock = clock
        self._sleep = sleep
        self._rng = np.random.default_rng(seed)
        self._injector = injector
        self._store = store if store is not None else PlanCache(max_entries=store_entries)
        self._store_tenant: dict[str, str] = {}
        self._registry = HeartbeatRegistry(deadline_s=heartbeat_deadline_s, clock=clock)
        self._lock = threading.RLock()
        self._inflight: dict[Any, _GroupRequest] = {}
        self._rr = 0
        self._driver_seq = 0
        self._last_sync = clock()
        self._closed = False
        # Counters (guarded by _lock).
        self._m_submitted = 0
        self._m_resolved = 0
        self._m_failed = 0
        self._m_coalesced = 0
        self._m_failovers = 0
        self._m_retries = 0
        self._m_hedges_fired = 0
        self._m_hedges_won = 0
        self._m_hedges_lost = 0
        self._m_stale = 0
        self._m_publishes = 0
        self._latencies: deque[float] = deque(maxlen=2048)
        for rep in self._replicas:
            # register(), not beat(): the deadline clock starts at
            # construction without crediting a heartbeat the replica never
            # sent — the fix that makes silent-from-birth replicas visible.
            self._registry.register(rep.rid)
            if injector is not None:
                rep.svc.scheduler.pre_job_hook = self._make_stall_hook(rep.rid)
        if injector is not None:
            injector.arm()

    def _make_stall_hook(self, rid: str) -> Callable[[Any], None]:
        def hook(_key) -> None:
            delay = self._injector.job_dispatched(rid)
            if delay > 0:
                self._sleep(delay)
        return hook

    # -- lifecycle ----------------------------------------------------------

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        """Close every replica (graceful drain each); idempotent.  Requests
        still in flight fail over normally until their replicas drain."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        for rep in self._replicas:
            rep.svc.close()

    def __enter__(self) -> "ReplicaGroup":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def kill(self, rid: str) -> None:
        """Crash a replica *now*: it stops receiving work immediately, its
        in-flight group lanes fail over, and the orphaned service is drained
        in the background (queued local tickets fail with
        ``ServiceClosedError``, which drivers also treat as failover)."""
        rep = self._by_rid[rid]
        with self._lock:
            if rep.crashed:
                return
            rep.crashed = True
        threading.Thread(target=rep.svc.close, name=f"replica-reaper-{rid}",
                         daemon=True).start()

    # -- health + anti-entropy pump -----------------------------------------

    def _weight(self, rep: _Replica) -> float:
        """Routing weight: suspect and crashed replicas are fully drained."""
        if rep.crashed or not self._registry.alive(rep.rid):
            return 0.0
        return 1.0

    def _beat(self, rep: _Replica) -> None:
        if self._injector is not None and not self._injector.take_heartbeat(rep.rid):
            return
        probe = getattr(rep.svc, "heartbeat", None)
        if probe is not None and not probe():
            # Socket-backed replica: the beat is credited only when the
            # worker actually answered a ping over the wire — a SIGKILLed
            # or SIGSTOPped worker stays silent and goes suspect on the
            # registry deadline like any stuck replica.
            return
        self._registry.beat(rep.rid)
        rep.beats += 1

    def _apply_process_fault(self, rep: _Replica, kind: str) -> None:
        """Fire a scheduled process-level fault against ``rep``.  Remote
        replicas take the real OS fault; in-process ones degrade: sigkill
        becomes a plain crash, sigstop/sever have no process to act on."""
        probe = getattr(rep.svc, kind if kind != "sever" else "sever_connection",
                        None)
        if probe is not None:
            try:
                probe()
            except OSError:
                pass  # already-dead worker: the fault is moot
        elif kind == "sigkill":
            self.kill(rep.rid)

    def pump(self) -> None:
        """One maintenance tick: fire due time-based crashes, beat idle
        replicas, run the heartbeat deadline check, and (rate-limited by
        ``sync_interval_s``) anti-entropy-sync the shared store into each
        healthy replica's local cache.  Drivers and submits call this
        continuously; deterministic tests call it manually."""
        with self._lock:
            for rep in self._replicas:
                if rep.crashed:
                    continue
                if self._injector is not None and self._injector.crash_due(
                        rep.rid, rep.jobs_completed):
                    self.kill(rep.rid)
                    continue
                if self._injector is not None:
                    fault = self._injector.process_fault_due(
                        rep.rid, rep.jobs_completed)
                    if fault is not None:
                        self._apply_process_fault(rep, fault)
                        if fault == "sigkill":
                            continue
                if rep.inflight == 0:
                    # Idle is not dead: beat on its behalf so only replicas
                    # sitting on stuck work go suspect.
                    self._beat(rep)
            self._registry.check()
            now = self._clock()
            do_sync = now - self._last_sync >= self.sync_interval_s
            if do_sync:
                self._last_sync = now
        if do_sync:
            self._sync_store()

    def _sync_store(self) -> None:
        """Anti-entropy round between the shared store and each replica.

        In-process replicas get the direct copy (store entries they are
        missing land in their local cache).  Socket-backed replicas
        (anything exposing ``gossip_fingerprints``) run pairwise gossip
        instead: exchange fingerprint digests, *pull* entries the store has
        never seen, *push* only what the worker is missing — entries travel
        in the ``plan_cache`` persistence envelope, and a plan pulled from
        one worker propagates to the others on the following rounds.  An
        unreachable worker just skips its round; the next sync retries."""
        store_fps = set(self._store.fingerprints())
        for rep in self._replicas:
            if rep.crashed or rep.svc.closed:
                continue
            if hasattr(rep.svc, "gossip_fingerprints"):
                try:
                    have = set(rep.svc.gossip_fingerprints())
                    pulled = rep.svc.gossip_pull(
                        [fp for fp in have if fp not in store_fps])
                    for fp, tenant, _pinned, plan in pulled:
                        self._publish(plan, tenant)
                        store_fps.add(fp)
                    push = []
                    for fp in store_fps - have:
                        plan = self._store.peek(fp)
                        if plan is not None:
                            push.append((fp, self._store_tenant.get(fp, "default"),
                                         False, plan))
                    rep.svc.gossip_push(push)
                except Exception:
                    continue
            else:
                for fp in store_fps:
                    plan = self._store.peek(fp)
                    if plan is None:
                        continue
                    if rep.svc.plan_cache.peek(fp) is None:
                        rep.svc.plan_cache.put(
                            plan, tenant=self._store_tenant.get(fp, "default"))

    def _publish(self, plan: ServicePlan, tenant: str) -> None:
        if self._store.peek(plan.fingerprint) is None:
            self._store.put(plan, tenant=tenant)
            self._store_tenant[plan.fingerprint] = tenant
            with self._lock:
                self._m_publishes += 1

    # -- routing ------------------------------------------------------------

    def _pick(self, exclude: set[str] = frozenset()) -> Optional[_Replica]:
        """Round-robin over healthy replicas, preferring ones not in
        ``exclude``; falls back to any healthy one; None when none are."""
        with self._lock:
            healthy = [r for r in self._replicas if self._weight(r) > 0.0]
            preferred = [r for r in healthy if r.rid not in exclude] or healthy
            if not preferred:
                return None
            self._rr += 1
            return preferred[self._rr % len(preferred)]

    def _hedge_delay(self) -> float:
        if self.hedge_delay_s is not None:
            return self.hedge_delay_s
        with self._lock:
            xs = list(self._latencies)
        if not xs:
            return self.hedge_min_delay_s
        return max(self.hedge_min_delay_s, self.hedge_p99_factor * _pct(xs, 0.99))

    def _backoff(self, attempt: int) -> float:
        base = min(self.backoff_cap_s, self.backoff_base_s * (2.0 ** attempt))
        with self._lock:
            jitter = float(self._rng.random())
        return base * (1.0 + self.backoff_jitter * jitter)

    def _clamp_delay(self, delay: float, req: _GroupRequest) -> float:
        """Never sleep past the request deadline: the expiry check at the
        top of the driver loop should fire on time, not a backoff later."""
        if req.deadline is None:
            return delay
        return max(0.0, min(delay, req.deadline - self._clock()))

    def _hedge_budget_ok(self, req: _GroupRequest, now: float) -> bool:
        """Hedge only while the request has at least ``hedge_min_delay_s``
        of deadline budget left: a secondary lane opened closer to expiry
        than the smallest useful hedge window cannot win — it only burns a
        replica slot that failover (or another request) could use."""
        return (req.deadline is None
                or req.deadline - now >= self.hedge_min_delay_s)

    # -- request driving ----------------------------------------------------

    def _stale_candidate(self, req: _GroupRequest) -> Optional[tuple[ServicePlan, bool]]:
        """(plan, stale) fallback when no replica is healthy: the exact
        fingerprint if the store has it (a plain warm hit), else the base
        plan for updates / the freshest *shape-compatible* store entry —
        genuinely stale.  ``match_fn`` gates compatibility: a plan for a
        structurally different graph would feed wrong-shaped operands to the
        kernel layer, so "freshest cached plan" means freshest plan the
        caller could actually use (same dims, same k)."""
        if req.fingerprint is not None:
            plan = self._store.peek(req.fingerprint)
            if plan is not None:
                return plan, False
        if not self.allow_stale:
            return None
        if req.base_plan is not None:
            return req.base_plan, True
        if req.match_fn is not None:
            for fp in reversed(self._store.fingerprints()):  # freshest first
                plan = self._store.peek(fp)
                if plan is not None and req.match_fn(plan):
                    return plan, True
        return None

    def _breaker(self, rep: _Replica, tenant: str) -> CircuitBreaker:
        with self._lock:
            br = rep.breakers.get(tenant)
            if br is None:
                br = rep.breakers[tenant] = CircuitBreaker(
                    failures_to_trip=self.breaker_failures,
                    cooldown_s=self.breaker_cooldown_s,
                    clock=self._clock)
            return br

    def breaker_states(self, tenant: str = "default") -> dict[str, str]:
        """Per-replica breaker state for ``tenant`` ("closed" when the pair
        has never seen pressure)."""
        out = {}
        for rep in self._replicas:
            br = rep.breakers.get(tenant)
            out[rep.rid] = br.state if br is not None else CircuitBreaker.CLOSED
        return out

    def _rejection_pressure(self, req: _GroupRequest) -> Optional[AdmissionRejectedError]:
        """Fail-fast signal: when every healthy replica's breaker for this
        tenant refuses calls, dispatching (or backing off and redispatching)
        is guaranteed wasted work — answer the typed rejection immediately
        with the soonest cooldown as the retry hint."""
        with self._lock:
            healthy = [r for r in self._replicas if self._weight(r) > 0.0]
        if not healthy:
            return None  # health machinery owns this case, not the breaker
        waits = []
        for rep in healthy:
            br = rep.breakers.get(req.tenant)
            if br is None or not br.blocked():
                return None
            waits.append(br.retry_in())
        hint = max(min(waits), 0.001) if waits else 0.001
        if req.last_rejection is not None:
            hint = max(hint, req.last_rejection.retry_after_s)
        return AdmissionRejectedError(
            f"tenant {req.tenant!r} circuit open on every healthy replica; "
            f"retry in {hint:.3g}s", retry_after_s=hint, tenant=req.tenant,
            reason="breaker_open")

    def _open_lane(self, req: _GroupRequest, rep: _Replica, kind: str) -> Optional[_Lane]:
        breaker = self._breaker(rep, req.tenant)
        if not breaker.allow():
            return None
        try:
            ticket = req.submit_fn(rep.svc)
        except AdmissionRejectedError as e:
            # The replica's queue refused this tenant: count the pressure
            # (trips the breaker at breaker_failures consecutive rejections)
            # and remember the hint for the caller's eventual error.
            with self._lock:
                rep.rejections += 1
            breaker.record_failure()
            req.last_rejection = e
            return None
        except BaseException:
            breaker.record_failure()
            return None
        breaker.record_success()
        with self._lock:
            rep.inflight += 1
        return _Lane(rep.rid, ticket, kind, self._clock())

    def _close_lane(self, lane: _Lane) -> None:
        rep = self._by_rid[lane.rid]
        with self._lock:
            rep.inflight = max(0, rep.inflight - 1)

    def _lane_won(self, req: _GroupRequest, lane: _Lane, plan: ServicePlan) -> None:
        rep = self._by_rid[lane.rid]
        dt = self._clock() - lane.t_start
        with self._lock:
            rep.jobs_completed += 1
            rep.latencies.append(dt)
            self._latencies.append(dt)
            self._beat(rep)
            if self._injector is not None and not rep.crashed and \
                    self._injector.crash_due(rep.rid, rep.jobs_completed):
                self.kill(rep.rid)
        self._publish(plan, req.tenant)

    def _drive(self, req: _GroupRequest) -> None:
        try:
            plan, lane, losers, stale = self._run(req)
        except BaseException as e:
            with self._lock:
                self._inflight.pop(req.key, None)
                self._m_failed += req.waiters
            req.ticket._fail(e)
            return
        for loser in losers:
            loser.ticket.cancel()
            self._close_lane(loser)
        if lane is not None:
            self._close_lane(lane)
            self._lane_won(req, lane, plan)
        with self._lock:
            self._inflight.pop(req.key, None)
            self._m_resolved += req.waiters
            if stale:
                self._m_stale += 1
            if lane is not None:
                req.ticket.replica = lane.rid
                req.ticket.cache_hit = lane.ticket.cache_hit
                if lane.kind == "hedge":
                    self._m_hedges_won += 1
                elif req.ticket.hedged:
                    self._m_hedges_lost += 1
        req.ticket.stale = stale
        req.ticket._resolve(plan)

    def _run(self, req: _GroupRequest):
        """The per-request state machine; returns (plan, winning lane,
        loser lanes, stale)."""
        lanes: list[_Lane] = []
        tried: set[str] = set()
        retries = 0
        hedge_deadline: Optional[float] = None
        while True:
            self.pump()
            # Reap finished lanes: first success wins.
            for lane in list(lanes):
                if not lane.ticket.done():
                    continue
                try:
                    plan = lane.ticket.result(0)
                except BaseException:
                    # Job error / drained queue (ServiceClosedError) /
                    # local cancel: this lane is dead, the others race on.
                    lanes.remove(lane)
                    tried.add(lane.rid)
                    self._close_lane(lane)
                else:
                    lanes.remove(lane)
                    return plan, lane, lanes, False
            # End-to-end deadline: checked after reaping so a result that
            # made it under the wire still wins, but no further waiting or
            # retrying happens once the caller's deadline has passed.
            if req.deadline is not None and self._clock() >= req.deadline:
                for lane in lanes:
                    lane.ticket.cancel()
                    self._close_lane(lane)
                raise ReplicaExhaustedError(
                    f"request deadline ({req.timeout_s:g}s) expired after "
                    f"{retries} retries; replicas tried: {sorted(tried)}")
            # Abandon lanes sitting on crashed or suspect replicas.
            for lane in list(lanes):
                rep = self._by_rid[lane.rid]
                if self._weight(rep) > 0.0:
                    continue
                lanes.remove(lane)
                tried.add(lane.rid)
                lane.ticket.cancel()
                self._close_lane(lane)
                with self._lock:
                    rep.failovers_from += 1
                    self._m_failovers += 1
            if not lanes:
                pressure = self._rejection_pressure(req)
                if pressure is not None:
                    # Every healthy replica's breaker refuses this tenant:
                    # fail fast with the typed rejection instead of burning
                    # the retry budget against queues known to be full.
                    raise pressure
                rep = self._pick(exclude=tried)
                if rep is None:
                    # Nobody healthy: degrade to the store, or back off and
                    # wait for a replica to beat its way back.
                    cand = self._stale_candidate(req)
                    if cand is not None:
                        return cand[0], None, [], cand[1]
                    if retries >= self.retry_budget:
                        if req.last_rejection is not None:
                            raise req.last_rejection
                        raise ReplicaExhaustedError(
                            f"no healthy replica after {retries} retries "
                            f"(budget {self.retry_budget}) and nothing cached "
                            "to serve stale")
                    self._sleep(self._clamp_delay(self._backoff(retries), req))
                    retries += 1
                    with self._lock:
                        self._m_retries += 1
                    req.ticket.retries = retries
                    continue
                kind = "primary" if not tried else "failover"
                if kind == "failover":
                    if retries >= self.retry_budget:
                        if req.last_rejection is not None:
                            # Overload, not failure: surface the retryable
                            # rejection with its backoff hint intact.
                            raise req.last_rejection
                        raise ReplicaExhaustedError(
                            f"retry budget ({self.retry_budget}) exhausted; "
                            f"replicas tried: {sorted(tried)}")
                    retries += 1
                    with self._lock:
                        self._m_retries += 1
                    req.ticket.retries = retries
                    self._sleep(self._clamp_delay(self._backoff(retries - 1), req))
                lane = self._open_lane(req, rep, kind)
                if lane is None:
                    tried.add(rep.rid)
                    continue
                lanes.append(lane)
                if hedge_deadline is None:
                    hedge_deadline = self._clock() + self._hedge_delay()
                continue
            # Hedge: one secondary lane once the primary overstays p99 —
            # but never with less than a useful window of deadline left.
            now = self._clock()
            if (self.hedge and len(lanes) == 1 and not req.ticket.hedged
                    and hedge_deadline is not None and now >= hedge_deadline
                    and self._hedge_budget_ok(req, now)):
                rep = self._pick(exclude=tried | {lanes[0].rid})
                if rep is not None and rep.rid != lanes[0].rid:
                    lane = self._open_lane(req, rep, "hedge")
                    if lane is not None:
                        lanes.append(lane)
                        req.ticket.hedged = True
                        with self._lock:
                            self._m_hedges_fired += 1
                            rep.hedges_to += 1
            self._sleep(self.poll_interval_s)

    # -- submission surface (PartitionService-compatible) -------------------

    def _submit_request(self, key, fingerprint, base_plan, submit_fn, match_fn,
                        tenant: str, priority: int,
                        buffer: DoubleBuffer | None,
                        timeout: float | None = None) -> ReplicaTicket:
        self.pump()
        with self._lock:
            if self._closed:
                ticket = ReplicaTicket(tenant=tenant, priority=priority)
                ticket._fail(ServiceClosedError("ReplicaGroup closed"))
                return ticket
            self._m_submitted += 1
            existing = self._inflight.get(key)
            if existing is not None:
                self._m_coalesced += 1
                existing.waiters += 1
                if buffer is not None:
                    existing.ticket._buffers.append(buffer)
                return existing.ticket
            if fingerprint is not None:
                plan = self._store.get(fingerprint, tenant)
                if plan is not None:
                    ticket = ReplicaTicket(tenant=tenant, priority=priority)
                    ticket.cache_hit = True
                    if buffer is not None:
                        ticket._buffers.append(buffer)
                    self._m_resolved += 1
                    ticket._resolve(plan)
                    return ticket
            now = self._clock()
            req = _GroupRequest(key, fingerprint, base_plan, submit_fn,
                                match_fn, tenant, priority, now,
                                deadline=(now + timeout
                                          if timeout is not None else None),
                                timeout_s=timeout)
            if buffer is not None:
                req.ticket._buffers.append(buffer)
            self._inflight[key] = req
            self._driver_seq += 1
            name = f"replica-driver-{self._driver_seq}"
        threading.Thread(target=self._drive, args=(req,), name=name,
                         daemon=True).start()
        return req.ticket

    def submit(
        self,
        edges: EdgeList,
        k: int,
        method: str = "ep",
        opts: MultilevelOptions | None = None,
        seed: int = 0,
        pad: int = 128,
        coo: Optional[tuple] = None,
        buffer: DoubleBuffer | None = None,
        tenant: str = "default",
        priority: int = 0,
        timeout: float | None = None,
    ) -> ReplicaTicket:
        """Async full-partition request; same signature and ticket semantics
        as ``PartitionService.submit``, plus group behavior (store warm
        hits, failover, hedging, stale degradation).  ``timeout`` is an
        *end-to-end* deadline: once it expires the driver stops retrying —
        even with budget left — and fails the ticket with
        :class:`ReplicaExhaustedError` noting the deadline."""
        opts = opts if opts is not None else self._replicas[0].svc.default_opts
        extra = (coo[0], coo[1]) if coo is not None else ()
        fp = graph_fingerprint(edges, k, pad, opts, method, seed, extra)

        def submit_fn(svc: PartitionService) -> PlanTicket:
            return svc.submit(edges, k, method=method, opts=opts, seed=seed,
                              pad=pad, coo=coo, tenant=tenant, priority=priority)

        if coo is not None:
            n_rows, n_cols, rows = coo[0], coo[1], coo[2]
            nnz = len(rows)

            def match_fn(plan: ServicePlan) -> bool:
                return (plan.coo is not None and plan.plan is not None
                        and plan.coo[0] == n_rows and plan.coo[1] == n_cols
                        and len(plan.coo[2]) == nnz
                        and plan.result.k == k)
        else:
            n, m = edges.n, edges.m

            def match_fn(plan: ServicePlan) -> bool:
                return (plan.edges.n == n and plan.edges.m == m
                        and plan.result.k == k)

        return self._submit_request(("full", fp), fp, None, submit_fn,
                                    match_fn, tenant, priority, buffer,
                                    timeout=timeout)

    def get(self, edges: EdgeList, k: int, method: str = "ep",
            opts: MultilevelOptions | None = None, seed: int = 0,
            pad: int = 128, coo: Optional[tuple] = None,
            timeout: float | None = None, tenant: str = "default",
            priority: int = 0) -> ServicePlan:
        return self.submit(edges, k, method=method, opts=opts, seed=seed,
                           pad=pad, coo=coo, tenant=tenant,
                           priority=priority, timeout=timeout).result(timeout)

    def get_spmv_plan(self, n_rows: int, n_cols: int, rows: np.ndarray,
                      cols: np.ndarray, k: int, method: str = "ep",
                      opts: MultilevelOptions | None = None, seed: int = 0,
                      pad: int = 128, timeout: float | None = None,
                      tenant: str = "default", priority: int = 0) -> ServicePlan:
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        edges = affinity_graph_from_coo(n_rows, n_cols, rows, cols)
        return self.get(edges, k, method=method, opts=opts, seed=seed, pad=pad,
                        coo=(n_rows, n_cols, rows, cols), timeout=timeout,
                        tenant=tenant, priority=priority)

    def _base_plan(self, base_fingerprint: str) -> Optional[ServicePlan]:
        plan = self._store.peek(base_fingerprint)
        if plan is not None:
            return plan
        for rep in self._replicas:
            if rep.crashed:
                continue
            plan = rep.svc.plan_cache.peek(base_fingerprint)
            if plan is not None:
                # Pull it into the store so failover targets can seed it.
                self._store.put(plan, tenant=self._store_tenant.get(
                    base_fingerprint, "default"))
                return plan
        return None

    def update_async(
        self,
        base_fingerprint: str,
        k: int,
        insert_u: np.ndarray | None = None,
        insert_v: np.ndarray | None = None,
        delete_ids: np.ndarray | None = None,
        method: str = "ep",
        opts: MultilevelOptions | None = None,
        seed: int = 0,
        pad: int = 128,
        buffer: DoubleBuffer | None = None,
        tenant: str = "default",
        priority: int = 0,
        timeout: float | None = None,
    ) -> ReplicaTicket:
        """Edge-churn update against a cached base plan, group-wide.

        The base plan is located in the shared store or any live replica
        (and seeded into whichever replica ends up computing, including
        failover targets), so an update survives the death of the replica
        that computed its base.  With every replica down, the *base* plan is
        served with ``stale=True`` — the freshest known state of that graph.
        Raises ``KeyError`` when no copy of the base exists anywhere."""
        opts = opts if opts is not None else self._replicas[0].svc.default_opts
        iu = np.asarray(insert_u, dtype=np.int64) if insert_u is not None \
            else np.empty(0, np.int64)
        iv = np.asarray(insert_v, dtype=np.int64) if insert_v is not None \
            else np.empty(0, np.int64)
        dele = (np.unique(np.asarray(delete_ids, dtype=np.int64))
                if delete_ids is not None and len(delete_ids) > 0
                else np.empty(0, np.int64))
        base = self._base_plan(base_fingerprint)
        if base is None:
            raise KeyError(
                f"no cached plan for fingerprint {base_fingerprint!r} in the "
                "shared store or any live replica; resubmit the full graph")
        h = hashlib.blake2b(digest_size=16)
        meta = (base_fingerprint, k, pad, method, seed)
        if opts is not None:
            meta = meta + dataclasses.astuple(opts)
        h.update(repr(meta).encode())
        h.update(iu.tobytes())
        h.update(iv.tobytes())
        h.update(dele.tobytes())
        key = ("update", h.hexdigest())

        def submit_fn(svc: PartitionService) -> PlanTicket:
            if svc.plan_cache.peek(base_fingerprint) is None:
                svc.plan_cache.put(base, tenant=tenant)
            return svc.update_async(
                base_fingerprint, k, insert_u=iu, insert_v=iv, delete_ids=dele,
                method=method, opts=opts, seed=seed, pad=pad, tenant=tenant,
                priority=priority)

        return self._submit_request(key, None, base, submit_fn, None, tenant,
                                    priority, buffer, timeout=timeout)

    def update(self, base_fingerprint: str, k: int, timeout: float | None = None,
               **kwargs) -> ServicePlan:
        return self.update_async(base_fingerprint, k, timeout=timeout,
                                 **kwargs).result(timeout)

    # -- metrics ------------------------------------------------------------

    @property
    def stats(self) -> ServiceStats:
        """Summed ``ServiceStats`` across replicas (facade compatibility)."""
        agg = ServiceStats()
        for rep in self._replicas:
            s = rep.svc.stats
            for f in dataclasses.fields(ServiceStats):
                setattr(agg, f.name, getattr(agg, f.name) + getattr(s, f.name))
        return agg

    @property
    def store(self) -> PlanCache:
        return self._store

    @property
    def default_opts(self) -> MultilevelOptions | None:
        """Replica 0's default options — the group's fingerprinting basis
        (members are identically configured by contract)."""
        return self._replicas[0].svc.default_opts

    def lookup(self, fingerprint: str, tenant: str = "default") -> Optional[ServicePlan]:
        """Cache-only probe: the shared store, then any live replica's
        local cache — no partitioning work, no queueing.  The brownout path
        uses this to answer low-priority tenants from cache alone while the
        group sheds load."""
        plan = self._store.get(fingerprint, tenant)
        if plan is not None:
            return plan
        for rep in self._replicas:
            if rep.crashed:
                continue
            try:
                plan = rep.svc.plan_cache.peek(fingerprint)
            except Exception:
                continue  # unreachable remote: probe the next replica
            if plan is not None:
                return plan
        return None

    @property
    def registry(self) -> HeartbeatRegistry:
        return self._registry

    def replica_ids(self) -> list[str]:
        return [rep.rid for rep in self._replicas]

    def replica_metrics(self) -> ReplicaMetrics:
        """The replication-level snapshot (per-replica health + counters)."""
        with self._lock:
            rows = []
            for rep in self._replicas:
                if rep.crashed:
                    state = "crashed"
                elif rep.rid in self._registry.dead:
                    state = "suspect"
                else:
                    state = "healthy"
                xs = [x * 1e3 for x in rep.latencies]
                rows.append(ReplicaStats(
                    replica=rep.rid,
                    state=state,
                    weight=self._weight(rep),
                    beats=rep.beats,
                    jobs_completed=rep.jobs_completed,
                    failovers_from=rep.failovers_from,
                    hedges_to=rep.hedges_to,
                    p50_ms=_pct(xs, 0.50),
                    p99_ms=_pct(xs, 0.99),
                    rejections=rep.rejections,
                    breakers_open=sum(
                        1 for br in rep.breakers.values()
                        if br.state != CircuitBreaker.CLOSED),
                    breaker_trips=sum(
                        br.trips for br in rep.breakers.values()),
                ))
            return ReplicaMetrics(
                replicas=rows,
                submitted=self._m_submitted,
                resolved=self._m_resolved,
                failed=self._m_failed,
                pending=len(self._inflight),
                coalesced=self._m_coalesced,
                failovers=self._m_failovers,
                retries=self._m_retries,
                hedges_fired=self._m_hedges_fired,
                hedges_won=self._m_hedges_won,
                hedges_lost=self._m_hedges_lost,
                stale_serves=self._m_stale,
                store_entries=len(self._store),
                store_publishes=self._m_publishes,
            )

    def metrics(self) -> ServiceMetrics:
        """Aggregated ``ServiceMetrics`` across replicas — the shape
        ``GraphServer.metrics()`` expects.  Counters sum; utilization
        averages over members; latency summaries are recomputed from the
        group's own completion samples (per-replica summaries don't merge).
        Per-replica detail lives in :meth:`replica_metrics`."""
        snaps = [rep.svc.metrics() for rep in self._replicas]
        with self._lock:
            lat = list(self._latencies)
        tenants: dict[str, dict] = {}
        for snap in snaps:
            for tenant, d in snap.tenants.items():
                agg = tenants.setdefault(tenant, {})
                for k, v in d.items():
                    cur = agg.get(k)
                    if isinstance(v, (int, float)) and isinstance(cur, (int, float)):
                        agg[k] = cur + v
                    elif cur is None:
                        # budget_bytes and friends: None means "no budget";
                        # keep any concrete value a member reports.
                        agg[k] = v
        return ServiceMetrics(
            queue_depth=sum(s.queue_depth for s in snaps),
            workers=sum(s.workers for s in snaps),
            busy_workers=sum(s.busy_workers for s in snaps),
            utilization=sum(s.utilization for s in snaps) / max(len(snaps), 1),
            executor=snaps[0].executor if snaps else "thread",
            jobs_completed=sum(s.jobs_completed for s in snaps),
            jobs_failed=sum(s.jobs_failed for s in snaps),
            cancelled_queued=sum(s.cancelled_queued for s in snaps),
            cancelled_inflight=sum(s.cancelled_inflight for s in snaps),
            coalesced=sum(s.coalesced for s in snaps),
            latency_s=_latency_summary(lat),
            queue_wait_s=_latency_summary([]),
            tenants=tenants,
            queue_depth_max=max((s.queue_depth_max for s in snaps), default=0),
            rejected=sum(s.rejected for s in snaps),
            shed_deadline=sum(s.shed_deadline for s in snaps),
        )
