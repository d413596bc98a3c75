# Copied verbatim from src/repro/core/plan_scheduler.py; keep the two in step.
"""Priority worker pool for partitioning jobs — the scheduling half of §4.2.

The paper's argument is that the *runtime*, not just the preprocessing,
decides whether a good partition turns into cache efficiency: optimization
work must run off the request path, never block compute, and be cheap to
re-trigger.  PR 1's single ``_worker`` thread implemented the minimal form.
This module grows it into a multi-tenant scheduling subsystem:

  * **N-worker pool** — ``PlanScheduler(workers=N)`` drains one priority
    queue with N dispatchers.  ``executor="thread"`` runs jobs in-process
    (zero setup, shares memory; fine for a single worker or I/O-light
    loads).  ``executor="process"`` runs each job in a spawned worker
    process — partitioning is CPU-bound numpy and the GIL serializes
    threads, so real cold-plan parallelism needs processes.  Jobs must then
    be (module-level function, picklable args) pairs.
  * **Priorities** — ``submit(..., priority=p)``: higher runs first, FIFO
    within a class.  Re-submitting a queued key at a higher priority bumps
    it (re-queued at the tail of the new class).
  * **Cancellation** — ``cancel(ticket)`` drops queued work (the ticket
    fails with :class:`PlanCancelledError`); an in-flight job cannot be
    interrupted, so cancel *marks* the ticket (``ticket.cancelled``) and
    the result still lands in the cache — the work is salvaged, the caller
    stops waiting.
  * **Coalescing** — concurrent submits of one key share a single
    computation and one ticket (each extra submit is counted; cancellation
    of a shared ticket only detaches the canceller).
  * **Metrics** — :meth:`metrics_snapshot` exports a :class:`ServiceMetrics`:
    queue depth, worker utilization, completion/cancellation/coalesce
    counters, and latency histograms (queue wait + total submit→done).

The scheduler is deliberately ignorant of *what* a job computes: the
``PartitionService`` facade owns fingerprints, the plan cache, and stats,
and passes an ``on_done`` callback that runs (on the dispatcher thread)
before the ticket resolves — so cache population happens-before any waiter
wakes, exactly like the old single-worker loop.
"""
from __future__ import annotations

import dataclasses
import heapq
import threading
import time
from collections import deque
from typing import Any, Callable, Optional

from .admission import (
    AdmissionController,
    AdmissionRejectedError,
    DeadlineShedError,
)

__all__ = [
    "AdmissionRejectedError",
    "DeadlineShedError",
    "PlanCancelledError",
    "PlanScheduler",
    "PlanTicket",
    "ServiceClosedError",
    "ServiceMetrics",
]


class ServiceClosedError(RuntimeError):
    """The service/scheduler is closed: queued work is drained, new work
    is refused.  Subclasses RuntimeError so pre-existing callers matching
    ``RuntimeError("... closed")`` keep working."""


class PlanCancelledError(RuntimeError):
    """The request was cancelled before a worker picked it up."""


def _pin_worker_blas_env() -> None:
    """Pin numeric libraries to one thread each in ``os.environ`` BEFORE
    spawning pool workers: children inherit the environment, and BLAS
    libraries size their thread pools at load time — the env must be set in
    the parent, since anything executed *in* the child (even a pool
    initializer) runs after the child has already imported numpy while
    unpickling it.  The pool itself is the parallelism; P workers x N BLAS
    threads oversubscribes the cores and measurably slows every job.
    ``setdefault`` keeps an operator's explicit setting."""
    import os

    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                "MKL_NUM_THREADS", "NUMEXPR_NUM_THREADS"):
        os.environ.setdefault(var, "1")


# Log-2 latency buckets for the exported histograms (seconds).
_BUCKET_EDGES_S = tuple(2.0**e for e in range(-10, 5))  # ~1 ms .. 16 s


def _latency_summary(samples: list[float]) -> dict:
    """{count, mean, p50, p90, p99, max, histogram} over latency seconds."""
    if not samples:
        return {"count": 0, "mean": 0.0, "p50": 0.0, "p90": 0.0, "p99": 0.0,
                "max": 0.0, "histogram": {}}
    xs = sorted(samples)
    n = len(xs)

    def pct(p: float) -> float:
        return xs[min(n - 1, int(p * n))]

    hist: dict[str, int] = {}
    for x in xs:
        for edge in _BUCKET_EDGES_S:
            if x < edge:
                label = f"<{edge * 1e3:g}ms" if edge < 1 else f"<{edge:g}s"
                break
        else:
            label = f">={_BUCKET_EDGES_S[-1]:g}s"
        hist[label] = hist.get(label, 0) + 1
    return {
        "count": n,
        "mean": sum(xs) / n,
        "p50": pct(0.50),
        "p90": pct(0.90),
        "p99": pct(0.99),
        "max": xs[-1],
        "histogram": hist,
    }


@dataclasses.dataclass
class ServiceMetrics:
    """Point-in-time snapshot of the scheduling subsystem.

    ``tenants`` maps tenant -> flat counter dict (hits/misses/evictions/
    bytes/entries from the plan cache, submitted/completed from the
    scheduler); latency dicts come from :func:`_latency_summary`.
    """

    queue_depth: int
    workers: int
    busy_workers: int
    utilization: float  # busy-seconds / (workers * uptime) since start
    executor: str
    jobs_completed: int
    jobs_failed: int
    cancelled_queued: int
    cancelled_inflight: int
    coalesced: int
    latency_s: dict  # submit -> done
    queue_wait_s: dict  # submit -> worker pickup
    tenants: dict = dataclasses.field(default_factory=dict)
    # Kernel compile-cache counters (hits/misses/evictions/entries/
    # size_elems per bucket), merged in by the serve layer's GraphServer —
    # empty when no compile cache reports into this snapshot.
    compile_cache: dict = dataclasses.field(default_factory=dict)
    # Overload-protection counters (defaulted so pre-admission snapshots
    # and the transport's empty-metrics constructor keep working):
    # high-water queue depth, admission rejections, deadline sheds, and
    # the admission controller's view (bound / per-tenant occupancy /
    # drain rate) — empty dict when the scheduler runs unbounded.
    queue_depth_max: int = 0
    rejected: int = 0
    shed_deadline: int = 0
    admission: dict = dataclasses.field(default_factory=dict)


class PlanTicket:
    """Future handed back by async submission; resolves to a ServicePlan.

    ``cache_hit`` is True when the request was answered from the plan cache
    without any partitioning work (set before the ticket is returned, so it
    is race-free even with concurrent requests on other graphs).
    ``cancelled`` is True once :meth:`cancel` took effect: a queued request
    fails with :class:`PlanCancelledError`; an in-flight one is only
    *marked* — the computation finishes and ``result()`` still returns it.
    """

    def __init__(self, tenant: str = "default", priority: int = 0) -> None:
        self._event = threading.Event()
        self._value: Any = None
        self._error: Optional[BaseException] = None
        self.cache_hit = False
        self.cancelled = False
        self.tenant = tenant
        self.priority = priority
        # Lifecycle timestamps (perf_counter): set by the scheduler.
        self.t_submit: float = 0.0
        self.t_start: float = 0.0
        self.t_done: float = 0.0
        # Buffers to publish to on completion.  Coalescing can hand one
        # ticket to several callers, each with its own DoubleBuffer — all of
        # them must see the swap (guarded by the scheduler lock).
        self._buffers: list = []
        self._cancel_cb: Optional[Callable[["PlanTicket"], bool]] = None
        self._waiters = 1

    def _resolve(self, value) -> None:
        self._value = value
        self._event.set()

    def _fail(self, err: BaseException) -> None:
        self._error = err
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def cancel(self, buffer=None) -> bool:
        """Try to cancel; True iff the computation itself was prevented.

        Pass the ``DoubleBuffer`` you gave ``submit`` to detach it as well:
        a coalesced computation keeps running for the other waiters, and
        without detaching, its eventual publish would overwrite whatever
        your buffer is serving by then.
        """
        # Single read: the worker nulls the callback concurrently on
        # completion, and a cancel that loses that race is a benign False.
        cb = self._cancel_cb
        return cb(self, buffer) if cb is not None else False

    def result(self, timeout: float | None = None):
        if not self._event.wait(timeout):
            raise TimeoutError("partition not ready")
        if self._error is not None:
            raise self._error
        return self._value


class _Job:
    """One queued/running computation: heap entries point at this."""

    __slots__ = ("key", "fn", "args", "ticket", "on_done", "priority", "seq",
                 "state", "t_submit", "t_start", "deadline")
    QUEUED, RUNNING, DONE = 0, 1, 2

    def __init__(self, key, fn, args, ticket, on_done, priority, seq,
                 deadline=None):
        self.key = key
        self.fn = fn
        self.args = args
        self.ticket = ticket
        self.on_done = on_done
        self.priority = priority
        self.seq = seq
        self.state = _Job.QUEUED
        self.t_submit = time.perf_counter()
        self.t_start = 0.0
        self.deadline = deadline  # absolute perf_counter(); None = unbounded


class PlanScheduler:
    """Priority-ordered N-worker pool with coalescing and cancellation."""

    def __init__(
        self,
        workers: int = 1,
        executor: str = "thread",
        name: str = "plan-sched",
        max_queue_depth: int | None = None,
        tenant_weights: dict[str, float] | None = None,
        admission: AdmissionController | None = None,
    ) -> None:
        if workers < 1:
            raise ValueError("workers must be >= 1")
        if executor not in ("thread", "process"):
            raise ValueError(f"executor must be 'thread' or 'process', got {executor!r}")
        self.workers = workers
        self.executor = executor
        self._name = name
        # Admission is opt-in: with no bound the scheduler keeps its
        # historical unbounded-queue behavior.  The controller's methods are
        # only ever called under _cv's lock.
        if admission is not None:
            self._admission: Optional[AdmissionController] = admission
        elif max_queue_depth is not None:
            self._admission = AdmissionController(
                max_queue_depth, tenant_weights=tenant_weights)
        else:
            if tenant_weights:
                raise ValueError("tenant_weights requires max_queue_depth")
            self._admission = None
        self._cv = threading.Condition()
        self._heap: list[tuple[int, int, _Job]] = []  # (-priority, seq, job)
        self._jobs: dict[Any, _Job] = {}  # key -> queued/running job (coalescing)
        self._seq = 0
        self._threads: list[threading.Thread] = []
        self._pool = None  # multiprocessing pool when executor == "process"
        self._stop = False
        self._closed = False
        # Metrics (all guarded by _cv's lock).
        self._t0 = time.perf_counter()
        self._busy_s = 0.0
        self._busy_workers = 0
        self._jobs_completed = 0
        self._jobs_failed = 0
        self._cancelled_queued = 0
        self._cancelled_inflight = 0
        self._coalesced = 0
        self._rejected = 0
        self._shed_deadline = 0
        self._queued = 0  # live queue depth (QUEUED jobs)
        self._queue_depth_max = 0
        self._tenant_counts: dict[str, dict[str, int]] = {}
        self._lat_total: deque[float] = deque(maxlen=2048)
        self._lat_wait: deque[float] = deque(maxlen=2048)
        # Pure service time (worker pickup -> done): the deadline-shedding
        # predictor.  Total latency would double-count queue wait.
        self._lat_run: deque[float] = deque(maxlen=2048)
        # Test/bench seam: called with the job key on the dispatcher thread
        # just before the job executes (thread executor only — a process
        # pool's children cannot see it).  ``ReplicaGroup``'s FaultInjector
        # uses it to stall a replica deterministically; an exception raised
        # here fails the job like a job error.
        self.pre_job_hook: Optional[Callable[[Any], None]] = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        """Spin up the worker pool; idempotent while the scheduler is open,
        and reopens a closed scheduler (the drained queue stays failed, new
        submits are accepted again — matching the pre-pool single-worker
        service, whose start() after close() revived it)."""
        with self._cv:
            self._closed = False
            self._stop = False
            if self.executor == "process" and self._pool is None:
                import multiprocessing as mp

                # "spawn", not "fork": the parent may hold jax/BLAS threads
                # whose locks a forked child would inherit mid-flight.
                _pin_worker_blas_env()
                self._pool = mp.get_context("spawn").Pool(self.workers)
            missing = self.workers - len([t for t in self._threads if t.is_alive()])
            for i in range(missing):
                t = threading.Thread(
                    target=self._worker_loop, name=f"{self._name}-{i}", daemon=True
                )
                self._threads.append(t)
                t.start()

    def close(self) -> None:
        """Drain-safe, idempotent shutdown: queued tickets fail with
        :class:`ServiceClosedError`; in-flight jobs finish (close blocks on
        them — their waiters must see a resolved ticket, never a ticket
        orphaned by a killed worker); a second call is a no-op."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._stop = True
            drained: list[_Job] = []
            while self._heap:
                _, seq, job = heapq.heappop(self._heap)
                if job.state == _Job.QUEUED and job.seq == seq:
                    job.state = _Job.DONE
                    self._jobs.pop(job.key, None)
                    self._queued -= 1
                    if self._admission is not None:
                        self._admission.release(job.ticket.tenant)
                    drained.append(job)
            self._cv.notify_all()
        for job in drained:
            job.ticket._fail(ServiceClosedError(
                "PartitionService closed before this request was scheduled"))
        # No join timeout: dispatchers exit as soon as their current job
        # completes, and cutting them off early (then terminating the
        # process pool) would kill an in-flight job and hang its waiters.
        for t in self._threads:
            t.join()
        self._threads = []
        if self._pool is not None:
            # Dispatchers are gone, so no apply() is outstanding: a
            # graceful close/join, not terminate(), reaps the workers.
            self._pool.close()
            self._pool.join()
            self._pool = None

    @property
    def closed(self) -> bool:
        return self._closed

    # -- submission --------------------------------------------------------

    def _p50_run_locked(self) -> float:
        """Median observed service time (pickup -> done); 0 with no history,
        so a cold scheduler never sheds on an unfounded prediction."""
        if not self._lat_run:
            return 0.0
        ys = sorted(self._lat_run)
        return ys[min(len(ys) - 1, len(ys) // 2)]

    def submit(
        self,
        key,
        fn: Callable,
        args: tuple,
        *,
        priority: int = 0,
        tenant: str = "default",
        buffer=None,
        on_done: Optional[Callable] = None,
        deadline: float | None = None,
        block: bool = False,
    ) -> tuple[PlanTicket, bool]:
        """Enqueue ``fn(*args)`` under ``key``; returns ``(ticket, created)``.

        ``created`` is False when an identical key was already queued or
        in-flight — the existing ticket is shared (coalescing) and, if the
        new priority is higher and the job is still queued, the job is
        bumped.  With ``executor="process"``, ``fn`` must be a module-level
        function and ``args`` picklable.

        ``deadline`` is an absolute ``time.perf_counter()`` instant: a job
        whose p50-predicted service time no longer fits its remaining
        budget is shed (its ticket fails with :class:`DeadlineShedError`)
        instead of wasting a worker — at the door here, and again at worker
        pickup for jobs that aged out while queued.

        When the scheduler has a queue bound, an over-share submit either
        raises :class:`AdmissionRejectedError` (with a drain-rate-derived
        ``retry_after_s`` hint) or, with ``block=True``, waits under
        backpressure for a slot.  Coalesced submits bypass admission: they
        consume no new queue slot.
        """
        with self._cv:
            while True:
                # Closed is checked first on every pass — including every
                # block=True wakeup — so a submit racing close() gets
                # ServiceClosedError deterministically, never a retryable
                # admission hint that would steer clients back into a dead
                # service.
                if self._closed:
                    ticket = PlanTicket(tenant=tenant, priority=priority)
                    ticket._fail(ServiceClosedError("PartitionService closed"))
                    return ticket, False
                job = self._jobs.get(key)
                if job is not None and job.state != _Job.DONE:
                    self._coalesced += 1
                    t = job.ticket
                    t._waiters += 1
                    if buffer is not None:
                        t._buffers.append(buffer)
                    if priority > job.priority and job.state == _Job.QUEUED:
                        job.priority = priority
                        self._seq += 1
                        job.seq = self._seq
                        heapq.heappush(self._heap, (-priority, self._seq, job))
                    # A new waiter may bring a laxer deadline: keep the job
                    # alive as long as anyone still has budget for it.
                    if job.deadline is not None and (
                            deadline is None or deadline > job.deadline):
                        job.deadline = deadline
                    return t, False
                now = time.perf_counter()
                if deadline is not None and now + self._p50_run_locked() > deadline:
                    self._shed_deadline += 1
                    ticket = PlanTicket(tenant=tenant, priority=priority)
                    ticket._fail(DeadlineShedError(
                        f"deadline budget ({deadline - now:.3g}s left) below "
                        "p50-predicted service time; shed at admission"))
                    return ticket, False
                if self._admission is None:
                    break
                err = self._admission.try_acquire(tenant)
                if err is None:
                    break
                if not block:
                    self._rejected += 1
                    tc = self._tenant_counts.setdefault(
                        tenant, {"submitted": 0, "completed": 0})
                    tc["rejected"] = tc.get("rejected", 0) + 1
                    raise err
                # Backpressure: wait for a queue slot (workers notify on
                # every pickup) or for close/deadline to resolve the wait.
                self._cv.wait(timeout=None if deadline is None
                              else max(deadline - now, 0.0) or 0.001)
            ticket = PlanTicket(tenant=tenant, priority=priority)
            ticket.t_submit = time.perf_counter()
            ticket._cancel_cb = self._cancel
            if buffer is not None:
                ticket._buffers.append(buffer)
            self._seq += 1
            job = _Job(key, fn, args, ticket, on_done, priority, self._seq,
                       deadline=deadline)
            self._jobs[key] = job
            tc = self._tenant_counts.setdefault(tenant, {"submitted": 0, "completed": 0})
            tc["submitted"] += 1
            heapq.heappush(self._heap, (-priority, self._seq, job))
            self._queued += 1
            self._queue_depth_max = max(self._queue_depth_max, self._queued)
            self._cv.notify()
            return ticket, True

    def _cancel(self, ticket: PlanTicket, buffer=None) -> bool:
        with self._cv:
            if buffer is not None and buffer in ticket._buffers:
                # The canceller's serving loop must not receive the plan it
                # just walked away from (the job may finish for others).
                ticket._buffers.remove(buffer)
            job = None
            for j in self._jobs.values():
                if j.ticket is ticket:
                    job = j
                    break
            if job is None or job.state == _Job.DONE:
                return False
            if ticket._waiters > 1:
                # Coalesced: detach this caller, keep computing for the rest.
                ticket._waiters -= 1
                return False
            if job.state == _Job.RUNNING:
                ticket.cancelled = True
                self._cancelled_inflight += 1
                return False
            # Queued and solely owned: drop it (heap entry goes stale).
            job.state = _Job.DONE
            self._jobs.pop(job.key, None)
            ticket.cancelled = True
            self._cancelled_queued += 1
            self._queued -= 1
            if self._admission is not None:
                self._admission.release(ticket.tenant)
                self._cv.notify_all()  # a blocked submit may now have a slot
        ticket._fail(PlanCancelledError("request cancelled while queued"))
        return True

    # -- workers -----------------------------------------------------------

    def _worker_loop(self) -> None:
        while True:
            shed: list[_Job] = []
            with self._cv:
                job = None
                while job is None:
                    while self._heap:
                        _, seq, cand = heapq.heappop(self._heap)
                        # Stale entries: cancelled jobs and superseded
                        # priority-bump duplicates point at a job whose
                        # state/seq moved on.
                        if cand.state != _Job.QUEUED or cand.seq != seq:
                            continue
                        if cand.deadline is not None and (
                                time.perf_counter() + self._p50_run_locked()
                                > cand.deadline):
                            # Aged out while queued: running it now would
                            # waste a worker on a result nobody can use.
                            cand.state = _Job.DONE
                            self._jobs.pop(cand.key, None)
                            self._shed_deadline += 1
                            self._queued -= 1
                            if self._admission is not None:
                                self._admission.release(cand.ticket.tenant)
                                self._cv.notify_all()
                            shed.append(cand)
                            continue
                        job = cand
                        break
                    if job is not None or shed:
                        # Shed tickets must be failed outside the lock
                        # promptly, not after an unbounded wait().
                        break
                    if self._stop:
                        return
                    self._cv.wait()
                if job is not None:
                    job.state = _Job.RUNNING
                    job.t_start = time.perf_counter()
                    job.ticket.t_start = job.t_start
                    self._busy_workers += 1
                    self._queued -= 1
                    if self._admission is not None:
                        # The bound covers *queued* work: pickup frees the
                        # slot and wakes any backpressured submitter.
                        self._admission.release(job.ticket.tenant)
                        self._cv.notify_all()
                pool = self._pool
            for s in shed:
                s.ticket._cancel_cb = None
                s.ticket._fail(DeadlineShedError(
                    "deadline budget exhausted while queued; shed at pickup"))
            if job is None:
                continue
            try:
                hook = self.pre_job_hook
                if hook is not None:
                    hook(job.key)
                if pool is not None:
                    value = pool.apply(job.fn, job.args)
                else:
                    value = job.fn(*job.args)
                if job.on_done is not None:
                    # Runs before the ticket resolves: cache population
                    # happens-before any waiter wakes.
                    value = job.on_done(value, job.ticket)
                err = None
            except BaseException as e:  # propagate to waiters, keep serving
                err = e
            t_done = time.perf_counter()
            with self._cv:
                job.state = _Job.DONE
                if self._jobs.get(job.key) is job:
                    del self._jobs[job.key]
                self._busy_workers -= 1
                self._busy_s += t_done - job.t_start
                if err is None:
                    self._jobs_completed += 1
                    tc = self._tenant_counts.setdefault(
                        job.ticket.tenant, {"submitted": 0, "completed": 0})
                    tc["completed"] += 1
                    self._lat_total.append(t_done - job.t_submit)
                    self._lat_wait.append(job.t_start - job.t_submit)
                    self._lat_run.append(t_done - job.t_start)
                else:
                    self._jobs_failed += 1
                if self._admission is not None:
                    # Completion is the drain signal the retry_after_s
                    # estimator converts into seconds-until-slot-free.
                    self._admission.note_drained(t_done)
                buffers = list(job.ticket._buffers)
            job.ticket.t_done = t_done
            job.ticket._cancel_cb = None
            if err is not None:
                job.ticket._fail(err)
            else:
                for buf in buffers:
                    buf.publish(value)
                job.ticket._resolve(value)

    # -- metrics -----------------------------------------------------------

    def metrics_snapshot(self) -> ServiceMetrics:
        with self._cv:
            uptime = max(time.perf_counter() - self._t0, 1e-9)
            busy = self._busy_s
            # Credit the running jobs' elapsed time too, so a snapshot taken
            # mid-computation doesn't read as an idle pool.
            for job in self._jobs.values():
                if job.state == _Job.RUNNING:
                    busy += time.perf_counter() - job.t_start
            tenants = {t: dict(c) for t, c in self._tenant_counts.items()}
            if self._admission is not None:
                for t, n in self._admission.occupancy().items():
                    tenants.setdefault(
                        t, {"submitted": 0, "completed": 0})["queued"] = n
            return ServiceMetrics(
                queue_depth=sum(
                    1 for j in self._jobs.values() if j.state == _Job.QUEUED),
                workers=self.workers,
                busy_workers=self._busy_workers,
                utilization=min(busy / (self.workers * uptime), 1.0),
                executor=self.executor,
                jobs_completed=self._jobs_completed,
                jobs_failed=self._jobs_failed,
                cancelled_queued=self._cancelled_queued,
                cancelled_inflight=self._cancelled_inflight,
                coalesced=self._coalesced,
                latency_s=_latency_summary(list(self._lat_total)),
                queue_wait_s=_latency_summary(list(self._lat_wait)),
                tenants=tenants,
                queue_depth_max=self._queue_depth_max,
                rejected=self._rejected,
                shed_deadline=self._shed_deadline,
                admission=(self._admission.snapshot()
                           if self._admission is not None else {}),
            )
