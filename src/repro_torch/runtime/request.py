"""Typed request API + bucketed serve path for EP-SpMV on the device.

Port of ``src/repro/runtime/request.py``.  The paper's premise — group tasks
so irregular sharing becomes cache hits — runs twice below this layer: once
inside the kernel (cluster-local x tiles) and once in the plan cache
(repeated graphs never re-partition).  This module applies it a third time,
to *bucket callables*: thousands of small serving graphs collapse onto a
handful of padded shape buckets, and every request in a bucket goes through
one built callable (GraphCage's bucket-by-structure segmenting).  A "compile"
in the counters below is one built callable; the kernels themselves are
built once per process from ``kernels/csrc``.

Layering: this is the *request layer*.  It owns

* the typed surface — :class:`GraphRequest` in, :class:`ServeResult`
  (y + :class:`ServeInfo`) out;
* plan-kind resolution (:func:`resolve_plan`) — ``kernels.ops`` takes only
  host-side ``PackPlan``s now; unwrapping scheduler handles (ServicePlan /
  PlanTicket and their timeout semantics) happens here;
* the bucket-callable cache (:class:`CompileCache`) — bounded, with
  (size, recency) eviction and hit/miss/evict counters surfaced through
  ``GraphServer.stats()`` and ``ServiceMetrics.compile_cache``;
* micro-batching — ``GraphServer.submit`` coalesces same-bucket requests
  within a ``max_batch`` / ``max_wait_ms`` window through one stacked
  kernel launch, de-padding each request's y on the way out.

``GraphServer.serve`` is the synchronous lane: it runs a batch-of-1
through the same bucket callable (no waiting, still no per-shape
build).  ``GraphServer.submit`` is the queued lane that trades up to
``max_wait_ms`` of latency for batched launches.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..core.partition_service import (
    AdmissionRejectedError,
    PartitionService,
    PlanTicket,
    ServicePlan,
    graph_fingerprint,
)
from ..core.reorder import PackPlan
from ..device import resolve_device
from ..kernels.ops import (
    BucketSpec,
    make_bucketed_spmv_fn,
    make_ep_spmv_fn,
    pad_plan_operands,
    stack_combine_tables,
)

__all__ = [
    "BucketKey",
    "BucketPolicy",
    "CompileCache",
    "GraphRequest",
    "GraphServer",
    "ServeInfo",
    "ServeResult",
    "resolve_plan",
]


# ---------------------------------------------------------------------------
# Plan-kind resolution (moved here from kernels.ops)
# ---------------------------------------------------------------------------


def resolve_plan(plan, timeout: float | None = None) -> PackPlan:
    """Unwrap any plan-shaped handle to the host-side ``PackPlan``.

    Accepts a ``PackPlan`` (returned as-is), a ``ServicePlan`` (its packed
    plan; raises ``ValueError`` when the service ran without COO metadata
    and has none), or a ``PlanTicket`` (blocks up to ``timeout`` for the
    worker, then recurses on the resulting ServicePlan).  This is the only
    place scheduler handles are unwrapped — the kernel layer below takes
    PackPlans only.
    """
    if isinstance(plan, PackPlan):
        return plan
    if isinstance(plan, ServicePlan):
        if plan.plan is None:
            raise ValueError(
                "ServicePlan has no PackPlan (submitted without coo=); "
                "cannot serve SpMV from it"
            )
        return plan.plan
    if isinstance(plan, PlanTicket):
        return resolve_plan(plan.result(timeout), timeout)
    raise TypeError(
        f"expected PackPlan, ServicePlan, or PlanTicket; got {type(plan).__name__}"
    )


# ---------------------------------------------------------------------------
# Typed request / result surface
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GraphRequest:
    """One EP-SpMV serving request: matrix structure + values + input.

    Replaces the positional 6-tuple ``(n_rows, n_cols, rows, cols, vals,
    x)``.  ``tenant``/``priority`` feed the partition service's multi-tenant
    scheduler (cache budgets, queue order); ``timeout`` bounds the wait for
    a cold plan.  Arrays are normalized on construction (index arrays to
    int64, ``vals``/``x`` to float32 — the kernels' serving dtype).
    """

    n_rows: int
    n_cols: int
    rows: np.ndarray
    cols: np.ndarray
    vals: np.ndarray
    x: np.ndarray
    tenant: Optional[str] = None  # None -> server default
    priority: Optional[int] = None
    timeout: Optional[float] = None

    def __post_init__(self) -> None:
        self.rows = np.asarray(self.rows, dtype=np.int64)
        self.cols = np.asarray(self.cols, dtype=np.int64)
        self.vals = np.asarray(self.vals, dtype=np.float32)
        self.x = np.asarray(self.x, dtype=np.float32)
        if self.x.shape != (self.n_cols,):
            raise ValueError(f"x must have shape ({self.n_cols},), got {self.x.shape}")
        if not (self.rows.shape == self.cols.shape == self.vals.shape):
            raise ValueError("rows/cols/vals must have identical shapes")

    def vals_digest(self) -> str:
        return hashlib.blake2b(
            np.ascontiguousarray(self.vals).tobytes(), digest_size=16
        ).hexdigest()


@dataclasses.dataclass(frozen=True)
class ServeInfo:
    """Per-request serving metadata (the typed successor of the info dict)."""

    fingerprint: str
    cache_hit: bool  # plan cache (partition service)
    source: str  # "full" | "incremental"
    tenant: str
    partition_time_s: float
    bucket: Optional[str] = None  # bucket label, None = dedicated compile
    kernel_cache_hit: bool = False  # compiled-kernel cache
    batch_size: int = 1  # requests sharing this launch
    # True when a ReplicaGroup served a cached plan because no replica was
    # healthy (graceful degradation): the answer is correct for the plan it
    # was computed from, but optimization against the *current* request may
    # be pending.  Always False for a plain PartitionService.
    stale: bool = False
    # True when the brownout governor answered from cache because the
    # service was shedding load (admission rejections in the recent
    # window): the plan is a genuine warm hit, but no new partitioning
    # work was admitted for this request.
    degraded: bool = False

    def as_dict(self) -> dict:
        """Legacy dict view — superset of the old ``(y, info)`` keys."""
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class ServeResult:
    y: Any  # torch.Tensor on the server's device, length n_rows (de-padded)
    info: ServeInfo


# ---------------------------------------------------------------------------
# Shape buckets
# ---------------------------------------------------------------------------


def _ceil_mult(v: int, m: int) -> int:
    return ((v + m - 1) // m) * m if m > 0 else v


@dataclasses.dataclass(frozen=True)
class BucketKey:
    """One compile bucket: geometric ceilings of (rows, cols, nnz) + (k, mode).

    Two plans map to the same key exactly when they can share a compiled
    kernel; ``label`` is the human-readable cache/metrics key.
    """

    n_rows: int
    n_cols: int
    nnz: int
    k: int
    mode: str

    @property
    def label(self) -> str:
        return f"r{self.n_rows}c{self.n_cols}e{self.nnz}k{self.k}-{self.mode}"

    def spec(self, batch: int, pad: int = 128, slack: float = 0.30) -> BucketSpec:
        """Concrete padded-shape contract for this bucket.

        Per-cluster tile ceilings assume the partitioner's balance: each
        cluster holds at most ``ceil(nnz / k) * (1 + slack)`` tasks
        (``slack`` covers the balance eps + pad rounding), and a cluster
        can never touch more unique x/y entries than it has tasks — nor
        more than exist.  The serve path still double-checks
        ``spec.fits(plan)`` per request and falls back to a dedicated
        compile, so a pathologically skewed plan degrades to the old cost
        instead of miscomputing.
        """
        e_cap = int(math.ceil(self.nnz / max(self.k, 1) * (1.0 + slack)))
        e_max = _ceil_mult(max(e_cap, 1), pad)
        x_max = min(_ceil_mult(self.n_cols, pad), e_max)
        y_max = min(_ceil_mult(self.n_rows, pad), e_max)
        return BucketSpec(
            k=self.k,
            n_rows=self.n_rows,
            n_cols=self.n_cols,
            e_max=e_max,
            x_max=x_max,
            y_max=y_max,
            batch=batch,
            mode=self.mode,
        )


@dataclasses.dataclass(frozen=True)
class BucketPolicy:
    """Geometric bucket-ceiling policy: dims round up to ``floor * growth^i``.

    A request's (n_rows, n_cols, nnz) are each rounded up to the next
    geometric ceiling; requests beyond any ``max_*`` cap get no bucket
    (``bucket_for`` returns None) and are served through a dedicated
    per-structure compile — bounded shape blow-up, unbounded request sizes.
    With ``growth=2.0`` the padding waste is at most 2x per dim, and the
    number of distinct buckets grows logarithmically in the served size
    range — that log-sized set is what makes compile caching effective.
    """

    growth: float = 2.0
    min_rows: int = 256
    min_cols: int = 256
    min_nnz: int = 1024
    max_rows: int = 65536
    max_cols: int = 65536
    max_nnz: int = 1 << 20
    balance_slack: float = 0.30

    def _ceil_geom(self, v: int, floor: int, cap: int) -> Optional[int]:
        if v > cap:
            return None
        c = floor
        while c < v:
            c = int(math.ceil(c * self.growth))
        return min(c, cap)

    def bucket_for(self, padding, mode: str) -> Optional[BucketKey]:
        """Map a plan's ``PlanPadding`` to its bucket, or None if oversized."""
        r = self._ceil_geom(padding.n_rows, self.min_rows, self.max_rows)
        c = self._ceil_geom(padding.n_cols, self.min_cols, self.max_cols)
        e = self._ceil_geom(padding.nnz, self.min_nnz, self.max_nnz)
        if r is None or c is None or e is None:
            return None
        return BucketKey(n_rows=r, n_cols=c, nnz=e, k=padding.k, mode=mode)


# ---------------------------------------------------------------------------
# Compile cache: bounded, (size, recency) eviction, build-slot dedup
# ---------------------------------------------------------------------------


class CompileCache:
    """Bounded cache of compiled kernels with (size, recency) eviction.

    The old serve memo was a plain LRU over 64 entries that ignored
    compiled-kernel cost entirely — a giant bucket executable and a tiny
    dedicated one aged identically.  Here each entry carries a size (padded
    operand element count, a faithful proxy for both executable size and
    the retrace cost it shields); when over ``capacity`` the evictor scans
    the *oldest quarter* of entries and drops the largest one — strict LRU
    order among victims, size as the tiebreak within the old cohort, so a
    hot big bucket is never sacrificed for a cold small one.

    ``get_or_build`` is concurrency-safe per key: the first caller installs
    a build slot and compiles outside the lock; latecomers for the same key
    wait on the slot instead of compiling twice (their hits count as hits —
    the compile was shared).
    """

    def __init__(self, capacity: int = 32) -> None:
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._entries: OrderedDict[Any, tuple[Any, int]] = OrderedDict()
        self._building: dict[Any, threading.Event] = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self._per_key_hits: dict[Any, int] = {}

    def get_or_build(self, key, size: int, builder: Callable[[], Any]):
        """Return the cached callable for ``key``, building it at most once."""
        while True:
            with self._lock:
                hit = self._entries.get(key)
                if hit is not None:
                    self._entries.move_to_end(key)
                    self.hits += 1
                    self._per_key_hits[key] = self._per_key_hits.get(key, 0) + 1
                    return hit[0]
                slot = self._building.get(key)
                if slot is None:
                    slot = threading.Event()
                    self._building[key] = slot
                    self.misses += 1
                    break
            slot.wait()  # another thread is compiling this key
        try:
            fn = builder()
        except BaseException:
            with self._lock:
                del self._building[key]
            slot.set()
            raise
        with self._lock:
            self._entries[key] = (fn, int(size))
            del self._building[key]
            self._evict_locked()
        slot.set()
        return fn

    def _evict_locked(self) -> None:
        while len(self._entries) > self.capacity:
            keys = list(self._entries.keys())
            cohort = keys[: max(1, math.ceil(len(keys) / 4))]  # oldest quarter
            victim = max(cohort, key=lambda k: self._entries[k][1])
            del self._entries[victim]
            self._per_key_hits.pop(victim, None)
            self.evictions += 1

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._entries

    def hits_for(self, key) -> int:
        with self._lock:
            return self._per_key_hits.get(key, 0)

    def stats(self) -> dict:
        with self._lock:
            return {
                "capacity": self.capacity,
                "entries": len(self._entries),
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "size_elems": sum(s for _, s in self._entries.values()),
            }


# ---------------------------------------------------------------------------
# GraphServer
# ---------------------------------------------------------------------------


class _Pending:
    """One queued request inside the micro-batcher."""

    __slots__ = ("request", "sp", "ticket_hit", "stale", "degraded",
                 "operands", "t_enqueue", "event", "result", "error")

    def __init__(self, request, sp, ticket_hit, operands, t_enqueue,
                 stale: bool = False, degraded: bool = False) -> None:
        self.request = request
        self.sp = sp
        self.ticket_hit = ticket_hit
        self.stale = stale
        self.degraded = degraded
        self.operands = operands
        self.t_enqueue = t_enqueue
        self.event = threading.Event()
        self.result: Optional[ServeResult] = None
        self.error: Optional[BaseException] = None

    def wait(self, timeout: float | None = None) -> ServeResult:
        if not self.event.wait(timeout):
            raise TimeoutError("batched serve did not complete in time")
        if self.error is not None:
            raise self.error
        return self.result  # type: ignore[return-value]


class GraphServer:
    """EP-SpMV request server: plan service + bucket callables + batching.

    Owns the bucket-callable cache and the default ``tenant``/``priority``;
    every result lies on ``device`` (``None`` = the CUDA device, which must
    exist).  Two lanes:

    * :meth:`serve` — synchronous.  The request's plan picks a shape
      bucket; the batch-of-1 runs through the bucket's shared callable
      immediately (no coalescing delay).  Oversized or skewed plans fall
      back to a dedicated per-structure callable.
    * :meth:`submit` — queued.  Same-bucket requests arriving within
      ``max_wait_ms`` (or until ``max_batch`` fill) run as one stacked
      kernel launch; each caller's handle de-pads its own row.  Plan
      resolution still happens on the submitting thread, so the batcher
      never blocks on a cold partition.

    ``bucketing=None`` disables buckets entirely — every structure gets a
    dedicated callable through the same bounded cache.

    ``service`` is any object with the ``PartitionService`` submit surface —
    a single service or a ``core.replica.ReplicaGroup`` (replication with
    failover/hedging behind the same API; its degraded serves surface as
    ``ServeInfo.stale``).
    """

    def __init__(
        self,
        service: "PartitionService | Any",
        k: int,
        pad: int = 128,
        mode: str = "software",
        device=None,
        tenant: str = "default",
        priority: int = 0,
        bucketing: Optional[BucketPolicy] = BucketPolicy(),
        max_batch: int = 8,
        max_wait_ms: float = 2.0,
        compile_cache_entries: int = 32,
        start_batcher: bool = True,
        brownout_window_s: float = 1.0,
        brownout_hedge_off: int = 3,
        brownout_stale_only: int = 6,
        brownout_priority_floor: int = 1,
    ) -> None:
        self.service = service
        self.k = k
        self.pad = pad
        self.mode = mode
        self.device = resolve_device(device)
        self.tenant = tenant
        self.priority = priority
        self.bucketing = bucketing
        self.max_batch = max(1, int(max_batch))
        self.max_wait_ms = float(max_wait_ms)
        self.compile_cache = CompileCache(capacity=compile_cache_entries)
        # Padded operands per (structure, values, bucket), held on the
        # device with their summation runs and combine table: rebuilding
        # them sorts on the host, and repeated matrices are the common
        # serving case.  Plain LRU.
        self._operands: OrderedDict[tuple, tuple] = OrderedDict()
        self._operands_cap = 256
        self._lock = threading.Lock()
        self._batch_hist: dict[int, int] = {}
        # Brownout governor state: admission rejections observed in the
        # trailing window drive a degradation ladder — level 1 turns
        # hedging off (extra lanes amplify overload), level 2 answers
        # low-priority tenants from cache only; recovery is automatic as
        # rejections age out of the window.
        self.brownout_window_s = float(brownout_window_s)
        self.brownout_hedge_off = int(brownout_hedge_off)
        self.brownout_stale_only = int(brownout_stale_only)
        self.brownout_priority_floor = int(brownout_priority_floor)
        self._rejections: deque[float] = deque(maxlen=1024)
        self._hedge_saved: Optional[bool] = None
        self._degraded_serves = 0
        self._brownout_rejects = 0
        # Micro-batcher state: per-bucket-label deques of _Pending.
        self._queues: dict[Optional[str], list[_Pending]] = {}
        self._specs: dict[str, BucketSpec] = {}
        self._cv = threading.Condition()
        self._closed = False
        self._batcher: Optional[threading.Thread] = None
        if start_batcher:
            self._batcher = threading.Thread(
                target=self._batch_loop, name="graph-server-batcher", daemon=True
            )
            self._batcher.start()

    # -- brownout governor --------------------------------------------------

    def brownout_level(self) -> int:
        """0 = normal, 1 = hedging disabled, 2 = low-priority tenants are
        cache-only.  Derived from admission rejections in the trailing
        ``brownout_window_s`` — recovery is automatic once they age out."""
        now = time.perf_counter()
        with self._lock:
            while self._rejections and now - self._rejections[0] > self.brownout_window_s:
                self._rejections.popleft()
            n = len(self._rejections)
        if n >= self.brownout_stale_only:
            return 2
        if n >= self.brownout_hedge_off:
            return 1
        return 0

    def _note_rejection(self) -> None:
        with self._lock:
            self._rejections.append(time.perf_counter())

    def _apply_brownout(self, level: int) -> None:
        """First rung of the ladder: hedging multiplies submitted load, so
        it is the first thing to go under pressure (and the first thing
        restored on recovery).  No-op for services without a hedge knob."""
        svc = self.service
        if not hasattr(svc, "hedge"):
            return
        with self._lock:
            if level >= 1 and self._hedge_saved is None and svc.hedge:
                self._hedge_saved = svc.hedge
                svc.hedge = False
            elif level == 0 and self._hedge_saved is not None:
                svc.hedge = self._hedge_saved
                self._hedge_saved = None

    def _fingerprint(self, req: GraphRequest, edges) -> str:
        """The fingerprint ``service.submit`` would assign this request —
        computed here so the brownout path can probe caches without
        submitting any work."""
        opts = getattr(self.service, "default_opts", None)
        return graph_fingerprint(edges, self.k, self.pad, opts, "ep", 0,
                                 (req.n_rows, req.n_cols))

    # -- plan + bucket resolution ------------------------------------------

    def _plan_for(self, req: GraphRequest) -> tuple[ServicePlan, bool, bool, bool]:
        """``(plan, cache_hit, stale, degraded)`` for ``req``."""
        from ..core.graph import affinity_graph_from_coo

        edges = affinity_graph_from_coo(req.n_rows, req.n_cols, req.rows, req.cols)
        tenant = req.tenant if req.tenant is not None else self.tenant
        priority = req.priority if req.priority is not None else self.priority
        level = self.brownout_level()
        self._apply_brownout(level)
        fp: Optional[str] = None
        lookup = getattr(self.service, "lookup", None)
        if (level >= 2 and priority < self.brownout_priority_floor
                and lookup is not None):
            # Stale-only rung: answer low-priority tenants from cache
            # without admitting new work.  A cache miss rejects outright —
            # but is NOT counted as fresh rejection pressure, so brownout
            # cannot sustain itself once the real overload has passed.
            fp = self._fingerprint(req, edges)
            cached = lookup(fp, tenant)
            if cached is not None:
                with self._lock:
                    self._degraded_serves += 1
                return cached, True, False, True
            with self._lock:
                self._brownout_rejects += 1
            raise AdmissionRejectedError(
                f"brownout: tenant {tenant!r} is cache-only under overload "
                "and this graph is not cached",
                retry_after_s=self.brownout_window_s, tenant=tenant,
                reason="brownout")
        try:
            ticket = self.service.submit(
                edges,
                self.k,
                pad=self.pad,
                coo=(req.n_rows, req.n_cols, req.rows, req.cols),
                tenant=tenant,
                priority=priority,
                # End-to-end deadline: a ReplicaGroup stops failover retries
                # when it expires (a single PartitionService sheds queued
                # work past it — the result() wait below is the final bound).
                timeout=req.timeout,
            )
            sp = ticket.result(req.timeout)
        except AdmissionRejectedError:
            # The service shed this request.  Note the pressure (it drives
            # the ladder), then degrade to a pure cache answer if we can.
            self._note_rejection()
            self._apply_brownout(self.brownout_level())
            if lookup is not None:
                cached = lookup(fp or self._fingerprint(req, edges), tenant)
                if cached is not None:
                    with self._lock:
                        self._degraded_serves += 1
                    return cached, True, False, True
            raise
        # ``stale`` exists on ReplicaGroup tickets only (degraded serve).
        return sp, ticket.cache_hit, getattr(ticket, "stale", False), False

    def _bucket_for(self, sp: ServicePlan) -> Optional[tuple[str, BucketSpec]]:
        if self.bucketing is None or sp.plan is None or sp.padding is None:
            return None
        key = self.bucketing.bucket_for(sp.padding, self.mode)
        if key is None:
            return None
        spec = self._specs.get(key.label)
        if spec is None:
            spec = key.spec(
                self.max_batch, pad=self.pad, slack=self.bucketing.balance_slack
            )
            self._specs[key.label] = spec
        if not spec.fits(sp.plan):  # skewed plan: ceilings missed — degrade
            return None
        return key.label, spec

    def _bucket_operands(self, req: GraphRequest, sp: ServicePlan, label: str,
                         spec: BucketSpec) -> tuple:
        okey = (sp.fingerprint, req.vals_digest(), label)
        with self._lock:
            ops = self._operands.get(okey)
            if ops is not None:
                self._operands.move_to_end(okey)
                return ops
        ops = pad_plan_operands(sp.plan, req.vals, spec).to(self.device)
        with self._lock:
            self._operands[okey] = ops
            while len(self._operands) > self._operands_cap:
                self._operands.popitem(last=False)
        return ops

    def _bucket_fn(self, label: str, spec: BucketSpec):
        return self.compile_cache.get_or_build(
            ("bucket", label),
            spec.operand_elems(),
            lambda: make_bucketed_spmv_fn(spec, device=self.device),
        )

    def _dedicated_fn(self, req: GraphRequest, sp: ServicePlan):
        plan = sp.plan
        size = plan.k * (3 * plan.e_max + plan.x_max + plan.y_max) + plan.n_cols
        return self.compile_cache.get_or_build(
            ("dedicated", sp.fingerprint, req.vals_digest()),
            size,
            lambda: make_ep_spmv_fn(plan, req.vals, mode=self.mode,
                                    device=self.device),
        )

    def _record_batch(self, size: int) -> None:
        with self._lock:
            self._batch_hist[size] = self._batch_hist.get(size, 0) + 1

    # -- batched execution --------------------------------------------------

    def _run_bucket_batch(self, label: str, spec: BucketSpec,
                          group: list[_Pending]) -> None:
        """Execute up to ``spec.batch`` same-bucket requests as one launch."""
        misses_before = self.compile_cache.misses
        fn = self._bucket_fn(label, spec)
        kernel_hit = self.compile_cache.misses == misses_before
        b, dev = spec.batch, self.device
        tiles_e, tiles_y = (b, spec.k, spec.e_max), (b, spec.k, spec.y_max)
        vp = torch.zeros(tiles_e, dtype=torch.float32, device=dev)
        xl = torch.zeros(tiles_e, dtype=torch.int32, device=dev)
        yl = torch.zeros(tiles_e, dtype=torch.int32, device=dev)
        xg = torch.zeros((b, spec.k, spec.x_max), dtype=torch.int32, device=dev)
        # Empty batch slots scatter to the sentinel row, like plan tails,
        # and own no y slots: their seg rows stay all-zero.
        yg = torch.full(tiles_y, spec.n_rows, dtype=torch.int32, device=dev)
        seg = torch.zeros((b, spec.k, spec.y_max + 1), dtype=torch.int32, device=dev)
        xs = np.zeros((b, spec.n_cols), dtype=np.float32)
        tables = [None] * b
        for i, p in enumerate(group):
            ops = p.operands
            vp[i], xl[i], yl[i], xg[i], yg[i] = ops[:5]
            seg[i] = ops.seg
            tables[i] = (ops.row_ptr, ops.src)
            xs[i, : p.request.n_cols] = p.request.x
        table = stack_combine_tables(tables, spec.n_rows, spec.k * spec.y_max, dev)
        ys = fn(vp, xl, yl, xg, yg, torch.from_numpy(xs).to(dev),
                seg=seg, table=table)
        self._record_batch(len(group))
        for i, p in enumerate(group):
            info = ServeInfo(
                fingerprint=p.sp.fingerprint,
                cache_hit=p.ticket_hit,
                source=p.sp.source,
                tenant=(p.request.tenant if p.request.tenant is not None
                        else self.tenant),
                partition_time_s=p.sp.compute_time_s,
                bucket=label,
                kernel_cache_hit=kernel_hit,
                batch_size=len(group),
                stale=p.stale,
                degraded=p.degraded,
            )
            p.result = ServeResult(y=ys[i, : p.request.n_rows], info=info)
            p.event.set()

    def _run_dedicated(self, p: _Pending) -> None:
        misses_before = self.compile_cache.misses
        fn = self._dedicated_fn(p.request, p.sp)
        kernel_hit = self.compile_cache.misses == misses_before
        y = fn(p.request.x)
        self._record_batch(1)
        info = ServeInfo(
            fingerprint=p.sp.fingerprint,
            cache_hit=p.ticket_hit,
            source=p.sp.source,
            tenant=p.request.tenant if p.request.tenant is not None else self.tenant,
            partition_time_s=p.sp.compute_time_s,
            bucket=None,
            kernel_cache_hit=kernel_hit,
            batch_size=1,
            stale=p.stale,
            degraded=p.degraded,
        )
        p.result = ServeResult(y=y, info=info)
        p.event.set()

    def _batch_loop(self) -> None:
        wait_s = self.max_wait_ms / 1000.0
        while True:
            todo: list[tuple[Optional[str], list[_Pending]]] = []
            with self._cv:
                while True:
                    if self._closed and not any(self._queues.values()):
                        return
                    now = time.perf_counter()
                    deadline = None
                    for label, q in self._queues.items():
                        if not q:
                            continue
                        if (
                            label is None
                            or len(q) >= self.max_batch
                            or self._closed
                            or now - q[0].t_enqueue >= wait_s
                        ):
                            take = q if label is None else q[: self.max_batch]
                            todo.append((label, list(take)))
                            del q[: len(take)]
                        else:
                            d = q[0].t_enqueue + wait_s
                            deadline = d if deadline is None else min(deadline, d)
                    if todo:
                        break
                    self._cv.wait(
                        timeout=None if deadline is None else max(deadline - now, 0.0)
                    )
            for label, group in todo:
                try:
                    if label is None:
                        for p in group:
                            self._run_dedicated(p)
                    else:
                        self._run_bucket_batch(label, self._specs[label], group)
                except BaseException as e:  # resolve waiters, keep serving
                    for p in group:
                        if not p.event.is_set():
                            p.error = e
                            p.event.set()

    # -- public surface -----------------------------------------------------

    def serve(self, request: GraphRequest) -> ServeResult:
        """Synchronous lane: resolve plan, run a batch-of-1 immediately."""
        sp, ticket_hit, stale, degraded = self._plan_for(request)
        bucket = self._bucket_for(sp)
        if bucket is None:
            p = _Pending(request, sp, ticket_hit, None, time.perf_counter(),
                         stale=stale, degraded=degraded)
            self._run_dedicated(p)
            return p.wait()
        label, spec = bucket
        ops = self._bucket_operands(request, sp, label, spec)
        p = _Pending(request, sp, ticket_hit, ops, time.perf_counter(),
                     stale=stale, degraded=degraded)
        self._run_bucket_batch(label, spec, [p])
        return p.wait()

    def submit(self, request: GraphRequest) -> _Pending:
        """Queued lane: coalesce with same-bucket requests, return a handle.

        The handle's ``wait(timeout)`` returns the :class:`ServeResult`.
        Plan resolution (and any cold partition) runs on the calling
        thread; only the kernel launch is deferred to the batch window.
        """
        if self._batcher is None:
            raise RuntimeError("this GraphServer was built with start_batcher=False")
        sp, ticket_hit, stale, degraded = self._plan_for(request)
        bucket = self._bucket_for(sp)
        if bucket is None:
            p = _Pending(request, sp, ticket_hit, None, time.perf_counter(),
                         stale=stale, degraded=degraded)
            label = None
        else:
            label, spec = bucket
            ops = self._bucket_operands(request, sp, label, spec)
            p = _Pending(request, sp, ticket_hit, ops, time.perf_counter(),
                         stale=stale, degraded=degraded)
        with self._cv:
            if self._closed:
                raise RuntimeError("GraphServer is closed")
            self._queues.setdefault(label, []).append(p)
            self._cv.notify()
        return p

    def stats(self) -> dict:
        """Compile-cache counters + batch-size histogram + per-bucket specs."""
        with self._lock:
            hist = dict(sorted(self._batch_hist.items()))
            per_bucket = {
                label: {
                    "batch": spec.batch,
                    "e_max": spec.e_max,
                    "n_rows": spec.n_rows,
                    "n_cols": spec.n_cols,
                    "operand_elems": spec.operand_elems(),
                    "hits": self.compile_cache.hits_for(("bucket", label)),
                    "compiled": ("bucket", label) in self.compile_cache,
                }
                for label, spec in self._specs.items()
            }
        s = self.compile_cache.stats()
        s["batch_hist"] = hist
        s["buckets"] = per_bucket
        with self._lock:
            s["degraded_serves"] = self._degraded_serves
            s["brownout_rejects"] = self._brownout_rejects
        s["brownout_level"] = self.brownout_level()
        return s

    def metrics(self):
        """Partition-service ``ServiceMetrics`` with compile-cache counters
        merged into its ``compile_cache`` field."""
        snap = self.service.metrics()
        snap.compile_cache.update(self.stats())
        return snap

    def close(self) -> None:
        """Flush the queue and stop the batcher thread (idempotent)."""
        with self._cv:
            if self._closed:
                self._cv.notify()
            self._closed = True
            self._cv.notify()
        if self._batcher is not None and self._batcher.is_alive():
            self._batcher.join(timeout=10.0)

    def __enter__(self) -> "GraphServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
