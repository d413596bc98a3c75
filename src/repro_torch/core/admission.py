# Copied verbatim from src/repro/core/admission.py; keep the two in step.
"""Bounded admission control for the plan scheduler — overload protection.

The paper's §3–4 argument is that admitting the wrong work into a bounded
resource destroys throughput for every sharer; PR 5's multitenant bench
applied that to the *cache* (per-tenant byte budgets), but the scheduler's
priority heap stayed unbounded: a flooding tenant could queue-starve
everyone, and a request whose end-to-end deadline was already unmeetable
still consumed a worker slot.  This module is the admission half of the
fix (``PlanScheduler`` owns the shedding half):

* :class:`AdmissionRejectedError` — typed over-limit rejection carrying a
  ``retry_after_s`` hint derived from the observed drain rate, so a
  well-behaved client can back off for exactly as long as the queue needs
  to make room.  Pickles faithfully (the hint must cross the
  ``core/transport.py`` wire intact).
* :class:`DeadlineShedError` — the scheduler shed a job because its
  p50-predicted service time already exceeded its remaining deadline
  budget; retrying is pointless, which is why this is *not* an
  ``AdmissionRejectedError`` (no retry hint).
* :class:`AdmissionController` — a configurable queue bound split into
  per-tenant weighted-fair token buckets.  Each tenant may hold queue
  slots up to its weight's share of the bound among *currently active*
  tenants (work-conserving: a lone tenant can fill the whole queue; the
  moment a second tenant shows up the shares contract), with a floor of
  one slot so no tenant can be starved outright.  Tokens are taken at
  submit and returned when the job leaves the queue (worker pickup,
  cancel, shed, or close-drain) — replenish-on-drain, not wall-clock
  refill, so admission decisions are deterministic under injected load.

The controller is deliberately lock-free: every method is called under
``PlanScheduler._cv``'s lock (or a test's single thread), mirroring how
the scheduler guards its own counters.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Callable, Optional

__all__ = [
    "AdmissionController",
    "AdmissionRejectedError",
    "DeadlineShedError",
]


class AdmissionRejectedError(RuntimeError):
    """The request was refused at admission: the tenant's weighted-fair
    share of the bounded queue is full.  ``retry_after_s`` estimates when a
    slot will have drained (from the observed completion rate); clients
    that wait that long and resubmit are load-shaping, not retry-storming.
    """

    def __init__(self, message: str = "", retry_after_s: float = 0.0,
                 tenant: str = "default", reason: str = "queue_full") -> None:
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)
        self.tenant = tenant
        self.reason = reason

    def __reduce__(self):
        # Default exception pickling replays ``args`` only; the hint and
        # tenant must survive the wire (transport answers rejections as
        # typed error frames and the client re-raises this object).
        msg = self.args[0] if self.args else ""
        return (type(self), (msg, self.retry_after_s, self.tenant, self.reason))


class DeadlineShedError(RuntimeError):
    """The job was shed because its p50-predicted service time exceeded
    the remaining deadline budget — it could not have finished in time, so
    failing fast returns the worker slot to requests that still can."""


class AdmissionController:
    """Queue-bound admission with per-tenant weighted-fair token buckets.

    ``max_queue_depth`` is the total number of queue slots.  A tenant's
    bucket capacity is ``max(1, floor(bound * w / sum(active weights)))``
    where the active set is every tenant currently holding at least one
    slot plus the requester — shares are recomputed per decision, so the
    bound partitions itself among whoever is actually competing.

    ``retry_after(tenant)`` converts the tenant's excess occupancy into
    seconds via the drain-rate estimator (:meth:`note_drained` timestamps,
    recorded by the scheduler on every job completion).  With no drain
    history the hint is exactly ``retry_floor_s`` — a deterministic
    fallback the transport tests byte-compare across the wire.
    """

    def __init__(
        self,
        max_queue_depth: int,
        tenant_weights: Optional[dict[str, float]] = None,
        default_weight: float = 1.0,
        retry_floor_s: float = 0.05,
        retry_cap_s: float = 5.0,
        clock: Callable[[], float] = time.perf_counter,
    ) -> None:
        if max_queue_depth < 1:
            raise ValueError("max_queue_depth must be >= 1")
        if default_weight <= 0:
            raise ValueError("default_weight must be > 0")
        self.max_queue_depth = int(max_queue_depth)
        self.default_weight = float(default_weight)
        self.retry_floor_s = float(retry_floor_s)
        self.retry_cap_s = float(retry_cap_s)
        self._clock = clock
        self._weights = {t: float(w) for t, w in (tenant_weights or {}).items()}
        for t, w in self._weights.items():
            if w <= 0:
                raise ValueError(f"tenant weight for {t!r} must be > 0")
        self._held: dict[str, int] = {}  # tenant -> queue slots held
        self._drained: deque[float] = deque(maxlen=64)  # completion times

    # -- shares --------------------------------------------------------------

    def weight(self, tenant: str) -> float:
        return self._weights.get(tenant, self.default_weight)

    def share(self, tenant: str) -> int:
        """Slots ``tenant`` may hold right now: its weighted share of the
        bound among active tenants, floored at one slot."""
        active = {t for t, n in self._held.items() if n > 0}
        active.add(tenant)
        total = sum(self.weight(t) for t in active)
        return max(1, int(self.max_queue_depth * self.weight(tenant) / total))

    def held(self, tenant: str) -> int:
        return self._held.get(tenant, 0)

    def occupancy(self) -> dict[str, int]:
        return {t: n for t, n in self._held.items() if n > 0}

    # -- admit / release -----------------------------------------------------

    def try_acquire(self, tenant: str) -> Optional[AdmissionRejectedError]:
        """Take one queue slot for ``tenant``; returns None on success or
        the (unraised) rejection describing why and when to retry."""
        held = self._held.get(tenant, 0)
        share = self.share(tenant)
        if held < share:
            self._held[tenant] = held + 1
            return None
        hint = self.retry_after(tenant)
        return AdmissionRejectedError(
            f"admission rejected for tenant {tenant!r}: holding {held} of "
            f"{share} queue slots (bound {self.max_queue_depth}); "
            f"retry in {hint:.3g}s",
            retry_after_s=hint, tenant=tenant, reason="queue_full")

    def release(self, tenant: str) -> None:
        """Return one slot (job left the queue: pickup/cancel/shed/drain)."""
        held = self._held.get(tenant, 0)
        if held <= 1:
            self._held.pop(tenant, None)
        else:
            self._held[tenant] = held - 1

    # -- drain-rate estimator ------------------------------------------------

    def note_drained(self, now: Optional[float] = None) -> None:
        """Record one job completion — the queue's drain signal."""
        self._drained.append(self._clock() if now is None else now)

    def drain_rate(self) -> float:
        """Completions per second over the recent drain window (0 when
        fewer than two completions have been observed)."""
        if len(self._drained) < 2:
            return 0.0
        span = self._drained[-1] - self._drained[0]
        if span <= 0.0:
            return 0.0
        return (len(self._drained) - 1) / span

    def retry_after(self, tenant: str) -> float:
        """Seconds until the tenant's excess occupancy should have drained,
        clamped to [retry_floor_s, retry_cap_s]."""
        excess = max(1, self._held.get(tenant, 0) - self.share(tenant) + 1)
        rate = self.drain_rate()
        est = excess / rate if rate > 0.0 else self.retry_floor_s
        return min(max(est, self.retry_floor_s), self.retry_cap_s)

    # -- introspection -------------------------------------------------------

    def snapshot(self) -> dict:
        return {
            "max_queue_depth": self.max_queue_depth,
            "occupancy": self.occupancy(),
            "drain_rate": self.drain_rate(),
        }
