# Copied from src/repro/runtime/fault.py (its five classes, verbatim but one line); keep them in step.
"""Fault tolerance of the port (standard library only at import).

``CircuitBreaker``, ``OverloadSchedule``, ``HeartbeatRegistry``,
``StragglerMonitor`` and ``FaultTolerantLoop`` are copies of the classes of
the same name in ``src/repro/runtime/fault.py``: ``core/replica.py`` builds
replica health, failover breakers and flood schedules on the first four;
``FaultTolerantLoop`` drives training steps, checkpoints every
``ckpt_every`` steps (async) and, when a step raises, restores the latest
complete checkpoint and goes on from there, up to ``max_restarts`` times.
The one line that differs is ``FaultTolerantLoop``'s structure template,
which the reference builds with ``jax.tree.map``: here it is the state
itself (restore reads only its structure and layout, so a sharded run
restarts on its own mesh and placements).  ``CheckpointManager`` is named
for type checkers only, so that importing this module (as a replica worker
does) loads no torch.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import TYPE_CHECKING, Any, Callable, Optional

if TYPE_CHECKING:
    from ..ckpt import CheckpointManager

__all__ = [
    "CircuitBreaker",
    "HeartbeatRegistry",
    "OverloadSchedule",
    "StragglerMonitor",
    "FaultTolerantLoop",
]


class CircuitBreaker:
    """Classic closed → open → half-open breaker over a failure signal.

    ``record_failure`` counts consecutive failures; at ``failures_to_trip``
    the breaker *opens* and ``allow()`` answers False for ``cooldown_s``.
    After the cooldown, exactly one caller is admitted as a *half-open
    probe* (``allow()`` True once; concurrent callers keep getting False);
    a ``record_success`` closes the breaker, another failure re-opens it
    for a fresh cooldown.  ``ReplicaGroup`` keys one breaker per
    (replica, tenant) so a flooding tenant's rejections stop its own
    dispatches without blacklisting the replica for everyone else.

    Thread-safe; ``clock`` is injectable for deterministic tests.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, failures_to_trip: int = 3, cooldown_s: float = 1.0,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if failures_to_trip < 1:
            raise ValueError("failures_to_trip must be >= 1")
        self.failures_to_trip = failures_to_trip
        self.cooldown_s = cooldown_s
        self._clock = clock
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probing = False
        self.trips = 0  # total open transitions (monotonic)

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        """May a call proceed right now?  In half-open, only the single
        probe slot answers True."""
        with self._lock:
            if self._state == self.CLOSED:
                return True
            if self._state == self.OPEN:
                if self._clock() - self._opened_at < self.cooldown_s:
                    return False
                self._state = self.HALF_OPEN
                self._probing = False
            # half-open: hand out the one probe slot.
            if self._probing:
                return False
            self._probing = True
            return True

    def record_success(self) -> None:
        with self._lock:
            self._state = self.CLOSED
            self._failures = 0
            self._probing = False

    def record_failure(self) -> None:
        with self._lock:
            if self._state == self.HALF_OPEN:
                # Failed probe: straight back to open, fresh cooldown.
                self._state = self.OPEN
                self._opened_at = self._clock()
                self._probing = False
                self.trips += 1
                return
            self._failures += 1
            if self._state == self.CLOSED and self._failures >= self.failures_to_trip:
                self._state = self.OPEN
                self._opened_at = self._clock()
                self.trips += 1

    def blocked(self) -> bool:
        """True while calls would be refused (open and still cooling, or
        half-open with the probe slot taken).  Read-only: unlike
        ``allow()``, never consumes the probe slot — but it does surface
        the open→half-open transition so 'every breaker blocked' can't
        deadlock against a probe nobody asks for."""
        with self._lock:
            if self._state == self.CLOSED:
                return False
            if self._state == self.OPEN:
                if self._clock() - self._opened_at < self.cooldown_s:
                    return True
                self._state = self.HALF_OPEN
                self._probing = False
            return self._probing

    def retry_in(self) -> float:
        """Seconds until the cooldown admits a probe (0 when not open)."""
        with self._lock:
            if self._state != self.OPEN:
                return 0.0
            return max(0.0, self.cooldown_s - (self._clock() - self._opened_at))

class OverloadSchedule:
    """Deterministic per-tenant load-factor windows for fault injection.

    ``add(tenant, start_s, duration_s, factor)`` arms a window (relative to
    the schedule's epoch) during which ``factor_at(tenant)`` reports the
    flood multiplier; outside every window it reports 1.0.  Drives the
    ``FaultInjector.flood`` probe: the bench's flooding tenant reads its
    current factor each round instead of wall-clock guessing.
    """

    def __init__(self, clock: Callable[[], float] = time.monotonic) -> None:
        self._clock = clock
        self._epoch = clock()
        self._windows: dict[str, list[tuple[float, float, float]]] = {}

    def add(self, tenant: str, start_s: float, duration_s: float,
            factor: float) -> "OverloadSchedule":
        self._windows.setdefault(tenant, []).append(
            (start_s, start_s + duration_s, factor))
        return self

    def factor_at(self, tenant: str, now: Optional[float] = None) -> float:
        t = (self._clock() if now is None else now) - self._epoch
        for start, end, factor in self._windows.get(tenant, ()):
            if start <= t < end:
                return factor
        return 1.0

class HeartbeatRegistry:
    """Host liveness with deadlines; no threads — callers pump ``check``."""

    def __init__(self, deadline_s: float = 60.0, on_dead: Optional[Callable[[str], None]] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.deadline_s = deadline_s
        self.on_dead = on_dead
        self.clock = clock
        self.last_seen: dict[str, float] = {}
        self.dead: set[str] = set()

    def register(self, host: str) -> None:
        """Seed the deadline clock for *host* without counting a beat.

        ``check`` only scans ``last_seen``, so a host that registered but
        never beat was previously invisible — it could stay silent forever
        without ever being reported dead.  Registration starts the clock: a
        registered host that never beats is declared dead ``deadline_s``
        after this call.  Re-registering a known host is a no-op (it neither
        refreshes the deadline nor resurrects a dead host — only a real
        ``beat`` does that).
        """
        self.last_seen.setdefault(host, self.clock())

    def beat(self, host: str) -> None:
        self.last_seen[host] = self.clock()
        self.dead.discard(host)

    def alive(self, host: str) -> bool:
        """True while *host* is not marked dead — the routing-weight check.

        Works for hearts that beat locally and for beats that arrive over a
        wire (``core/transport.py`` credits a beat only when the remote
        worker answers a ping): the registry never cares how the beat
        traveled, only when it last landed."""
        return host not in self.dead

    def check(self) -> list[str]:
        now = self.clock()
        newly_dead = []
        for host, t in self.last_seen.items():
            if host not in self.dead and now - t > self.deadline_s:
                self.dead.add(host)
                newly_dead.append(host)
                if self.on_dead:
                    self.on_dead(host)
        return newly_dead

class StragglerMonitor:
    """EWMA step-time tracker; flags outlier steps."""

    def __init__(self, threshold: float = 2.0, alpha: float = 0.2,
                 on_straggler: Optional[Callable[[int, float, float], None]] = None):
        self.threshold = threshold
        self.alpha = alpha
        self.ewma: Optional[float] = None
        self.events: list[tuple[int, float, float]] = []
        self.on_straggler = on_straggler

    def record(self, step: int, dt: float) -> bool:
        is_straggler = False
        if self.ewma is not None and dt > self.threshold * self.ewma:
            self.events.append((step, dt, self.ewma))
            is_straggler = True
            if self.on_straggler:
                self.on_straggler(step, dt, self.ewma)
            # Do not fold outliers into the baseline.
        else:
            self.ewma = dt if self.ewma is None else (1 - self.alpha) * self.ewma + self.alpha * dt
        return is_straggler


@dataclasses.dataclass
class FaultTolerantLoop:
    """Checkpoint/restart driver around a (state, batch) -> (state, metrics)
    step function and a stateless batch source ``batch_fn(step)``."""

    step_fn: Callable[[Any, dict], tuple[Any, dict]]
    batch_fn: Callable[[int], dict]
    ckpt: CheckpointManager
    ckpt_every: int = 10
    max_restarts: int = 3
    straggler: Optional[StragglerMonitor] = None

    def run(self, state: Any, start_step: int, num_steps: int) -> tuple[Any, list[dict]]:
        history: list[dict] = []
        step = start_step
        restarts = 0
        abstract = state  # structure template
        while step < start_step + num_steps:
            try:
                t0 = time.perf_counter()
                batch = self.batch_fn(step)
                state, metrics = self.step_fn(state, batch)
                dt = time.perf_counter() - t0
                if self.straggler is not None:
                    self.straggler.record(step, dt)
                history.append({"step": step, **{k: float(v) for k, v in metrics.items()}})
                step += 1
                if step % self.ckpt_every == 0:
                    self.ckpt.save(step, state)
            except (FileNotFoundError, KeyboardInterrupt):
                raise
            except Exception:
                restarts += 1
                if restarts > self.max_restarts:
                    raise
                latest = self.ckpt.latest()
                if latest is None:
                    # No checkpoint yet: restart from the caller's state.
                    step = start_step
                    continue
                step, state = self.ckpt.restore(abstract, latest)
        self.ckpt.wait()
        return state, history
