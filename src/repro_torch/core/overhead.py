# Copied verbatim from src/repro/core/overhead.py; keep the two in step.
"""Adaptive overhead control (paper §4.2).

The partitioner runs on a separate host (CPU) thread while the accelerator
executes the unoptimized kernel; once the optimized schedule is ready, the
program switches over.  The first optimized invocation is timed against the
rolling baseline average, and if it is slower the scheduler *falls back*
permanently — guaranteeing no slowdown (paper Figure 14 shows gains or
parity everywhere thanks to this control).
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Optional

__all__ = ["AdaptiveScheduler"]


class AdaptiveScheduler:
    """Asynchronous optimize-then-switch execution controller.

    Parameters
    ----------
    baseline_fn:
        The unoptimized step, called as ``baseline_fn(*args, **kw)``.
    optimize_fn:
        Host-side optimization job (e.g. edge partitioning + pack-plan
        construction).  Runs once on a background thread; its return value
        is handed to ``build_optimized_fn``.
    build_optimized_fn:
        ``plan -> step_fn``; e.g. closes a Pallas kernel over the pack plan.
    min_baseline_samples:
        Baseline timings to collect before an optimized run may be judged.
    """

    def __init__(
        self,
        baseline_fn: Callable[..., Any],
        optimize_fn: Callable[[], Any],
        build_optimized_fn: Callable[[Any], Callable[..., Any]],
        min_baseline_samples: int = 2,
    ):
        self._baseline_fn = baseline_fn
        self._build = build_optimized_fn
        self._min_samples = min_baseline_samples
        self._plan: Any = None
        self._optimized_fn: Optional[Callable[..., Any]] = None
        self._error: Optional[BaseException] = None
        self.state = "baseline"  # baseline -> optimized | fallback
        self.baseline_times: list[float] = []
        self.optimized_times: list[float] = []
        self.calls = 0
        self.optimized_calls = 0

        def _job():
            try:
                self._plan = optimize_fn()
            except BaseException as e:  # surfaced on next step
                self._error = e

        self._thread = threading.Thread(target=_job, daemon=True)
        self._t_opt_start = time.perf_counter()
        self._thread.start()
        self.optimize_time_s: Optional[float] = None

    # -- public ----------------------------------------------------------

    def ready(self) -> bool:
        return self._plan is not None and not self._thread.is_alive()

    def wait(self, timeout: Optional[float] = None) -> bool:
        self._thread.join(timeout)
        return self.ready()

    @property
    def plan(self) -> Any:
        return self._plan

    def __call__(self, *args, **kw):
        self.calls += 1
        if self._error is not None:
            err, self._error = self._error, None
            self.state = "fallback"
            raise err
        if self.state == "baseline" and self.ready():
            if self.optimize_time_s is None:
                self.optimize_time_s = time.perf_counter() - self._t_opt_start
            self._optimized_fn = self._build(self._plan)
            self.state = "optimized"
        if self.state == "optimized":
            t0 = time.perf_counter()
            out = self._optimized_fn(*args, **kw)
            dt = time.perf_counter() - t0
            self.optimized_times.append(dt)
            self.optimized_calls += 1
            # Judge the FIRST optimized run against the baseline average
            # (skipping it would hide a permanently-slower kernel).
            if (
                self.optimized_calls == 2  # first timed run after warmup/compile
                and len(self.baseline_times) >= self._min_samples
            ):
                base_avg = sum(self.baseline_times) / len(self.baseline_times)
                if dt > base_avg:
                    self.state = "fallback"
            return out
        t0 = time.perf_counter()
        out = self._baseline_fn(*args, **kw)
        self.baseline_times.append(time.perf_counter() - t0)
        return out

    def summary(self) -> dict:
        return {
            "state": self.state,
            "calls": self.calls,
            "optimized_calls": self.optimized_calls,
            "optimize_time_s": self.optimize_time_s,
            "baseline_avg_s": (
                sum(self.baseline_times) / len(self.baseline_times)
                if self.baseline_times
                else None
            ),
            "optimized_avg_s": (
                sum(self.optimized_times) / len(self.optimized_times)
                if self.optimized_times
                else None
            ),
        }
