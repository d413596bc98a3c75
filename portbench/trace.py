"""The device trace of a traced run, reduced to what the per-layer readers take.

``torch.profiler`` records the host's operations and the device's kernels,
copies and memsets over a stretch of the measured window; its Chrome trace
(written to ``TMPDIR`` and removed) is read once into a :class:`Trace`:
each device operation's name, start and length; the device's busy time
(the union of its operations) and the traced window's length; and the idle
gaps between device operations, each named by what the host was doing at
its middle (the outermost span this benchmark records and the innermost
host operation).
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import os
import tempfile
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
SPAN_PREFIX = "portbench."


@dataclasses.dataclass
class Trace:
    ops: list  # (name, start_us, dur_us) of every device operation of the device stretch
    window_s: float  # the device stretch's length
    host: list = dataclasses.field(default_factory=list)  # (name, start_us, end_us, thread)
    host_ops: list = dataclasses.field(default_factory=list)  # device operations beside them

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in _union([(s, s + d) for _, s, d in self.ops])) / 1e6

    def top_ops(self, n: int = 10) -> list:
        by = defaultdict(float)
        for name, _, d in self.ops:
            by[name] += d / 1e6
        return sorted(([k[:200], v] for k, v in by.items()), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10) -> list:
        """The idle time between device operations, summed by what the host
        was doing at each gap's middle, largest first."""
        busy = _union([(s, s + d) for _, s, d in self.host_ops])
        threads = [_Nest(evs) for evs in _by_thread(self.host)]
        by = defaultdict(float)
        for (_, e0), (s1, _) in zip(busy, busy[1:]):
            mid = (e0 + s1) / 2
            found = [t.at(mid) for t in threads]
            found = [f for f in found if f is not None]
            span = next((f[0] for f in found if f[0]), "")
            op = max(found, key=lambda f: f[2])[1] if found else ""
            by[" > ".join(x for x in (span, op) if x) or "(no host operation)"] += (s1 - e0) / 1e6
        return sorted(([k[:200], v] for k, v in by.items()), key=lambda kv: -kv[1])[:n]


def _by_thread(host: list) -> list:
    out = defaultdict(list)
    for e in host:
        out[e[3]].append(e)
    return list(out.values())


class _Nest:
    """One thread's host events, nested: what it was doing at a moment."""

    def __init__(self, events: list):
        self.ev = sorted(events, key=lambda e: (e[1], -e[2]))
        self.starts = [e[1] for e in self.ev]
        self.parent, stack = [], []
        for i, (_, s, e, _) in enumerate(self.ev):
            while stack and self.ev[stack[-1]][2] < s:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def at(self, t: float):
        """``(outermost span, innermost operation, its start)`` at ``t``, or None."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.ev[i][2] < t:
            i = self.parent[i]
        if i < 0:
            return None
        inner, span, j = None, "", i
        while j >= 0:
            name = self.ev[j][0]
            if name.startswith(SPAN_PREFIX):
                span = name
            elif inner is None:
                inner = j
            j = self.parent[j]
        if inner is None:
            return (span, "", self.ev[i][1])
        return (span, self.ev[inner][0], self.ev[inner][1])


def _union(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Profiler:
    """Two stretches of the window, one after the other.  The device
    stretch (``device`` iterations) records the device alone, which costs
    the host little: busy time, window and device operations come from it.
    The host stretch (``host`` iterations) records the host's operations
    too, which slows the host: the idle gaps are named from it.  The entry
    calls :meth:`begin` before each iteration and :meth:`end` once its
    results are on the host; ``trace`` is then the reduced :class:`Trace`."""

    def __init__(self, device: int, host: int):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._torch, self._profile = torch, profile
        self._cuda = torch.cuda.is_available()
        cuda = [ProfilerActivity.CUDA] if self._cuda else []
        self._acts = {"device": cuda, "host": [ProfilerActivity.CPU] + cuda}
        self.n = {"device": device, "host": host}
        if self._cuda:  # the device tracer's first start is slow: take it in set-up
            for acts in self._acts.values():
                with profile(activities=acts):
                    torch.ones(1, device="cuda").add_(1)
                    torch.cuda.synchronize()
        self.trace = Trace(ops=[], window_s=0.0)
        self._prof = None

    def traced(self, i: int) -> bool:
        return i < self.n["device"] + self.n["host"]

    def begin(self, i: int) -> None:
        import time

        for kind, first in (("device", 0), ("host", self.n["device"])):
            if i == first and self.n[kind] and self._acts[kind]:
                self._prof = self._profile(activities=self._acts[kind])
                self._prof.start()
                self._t0 = time.perf_counter()

    def end(self, i: int) -> None:
        """After iteration ``i``; also once after the window's last iteration
        (``i = None``) to close a stretch the window cut short."""
        import time

        if self._prof is None:
            return
        n_dev = self.n["device"]
        last = i is None or i + 1 in (n_dev, n_dev + self.n["host"])
        if not last:
            return
        if self._cuda:
            self._torch.cuda.synchronize()
        window_s = time.perf_counter() - self._t0
        self._prof.stop()
        ops, host = _events(self._prof)
        self._prof = None
        if i is not None and i < n_dev or (i is None and not self.trace.window_s):
            self.trace.ops, self.trace.window_s = ops, window_s
        else:
            self.trace.host, self.trace.host_ops = host, ops


def _events(prof) -> tuple[list, list]:
    """``(device operations, host operations)`` of a stopped profiler."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    ops, host = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            ops.append((e["name"], float(e["ts"]), float(e.get("dur", 0.0))))
        elif cat in HOST_CATS:
            start = float(e["ts"])
            host.append((e["name"], start, start + float(e.get("dur", 0.0)), e.get("tid")))
    return ops, host
