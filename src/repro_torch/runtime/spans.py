"""Spans and counters of the train step: where its host and device time go.

Tracing is off by default: then a :func:`traced` function is called
directly, and :func:`span` costs a check of two module-level flags and
returns one shared null context; neither opens a profiler range, records an
event or allocates.  It is on while a ``torch.profiler`` session records,
or between :func:`enable` and :func:`disable`.  While it is on, a span

  * opens ``torch.profiler.record_function(name)``, so that it sits in any
    profiler trace beside the device's kernels, on the profiler's clock;
  * records its host start and end (``perf_counter_ns``), the span that
    encloses it (its parent), and its phase: ``forward``, ``recompute`` (a
    forward run again by ``torch.utils.checkpoint`` inside the backward
    pass), ``backward`` (the backward half, below) or ``step`` (the train
    step's own parts around the model);
  * in a step on a CUDA device, records a timing event on the current
    stream at each end.

**Backward halves.**  :func:`traced` puts an identity ``autograd.Function``
on each argument and result that autograd will differentiate (never in a
recompute, whose graph is not differentiated).  In the backward pass the
first mark to run records the half's start and the last argument mark its
end: a record of the same name in phase ``backward``.  The marks change no
number.  :func:`span` marks nothing (the train step's parts, :data:`BLOCK`).

**Steps.**  Records are kept for the train step that :func:`step` opens, in
a ring of the last :data:`RING` steps; outside a step a span only opens its
profiler range.  :func:`count` adds to the step's counters (a device tensor
is added on the device and never read inside the step): ``train_step.syncs``
(:func:`sync`) and the model's ``moe.kept_pairs``, ``moe.slots``,
``dot_f32.tensor_core``, ``dot_f32.float32``, ``attention.fused`` and
``attention.chunked``.  :func:`steps` synchronises once and returns each
step's spans and counters as numbers.  Device times are placed on the step's
own device timeline (milliseconds from the step's first event), so that
overlapping records of one name are counted once by whoever sums them.  In
a step on the CPU every device time is None.
"""
from __future__ import annotations

import collections
import functools
import threading
import time
from typing import Optional

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import record_function

__all__ = ["BLOCK", "NULL", "RING", "clear", "count", "disable", "enable", "is_on", "length", "span",
           "step", "steps", "subtract", "sync", "traced", "union"]

#: Train steps kept in memory.
RING = 16
STEP = "repro_torch.train_step"
BLOCK = "repro_torch.block"  # a block that remat runs again in the backward pass
SYNC = "repro_torch.sync."

_forced = False
_ring: collections.deque = collections.deque(maxlen=RING)
_current: Optional["_Step"] = None
_local = threading.local()


def enable() -> None:
    """Turn tracing on until :func:`disable` (a profiler session turns it
    on by itself for as long as it records)."""
    global _forced
    _forced = True


def disable() -> None:
    global _forced
    _forced = False


def is_on() -> bool:
    return _forced or _autograd_profiler._is_profiler_enabled


class _Null:
    """The context every span site gets while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


NULL = _Null()


def span(name: str, phase: Optional[str] = None):
    """A context manager timing the code it encloses under ``name``.
    ``phase`` defaults to ``recompute`` inside autograd's backward pass and
    to ``forward`` elsewhere."""
    if not (_forced or _autograd_profiler._is_profiler_enabled):
        return NULL
    return _Span(name, phase)


def traced(name: str):
    """Decorate a function to run each call under the span ``name``, its
    backward half included: each argument (positional or keyword) and each
    result (alone or in a tuple) that autograd will differentiate is marked.
    While tracing is off the function is called directly."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not (_forced or _autograd_profiler._is_profiler_enabled):
                return fn(*args, **kwargs)
            with _Span(name, None) as sp:
                # marks only where the graph they sit in is differentiated later
                if sp.step is None or sp.rec.phase == "recompute" or not torch.is_grad_enabled():
                    return fn(*args, **kwargs)
                half = _Half(name, sp.step)
                out = fn(*(_mark(a, half, True) for a in args),
                         **{k: _mark(v, half, True) for k, v in kwargs.items()})
                if isinstance(out, tuple):
                    return tuple(_mark(t, half, False) for t in out)
                return _mark(out, half, False)

        return call

    return wrap


def sync(site: str):
    """A span around a place where the host waits on the device
    (``repro_torch.sync.<site>``); each counts one ``train_step.syncs``."""
    if not (_forced or _autograd_profiler._is_profiler_enabled):
        return NULL
    return _Span(SYNC + site, None, syncs=1)


def step(device):
    """The train step's span (:data:`STEP`), which opens a step of the ring;
    its spans time the device when ``device`` is a CUDA device."""
    if not (_forced or _autograd_profiler._is_profiler_enabled):
        return NULL
    return _StepSpan(STEP, "step", cuda=torch.device(device).type == "cuda")


def count(name: str, value) -> None:
    """Add ``value`` (a number or a 0-d tensor) to the current step's
    counter ``name``.  Counts in a forward pass: a forward that
    ``torch.utils.checkpoint`` runs again in the backward pass is not
    counted again."""
    if not (_forced or _autograd_profiler._is_profiler_enabled):
        return
    if _current is not None and not _in_backward():
        _current.add(name, value)


def _in_backward() -> bool:
    return torch._C._current_graph_task_id() != -1


def _stack() -> list:
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
    return s


class _Record:
    __slots__ = ("name", "phase", "parent", "t0", "t1", "e0", "e1")

    def __init__(self, name, phase, parent):
        self.name, self.phase, self.parent = name, phase, parent
        self.t0 = self.t1 = None
        self.e0 = self.e1 = None


def _event(st):
    """A timing event recorded on the current stream, in a step on CUDA."""
    if st is None or not st.cuda:
        return None
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


class _HalfRecord(_Record):
    __slots__ = ()


class _Step:
    __slots__ = ("records", "counters", "stack", "halves", "cuda", "e0")

    def __init__(self, stack: list, cuda: bool):
        self.cuda = cuda
        self.records: list = []
        self.counters: dict = {}
        self.stack = stack  # the stepping thread's open spans: the parents of other threads'
        self.halves: dict = {}  # each thread's backward halves started and not yet ended
        self.e0 = None

    def add(self, name: str, value) -> None:
        if isinstance(value, torch.Tensor):
            value = value.detach()
        old = self.counters.get(name)
        self.counters[name] = value if old is None else old + value


def _parent(stack: list, st: Optional[_Step]):
    """The later opened of the innermost span and the innermost backward
    half open on this thread, else the innermost span of the stepping
    thread (autograd's own threads run the backward pass on CUDA)."""
    halves = st.halves.get(threading.get_ident()) if st is not None else None
    open_ = [x[-1] for x in (stack, halves) if x]
    if open_:
        return max(open_, key=lambda r: r.t0)
    if st is not None and st.stack is not stack and st.stack:
        return st.stack[-1]
    return None


class _Span:
    __slots__ = ("rec", "rf", "step", "syncs")

    def __init__(self, name: str, phase: Optional[str], syncs: int = 0):
        self.rec = _Record(name, phase or ("recompute" if _in_backward() else "forward"), None)
        self.step, self.syncs = _current, syncs

    def __enter__(self):
        stack = _stack()
        self.rec.parent = _parent(stack, self.step)
        self.rf = record_function(self.rec.name)
        self.rf.__enter__()
        self.rec.t0 = time.perf_counter_ns()
        self.rec.e0 = _event(self.step)
        stack.append(self.rec)
        return self

    def __exit__(self, *exc):
        self.rec.e1 = _event(self.step)
        self.rec.t1 = time.perf_counter_ns()
        stack = _stack()
        if stack and stack[-1] is self.rec:
            stack.pop()
        self.rf.__exit__(*exc)
        if self.step is not None and self.step is _current:
            self.step.records.append(self.rec)
            if self.syncs:
                self.step.add("train_step.syncs", self.syncs)
        return None


def _mark(t, half: "_Half", is_input: bool):
    """``t``, with a mark of ``half`` where autograd will differentiate it."""
    if isinstance(t, torch.Tensor) and t.requires_grad:
        return _Mark.apply(t, half, is_input)
    return t


class _StepSpan(_Span):
    __slots__ = ("cuda",)

    def __init__(self, name: str, phase: str, cuda: bool):
        super().__init__(name, phase)
        self.cuda = cuda

    def __enter__(self):
        global _current
        st = _Step(_stack(), self.cuda)
        _current = self.step = st
        super().__enter__()
        st.e0 = self.rec.e0
        return self

    def __exit__(self, *exc):
        global _current
        super().__exit__(*exc)
        _ring.append(self.step)
        _current = None
        return None


class _Half:
    """The backward half of a span: started by the first of its marks that
    autograd runs, ended by the last of its input marks."""

    __slots__ = ("rec", "step", "pending", "open_in")

    def __init__(self, name: str, st: _Step):
        self.rec = _HalfRecord(name, "backward", None)
        self.step = st
        self.pending = 0
        self.open_in = None

    def start(self) -> None:
        if self.rec.t0 is None:
            self.rec.parent = _parent(_stack(), self.step)
            self.rec.t0 = time.perf_counter_ns()
            self.rec.e0 = _event(self.step)
            self.open_in = self.step.halves.setdefault(threading.get_ident(), [])
            self.open_in.append(self.rec)

    def end(self) -> None:
        self.pending -= 1
        if self.pending:
            return
        self.rec.e1 = _event(self.step)
        self.rec.t1 = time.perf_counter_ns()
        self.open_in.remove(self.rec)
        if self.step is _current:
            self.step.records.append(self.rec)


class _Mark(torch.autograd.Function):
    """Identity; its backward starts or ends a span's backward half."""

    @staticmethod
    def forward(ctx, t, half, is_input):
        ctx.half, ctx.is_input = half, is_input
        if is_input:
            half.pending += 1
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        ctx.half.start()
        if ctx.is_input:
            ctx.half.end()
        return grad, None, None


def steps() -> list[dict]:
    """The ring's steps, oldest first: ``{"spans": [...], "counters": {...}}``.

    Each span: ``name``, ``parent`` (its name, or None), ``phase``,
    ``host_ms``, and on CUDA (None on the CPU) ``device_intervals``, the
    ``[start, end]`` milliseconds it covers on the step's device timeline
    (from the step's first event), ``device_ms``, their length, and
    ``self_device_ms``, that less the part its children cover.  A backward
    half that a remat block's recompute (:data:`BLOCK`) ran inside leaves
    that recompute out, and the recompute's parent is the half's: it is the
    block's forward run again, not the half's work."""
    if any(st.e0 is not None for st in _ring):
        torch.cuda.synchronize()
    return [_step_dict(st) for st in list(_ring)]


def _step_dict(st: _Step) -> dict:
    recs = [r for r in st.records if r.t1 is not None]
    dev = {}
    for r in recs:
        if st.e0 is not None and r.e0 is not None and r.e1 is not None:
            dev[id(r)] = [(st.e0.elapsed_time(r.e0), st.e0.elapsed_time(r.e1))]
    parent = {id(r): r.parent for r in recs}
    recomputes = []
    for r in recs:
        if r.name == BLOCK and r.phase == "recompute":
            p = r.parent  # the block's forward is not the work of the halves it ran in
            while isinstance(p, _HalfRecord):
                p = p.parent
            parent[id(r)] = p
            recomputes += dev.get(id(r), [])
    for r in recs:
        if isinstance(r, _HalfRecord) and id(r) in dev:
            dev[id(r)] = subtract(dev[id(r)], recomputes)
    kids = collections.defaultdict(list)
    for r in recs:
        if parent[id(r)] is not None and id(r) in dev:
            kids[id(parent[id(r)])].extend(dev[id(r)])
    out = []
    for r in recs:
        p = parent[id(r)]
        item = {"name": r.name, "parent": None if p is None else p.name,
                "phase": r.phase, "host_ms": (r.t1 - r.t0) / 1e6, "device_intervals": None,
                "device_ms": None, "self_device_ms": None}
        if id(r) in dev:
            own = dev[id(r)]
            item.update(device_intervals=[list(iv) for iv in own], device_ms=length(own),
                        self_device_ms=length(subtract(own, kids[id(r)])))
        out.append(item)
    counters = {k: (v.item() if isinstance(v, torch.Tensor) else v) for k, v in st.counters.items()}
    return {"spans": out, "counters": counters}


def union(intervals) -> list:
    """``(start, end)`` intervals merged where they overlap, in order."""
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def length(intervals) -> float:
    """The length of the union of ``(start, end)`` intervals."""
    return sum(b - a for a, b in union(intervals))


def subtract(intervals, cuts) -> list:
    """The parts of ``intervals`` that no interval of ``cuts`` covers."""
    out = []
    cuts = union(cuts)
    for a, b in union(intervals):
        for c, d in cuts:
            if d <= a or c >= b:
                continue
            if c > a:
                out.append((a, c))
            a = max(a, d)
            if a >= b:
                break
        if a < b:
            out.append((a, b))
    return out


def clear() -> None:
    """Forget every recorded step."""
    _ring.clear()
