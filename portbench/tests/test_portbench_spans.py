"""The readers of the program's spans and counters, on hand-built records:
a ``steps()`` result of the program's span module, and a reduced device
trace whose idle gaps lie inside and outside the program's sync ranges."""
import sys
from types import SimpleNamespace

import pytest

from portbench import spec
from portbench.trace import Trace

READERS = ("device_ms.dot_f32", "device_ms.attention", "device_ms.moe_dispatch", "device_ms.adamw",
           "host_ms.train_step", "moe_fill.train")
P = "repro_torch."


def _span(name, phase, host_ms, *intervals, parent=None):
    ivs = [list(iv) for iv in intervals] or None
    dev = sum(b - a for a, b in intervals) if intervals else None
    return {"name": name, "parent": parent, "phase": phase, "host_ms": host_ms,
            "device_intervals": ivs, "device_ms": dev, "self_device_ms": dev}


def _step(scale=1.0, kept=600, slots=1000):
    s = scale
    return {"spans": [
        _span(P + "train_step", "step", 100.0 * s, (0, 100 * s)),
        _span(P + "dot_f32", "forward", 1.0, (10, 14)),
        _span(P + "dot_f32", "forward", 1.0, (12, 16)),  # overlaps the one before: counted once
        _span(P + "dot_f32", "recompute", 1.0, (40, 43)),
        _span(P + "dot_f32", "backward", 1.0, (50, 55)),
        _span(P + "attention", "forward", 2.0, (20, 30)),
        _span(P + "attention", "backward", 2.0, (60, 62), (70, 75)),  # a recompute left out
        _span(P + "moe.route", "forward", 1.0, (30, 31)),
        _span(P + "moe.dispatch", "forward", 1.0, (31, 33)),
        _span(P + "moe.experts", "forward", 1.0, (33, 38)),
        _span(P + "moe.combine", "backward", 1.0, (80, 84)),
        _span(P + "train_step.optimizer", "step", 3.0, (90, 90 + 8 * s)),
        _span(P + "sync.rope_theta", "forward", 0.5 * s, (17, 17.1)),
        _span(P + "sync.rope_theta", "recompute", 0.25, (44, 44.1)),
    ], "counters": {"moe.kept_pairs": kept, "moe.slots": slots, "train_step.syncs": 2}}


@pytest.fixture
def program(monkeypatch):
    from repro_torch.runtime import spans

    held = []
    monkeypatch.setattr(spans, "steps", lambda: list(held))
    return held


def _ctx(trace=None):
    return SimpleNamespace(mix={"traced": {"device": 2, "host": 1}}, trace=trace)


def test_readers_on_hand_built_steps(program):
    # two device-stretch steps, then the host-traced one, which is not read
    program += [_step(1.0, 600, 1000), _step(2.0, 700, 1000), _step(50.0, 0, 1000)]
    got = {m: spec.reader(m)(_ctx()) for m in READERS}
    assert got["device_ms.dot_f32"] == pytest.approx(6 + 3 + 5)
    assert got["device_ms.attention"] == pytest.approx(10 + 7)
    assert got["device_ms.moe_dispatch"] == pytest.approx(1 + 2 + 4)  # experts left out
    assert got["device_ms.adamw"] == pytest.approx((8 + 16) / 2)
    assert got["host_ms.train_step"] == pytest.approx(((100 - 0.75) + (200 - 1.25)) / 2)
    assert got["moe_fill.train"] == pytest.approx(100 * 1300 / 2000)


@pytest.mark.parametrize("metric", READERS)
def test_readers_give_none_on_an_empty_ring(program, metric):
    assert spec.reader(metric)(_ctx()) is None


@pytest.mark.parametrize("metric", READERS)
def test_readers_give_none_without_the_programs_spans(monkeypatch, metric):
    monkeypatch.setitem(sys.modules, "repro_torch.runtime.spans", None)  # import fails
    assert spec.reader(metric)(_ctx()) is None


def test_device_readers_give_none_without_device_times(program):
    step = _step()
    for s in step["spans"]:
        s.update(device_intervals=None, device_ms=None, self_device_ms=None)
    program.append(step)
    assert spec.reader("device_ms.dot_f32")(_ctx()) is None
    assert spec.reader("host_ms.train_step")(_ctx()) == pytest.approx(99.25)  # host clock only


def _trace(host):
    # device operations (name, start_us, dur_us): gaps 10-20, 30-50, 60-64, 70-100
    ops = [("k", 0.0, 10.0), ("k", 20.0, 10.0), ("k", 50.0, 10.0), ("k", 64.0, 6.0),
           ("k", 100.0, 5.0)]
    return Trace(ops=[], window_s=0.0, host=host, host_ops=ops)


def test_idle_sync_counts_gaps_whose_middle_lies_in_a_sync_range():
    host = [
        ("repro_torch.train_step", 0.0, 110.0, 1),
        ("aten::copy_", 5.0, 12.0, 1),
        ("repro_torch.sync.rope_theta", 8.0, 16.0, 1),  # holds the middle (15) of the gap 10-20
        ("repro_torch.sync.rope_theta", 35.0, 45.0, 2),  # on autograd's thread: the gap 30-50
        ("repro_torch.sync.rope_theta", 58.0, 61.0, 2),  # the gap 60-64 starts in it, ends after
        ("aten::mul", 70.0, 71.0, 1),
    ]
    got = spec.reader("idle_sync.train")(_ctx(_trace(host)))
    assert got == pytest.approx(100 * (10 + 20) / (10 + 20 + 4 + 30))


def test_idle_sync_gives_none_without_the_programs_step_range():
    host = [("portbench.train_step", 0.0, 110.0, 1), ("aten::copy_", 5.0, 12.0, 1)]
    assert spec.reader("idle_sync.train")(_ctx(_trace(host))) is None
    assert spec.reader("idle_sync.train")(_ctx(Trace(ops=[], window_s=0.0))) is None
    assert spec.reader("idle_sync.train")(_ctx(None)) is None


def test_idle_sync_reads_zero_where_no_gap_lies_in_a_wait():
    host = [("repro_torch.train_step", 0.0, 110.0, 1)]
    assert spec.reader("idle_sync.train")(_ctx(_trace(host))) == 0.0
