"""The train step's spans and counters (``repro_torch.runtime.spans``) on the CPU.

Off, every span site gets one shared null context, a traced function is
called directly, and a step stores nothing; on (under ``torch.profiler`` or
:func:`spans.enable`), a reduced qwen3-moe step with remat stores every span
with its parent and phase, the MoE counters count each forward pass once,
and the step's numbers are bit for bit those of a step with tracing off; a
reduced moonlight step's latent-attention and shared-expert spans sit where
qwen's MoE spans do.  Device times are None here: the structure is checked
by the host clock.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import Model, moe
from repro_torch.models.transformer import moe_capacity
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import spans
from repro_torch.runtime.train import init_train_state, make_train_step, split_microbatches

N_MB = 2


@pytest.fixture(autouse=True)
def _clean():
    spans.disable()
    spans.clear()
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)
    spans.disable()
    spans.clear()


def _cfg(compute_dtype="float32", arch="qwen3-moe-30b-a3b"):
    cfg = get_config(arch, reduced=True)
    assert cfg.remat
    return dataclasses.replace(cfg, compute_dtype=compute_dtype)


def _batch(cfg, b=4, s=32, seed=0):
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.integers(2, cfg.vocab_size, (b, s)).astype(np.int32))
            for k in ("tokens", "labels")}


def _stepper(cfg):
    model = Model(cfg, "cpu")
    opt = AdamWConfig()
    return model, opt, make_train_step(model, opt, num_microbatches=N_MB)


def _profiled_step(arch: str) -> dict:
    """One reduced train step of ``arch`` under ``torch.profiler`` on the
    CPU: the recorded step, and its counters against an independent count."""
    spans.disable()
    spans.clear()
    cfg = _cfg(arch=arch)
    model, opt, step = _stepper(cfg)
    batch = _batch(cfg)
    state = init_train_state(model, opt, 0)
    kept = _independent_kept_pairs(model, state, batch)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(state, batch)
    recorded = spans.steps()
    names = {e.key for e in prof.key_averages()}
    spans.clear()
    return {"cfg": cfg, "steps": recorded, "kept": kept, "profiled": names}


@pytest.fixture(scope="module")
def traced_step():
    return _profiled_step("qwen3-moe-30b-a3b")


@pytest.fixture(scope="module")
def traced_moonlight_step():
    return _profiled_step("moonlight-16b-a3b")


def _independent_kept_pairs(model, state, batch) -> int:
    """``dispatch``'s kept pairs, summed over the step's forward passes,
    counted by running each microbatch's loss once without a graph."""
    total = [0]
    real = moe.dispatch

    def counting(*a, **k):
        slab, rows, keep = real(*a, **k)
        total[0] += int(keep.sum())
        return slab, rows, keep

    moe.dispatch = counting
    try:
        mbs = split_microbatches(batch, N_MB)
        with torch.no_grad():
            for i in range(N_MB):
                model.loss_fn(state.params, {k: v[i] for k, v in mbs.items()})
    finally:
        moe.dispatch = real
    return total[0]


# ---------------------------------------------------------------------------
# Off
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("site", ["span", "sync", "step"])
def test_off_returns_the_shared_null_context(site, monkeypatch):
    """Off, each context site is the one null context, and a traced
    function called inside it returns its own result object and enters no
    profiler range."""
    def refuse(*a, **k):
        raise AssertionError("a profiler range was entered while tracing is off")

    monkeypatch.setattr(spans, "record_function", refuse)
    ctx = {"span": lambda: spans.span("repro_torch.dot_f32"), "sync": lambda: spans.sync("x"),
           "step": lambda: spans.step("cpu")}[site]()
    assert ctx is spans.NULL
    x = torch.ones(2, requires_grad=True)
    result = (x * 2, "label")
    traced = spans.traced("repro_torch.dot_f32")(lambda a, *, b: result)
    with ctx:
        assert traced(x, b=x) is result


def test_off_a_step_stores_nothing_and_enters_no_profiler_range(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a profiler range was entered while tracing is off")

    monkeypatch.setattr(spans, "record_function", refuse)
    cfg = _cfg()
    model, opt, step = _stepper(cfg)
    step(init_train_state(model, opt, 0), _batch(cfg))
    assert spans.steps() == []


# ---------------------------------------------------------------------------
# On: every span of the step, with its parent and phase
# ---------------------------------------------------------------------------

P = "repro_torch."
TS = P + "train_step"
EXPECTED = {
    TS: {(None, "step")},
    TS + ".forward": {(TS, "forward")},
    TS + ".backward": {(TS, "backward")},
    TS + ".grad_scale": {(TS, "step")},
    TS + ".optimizer": {(TS, "step")},
    P + "loss": {(TS + ".forward", "forward"), (TS + ".backward", "backward")},
    P + "block": {(TS + ".forward", "forward"), (TS + ".backward", "recompute")},
    P + "attention": {(P + "block", "forward"), (P + "block", "recompute"),
                      (TS + ".backward", "backward")},
    P + "dot_f32": {(P + "loss", ph) for ph in ("forward", "recompute", "backward")}
    | {(P + "moe.route", ph) for ph in ("forward", "recompute", "backward")}
    | {(P + "moe.experts", ph) for ph in ("forward", "recompute", "backward")},
    **{P + "moe." + k: {(P + "block", "forward"), (P + "block", "recompute"),
                        (TS + ".backward", "backward")}
       for k in ("route", "dispatch", "experts", "combine")},
    P + "sync.rope_theta": {(P + "block", "forward"), (P + "block", "recompute")},
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_on_each_span_with_its_parent_and_phase(traced_step, name):
    (st,) = traced_step["steps"]
    got = {(s["parent"], s["phase"]) for s in st["spans"] if s["name"] == name}
    assert got == EXPECTED[name]
    for s in st["spans"]:
        if s["name"] == name:
            assert s["host_ms"] >= 0 and s["device_ms"] is None  # no device on the CPU
    assert name in traced_step["profiled"]  # a profiler range of the same name


MOONLIGHT = {name: {(P + "block", "forward"), (P + "block", "recompute"),
                    (TS + ".backward", "backward")}
             for name in (P + "mla.project", P + "moe.shared")}


@pytest.mark.parametrize("name", sorted(MOONLIGHT))
def test_on_moonlight_span_with_its_parent_and_phase(traced_moonlight_step, name):
    """The reduced moonlight step's latent attention and shared experts,
    each in every remat block's forward and recompute and in the backward
    pass, with the per-pass counts of qwen's MoE spans."""
    (st,) = traced_moonlight_step["steps"]
    got = [(s["parent"], s["phase"]) for s in st["spans"] if s["name"] == name]
    assert set(got) == MOONLIGHT[name]
    cfg = traced_moonlight_step["cfg"]
    layers = cfg.n_layers if name.endswith("project") else cfg.n_layers - cfg.first_k_dense
    for phase in ("forward", "recompute", "backward"):
        assert sum(1 for _, ph in got if ph == phase) == layers * N_MB
    assert name in traced_moonlight_step["profiled"]


def test_on_no_other_span_and_counts_per_pass(traced_step):
    (st,) = traced_step["steps"]
    assert {s["name"] for s in st["spans"]} == set(EXPECTED)
    cfg = traced_step["cfg"]
    n = cfg.n_layers * N_MB  # MoE layers times microbatches
    by = lambda name, ph: sum(1 for s in st["spans"] if s["name"] == name and s["phase"] == ph)
    for k in ("route", "dispatch", "experts", "combine"):
        assert by(P + "moe." + k, "forward") == by(P + "moe." + k, "backward") == n
    assert by(P + "attention", "recompute") == n and by(P + "block", "recompute") == n
    assert by(TS + ".forward", "forward") == by(TS + ".backward", "backward") == N_MB
    # θ copied for q and for k in each layer's forward and again in its recompute
    assert st["counters"]["train_step.syncs"] == 2 * 2 * n


def test_kept_pairs_match_an_independent_count_once_despite_remat(traced_step):
    (st,) = traced_step["steps"]
    cfg = traced_step["cfg"]
    c = st["counters"]
    assert c["moe.kept_pairs"] == traced_step["kept"]
    tokens = 4 * 32 // N_MB
    slots = cfg.n_layers * N_MB * cfg.moe.n_experts * moe_capacity(cfg, tokens)
    assert c["moe.slots"] == slots
    assert 0 < c["moe.kept_pairs"] <= min(slots, cfg.n_layers * 4 * 32 * cfg.moe.top_k)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_tracing_changes_no_number(compute_dtype):
    cfg = _cfg(compute_dtype)
    batch = _batch(cfg, seed=1)
    out = []
    for on in (False, True):
        model, opt, step = _stepper(cfg)
        state = init_train_state(model, opt, 0)
        if on:
            spans.enable()
        state, metrics = step(state, batch)
        spans.disable()
        leaves = {n: (p.detach().clone(), p.grad.clone())
                  for n, p in state.params.named_parameters()}
        moments = [t.clone() for t in state.opt_state["m"].parameters()]
        out.append((float(metrics["loss"]), float(metrics["grad_norm"]), leaves, moments))
    (l0, g0, p0, m0), (l1, g1, p1, m1) = out
    assert l0 == l1 and g0 == g1
    for n in p0:
        assert torch.equal(p0[n][0], p1[n][0]), n
        assert torch.equal(p0[n][1], p1[n][1]), n
    assert all(torch.equal(a, b) for a, b in zip(m0, m1))
    assert len(spans.steps()) == 1


@pytest.mark.parametrize("by", ["position", "keyword"])
def test_a_traced_function_given_a_detached_tensor_records_its_backward_half(by):
    """A traced function given one tensor autograd differentiates and one
    detached marks only the first: its backward half ends when that mark is
    reached, and a non-tensor in its returned tuple passes through."""
    spans.enable()

    @spans.traced("repro_torch.t")
    def scaled(x, y):
        return x * y, "label"

    w = torch.ones(3, requires_grad=True)
    c = torch.full((3,), 2.0, requires_grad=True).detach()
    with spans.step("cpu"):
        out, label = scaled(w, c) if by == "position" else scaled(x=w, y=c)
        out.sum().backward()
    (st,) = spans.steps()
    got = [(s["parent"], s["phase"]) for s in st["spans"] if s["name"] == "repro_torch.t"]
    assert sorted(got) == [(TS, "backward"), (TS, "forward")]
    assert label == "label" and torch.equal(w.grad, c)


def test_ring_keeps_the_last_steps():
    spans.enable()
    for i in range(spans.RING + 5):
        with spans.step("cpu"):
            spans.count("i", i)
    got = spans.steps()
    assert len(got) == spans.RING
    assert [st["counters"]["i"] for st in got] == list(range(5, spans.RING + 5))


def test_outside_a_step_nothing_is_kept():
    spans.enable()
    with spans.span("repro_torch.dot_f32"):
        spans.count("n", 1)
    assert spans.steps() == []


def test_sync_spans_count_the_waits():
    spans.enable()
    with spans.step("cpu"):
        for _ in range(3):
            with spans.sync("site"):
                pass
    (st,) = spans.steps()
    assert st["counters"] == {"train_step.syncs": 3}
    assert [s["name"] for s in st["spans"]].count("repro_torch.sync.site") == 3


def test_a_count_in_a_recompute_is_not_counted_again():
    """A forward under ``torch.utils.checkpoint`` counts once: its recompute
    in the backward pass is not counted."""
    spans.enable()

    def body(x):
        spans.count("seen", 1)
        return (x * x).sum()

    x = torch.ones(3, requires_grad=True)
    with spans.step("cpu"):
        torch.utils.checkpoint.checkpoint(body, x, use_reentrant=False).backward()
    (st,) = spans.steps()
    assert st["counters"] == {"seen": 1}


# ---------------------------------------------------------------------------
# Device timelines, with events that stand in for CUDA's
# ---------------------------------------------------------------------------


class _Ev:
    def __init__(self, t):
        self.t = t

    def elapsed_time(self, other):
        return other.t - self.t


def _rec(cls, name, phase, parent, a, b):
    r = cls(name, phase, parent)
    r.t0, r.t1, r.e0, r.e1 = 0, 1, _Ev(a), _Ev(b)
    return r


def test_a_backward_half_leaves_out_a_block_recompute_inside_it():
    st = spans._Step([], cuda=True)
    st.e0 = _Ev(0.0)
    top = _rec(spans._Record, "repro_torch.train_step", "step", None, 0.0, 100.0)
    half = _rec(spans._HalfRecord, "repro_torch.moe.combine", "backward", top, 10.0, 50.0)
    block = _rec(spans._Record, spans.BLOCK, "recompute", half, 20.0, 40.0)
    inner = _rec(spans._HalfRecord, "repro_torch.dot_f32", "backward", half, 42.0, 45.0)
    st.records = [top, half, block, inner]
    got = {s["name"]: s for s in spans._step_dict(st)["spans"]}
    comb = got["repro_torch.moe.combine"]
    assert comb["device_intervals"] == [[10.0, 20.0], [40.0, 50.0]]
    assert comb["device_ms"] == 20.0
    assert comb["self_device_ms"] == 17.0  # less dot_f32's 3 ms; the recompute is not its own
    assert got[spans.BLOCK]["device_ms"] == 20.0
    assert got["repro_torch.train_step"]["self_device_ms"] == 60.0


@pytest.mark.parametrize("ivs,cuts,want", [
    ([(0, 10)], [(2, 3), (5, 7)], [(0, 2), (3, 5), (7, 10)]),
    ([(0, 10)], [(-1, 11)], []),
    ([(0, 4), (6, 10)], [(3, 7)], [(0, 3), (7, 10)]),
    ([(0, 4)], [], [(0, 4)]),
])
def test_interval_arithmetic(ivs, cuts, want):
    assert spans.subtract(ivs, cuts) == want
    assert spans.length(ivs + cuts) == sum(b - a for a, b in spans.union(ivs + cuts))
