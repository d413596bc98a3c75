"""A training job: the program's ``make_train_step`` on the mix's batches, one step after another.

Set-up builds the model, the seed's float32 masters made trainable, AdamW's
state and the step, and drives that one state through the mix's first
``checked_steps`` steps, on batches 0, 1, 2, ... of the seed, through the
same call the window makes: those steps warm every shape and are what the
check compares (each step's loss; each leaf's norm of the first step's
gradient as the optimizer took it, ``|m| / (1 - b1)`` after one step; each
leaf's norm of its change over the checked steps).  The window then goes on
with the same state on the next batches; a step is started only while the
window is open, and the window ends when the last one started is done.
Once it has closed and the program's state is freed, the plain reference
runs the checked steps again from the seed.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import time

import torch
from torch.profiler import record_function

from .. import check, generate, weights
from ..reference import train as ref_train
from ..reference.common import REF, Prec, strict
from ..spec import dims
from . import program

CONTROL = Prec(lowp=True)


@dataclasses.dataclass
class Step:
    tokens: int
    start: float
    done: float
    traced: bool


class Job:
    def __init__(self, conf: dict, mix: dict, device):
        from repro_torch.models import Model
        from repro_torch.optim import AdamWConfig, warmup_cosine
        from repro_torch.runtime.train import make_train_step

        self.conf, self.mix, self.device = conf, mix, torch.device(device)
        self.m = dims(conf)
        self.model = Model(program.arch_config(conf), self.device)
        lr = mix["lr"]
        self.opt = AdamWConfig(lr=warmup_cosine(lr["peak"], lr["warmup_steps"], lr["total_steps"]),
                               b1=ref_train.B1, b2=ref_train.B2, eps=ref_train.EPS,
                               weight_decay=ref_train.WEIGHT_DECAY, clip_norm=ref_train.CLIP)
        self.step_fn = make_train_step(self.model, self.opt, num_microbatches=mix["microbatches"])
        self.state = None

    def load(self, seed: int) -> None:
        from repro_torch.optim import adamw_init
        from repro_torch.runtime.train import TrainState

        masters = program.params(self.model, self.conf, seed, self.device).requires_grad_()
        self.state = TrainState(params=masters, opt_state=adamw_init(self.opt, masters),
                                step=torch.zeros((), dtype=torch.int32, device=self.device))

    def batch(self, seed: int, step: int) -> dict:
        return generate.train_batch(self.mix, seed, self.m.vocab, step)

    def step(self, host_batch: dict) -> float:
        """One step; returns its loss, on the host."""
        with record_function("portbench.train_step"):
            with record_function("portbench.upload"):
                batch = {k: torch.from_numpy(v).to(self.device) for k, v in host_batch.items()}
            self.state, metrics = self.step_fn(self.state, batch)
            with record_function("portbench.readback"):
                return float(metrics["loss"])

    def checked(self, seed: int) -> dict:
        """The first steps, and what the check compares of them."""
        out = {"loss": []}
        for i in range(self.mix["checked_steps"]):
            out["loss"].append(self.step(self.batch(seed, i)))
            if i == 0:
                m = program.leaves(self.state.opt_state["m"])
                out["grad_norm"] = {k: float(torch.linalg.vector_norm(t)) / (1 - self.opt.b1)
                                    for k, t in m.items()}
        masters = program.leaves(self.state.params)
        out["change"] = {}
        for g in weights.groups(self.conf):
            for p, t0 in weights.draw(self.conf, seed, g, self.device).items():
                out["change"][g, p] = float(torch.linalg.vector_norm(masters[g, p] - t0))
        return out

    def window(self, seed: int, seconds: float, profiler=None) -> list[Step]:
        first = self.mix["checked_steps"]
        nxt = self.batch(seed, first)
        records: list[Step] = []
        t0 = time.perf_counter()
        end, start = t0 + seconds, t0
        while start < end:
            i = len(records)
            if profiler is not None:
                profiler.begin(i)
            host_batch = nxt
            self.step(host_batch)
            done = time.perf_counter()
            traced = profiler is not None and profiler.traced(i)
            records.append(Step(host_batch["tokens"].size, start, done, traced))
            if profiler is not None:
                profiler.end(i)
            nxt = self.batch(seed, first + i + 1)
            start = time.perf_counter()
        if profiler is not None:
            profiler.end(None)
        return records

    def free(self) -> None:
        self.state = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def reference(conf: dict, mix: dict, seed: int, device, prec: Prec = REF) -> dict:
    strict()
    m = dims(conf)
    batches = [{k: torch.from_numpy(v).to(device)
                for k, v in generate.train_batch(mix, seed, m.vocab, i).items()}
               for i in range(mix["checked_steps"])]
    return ref_train.steps(conf, mix, seed, batches, prec, device)


def compare(got: dict, want: dict) -> dict:
    """``loss_err``: the worst step's relative gap of losses; ``grad_err``
    and ``change_err``: the worst leaf's gap of norms (:func:`check.leaf_gaps`);
    ``grad_median``: the median leaf's gap of first-gradient norms, which a
    lower precision moves on every seed where a worst leaf swings."""
    loss = max((abs(g - w) / abs(w) for g, w in zip(got["loss"], want["loss"])), default=0.0)
    if len(got["loss"]) != len(want["loss"]):
        loss = float("inf")
    grad = check.leaf_gaps(got["grad_norm"], want["grad_norm"], want["grad_norm"])
    return {"loss_err": loss, "grad_err": check.worst(grad), "grad_median": check.median(grad),
            "change_err": check.worst(check.leaf_gaps(got["change"], want["change"],
                                                      want["grad_norm"]))}


@contextlib.contextmanager
def settled_heap():
    """The window with the objects of set-up frozen out of the collector's
    sight, as a long-running job freezes its heap after start-up
    (``gc.freeze``): a full collection of them stalls the host for 0.11-0.14
    s, which would land on one step in some windows and not others."""
    gc.collect()
    gc.freeze()
    try:
        yield
    finally:
        gc.unfreeze()


def run(conf: dict, mix: dict, limits: dict, seed: int, seconds: float, profiler, device) -> dict:
    """One run: set-up (with the checked steps), the window, then the check."""
    job = Job(conf, mix, device)
    job.load(seed)
    got = job.checked(seed)
    if job.device.type == "cuda":
        torch.cuda.synchronize()
    setup_done = time.perf_counter()
    with settled_heap():
        records = job.window(seed, seconds, profiler)
    peak = torch.cuda.max_memory_allocated() if job.device.type == "cuda" else 0
    job.free()
    del job
    gc.collect()
    readings = compare(got, reference(conf, mix, seed, device))
    window_s = records[-1].done - records[0].start
    return {
        "setup_done": setup_done,
        "attempted": len(records),
        "failed": 0,
        "e2e": {"train_tok_s": sum(r.tokens for r in records) / window_s},
        "records": records,
        "window_s": window_s,
        "memory_peak_bytes": peak,
        "checks": {k: (v, limits["limits"][k]) for k, v in readings.items()},
    }

