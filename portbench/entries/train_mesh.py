"""A training job on a mesh of cards: the program's train step under its train rules, one process a card.

The mix's ``"mesh"`` gives the ('data', 'model') mesh.  This process is rank
0, on the first card: it starts one process for each further card, joins
them in one process group (NCCL on cards, gloo on the CPU) and drives them
through a second, gloo group on the host (:class:`Group`).  Every rank
builds the same ``Job`` (:class:`MeshJob`): it draws each group of the
seed's weights on its own card, and the program places them itself
(``make_sharding_rules(mesh, "train")``, ``param_specs``,
``distribute_params``, and the activation profile that puts the batch on
'data' and the experts and heads on 'model'); nothing here shards.  Set-up
drives the state through the checked steps as ``entries/train.py`` does,
with each leaf gathered whole for its norms.  In the window rank 0's clock
decides whether another step starts, and tells the other ranks over the
host group before each one.  Each rank keeps its share of the host's cores
for its intra-op threads.  Once the window has closed, the ranks report
their memory peaks and their host clocks over the window (:func:`_host`),
free the program's state and end; then the plain
reference runs the checked steps again, each group's leaves on a card of
their own (:mod:`portbench.reference.spread`).
"""
from __future__ import annotations

import contextlib
import datetime
import functools
import math
import os
import resource
import socket
import sys
import time

import torch

from .. import counts, faults, generate, weights
from ..reference import spread
from ..reference.common import REF, Prec, strict
from ..spec import dims
from . import program
from .train import Job, compare, settled_heap

AXES = ("data", "model")
LOGICAL = {"batch": ("data",), "model": ("model",)}
TIMEOUT_S = 600  # the longest a collective may wait, and the ranks' end after a run


def devices(device, world: int) -> list:
    """The devices of the mesh's ranks: one card each, or the CPU."""
    if torch.device(device).type == "cuda":
        return [torch.device("cuda", r) for r in range(world)]
    return [torch.device("cpu")] * world


def threads(device, world: int) -> int:
    """Intra-op threads a rank keeps: its share of the host's cores."""
    if torch.device(device).type == "cuda":
        return max(1, (os.cpu_count() or 1) // world)
    return 1  # the CPU's ranks share the caller's cores


def _host() -> tuple:
    """This process's host clocks: wall seconds, its main thread's CPU
    seconds (what the wall has over them, the thread spent off a core:
    waiting on the card or a peer, or descheduled), and its involuntary and
    voluntary context switches."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return time.perf_counter(), time.thread_time(), ru.ru_nivcsw, ru.ru_nvcsw


def _join(rank: int, world: int, port: int, device: torch.device):
    """Join the process group; returns the host's gloo group."""
    import torch.distributed as dist

    if device.type == "cuda":
        torch.cuda.set_device(device)
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=world,
                            timeout=timeout)
    return dist.new_group(backend="gloo", timeout=timeout)


class MeshJob(Job):
    """One rank's part of the job: :class:`~portbench.entries.train.Job`
    with the masters placed by the program's train rules on the mix's mesh."""

    def __init__(self, conf: dict, mix: dict, device, ctl):
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.runtime.axes import ActivationSharding, set_activation_sharding

        super().__init__(conf, mix, device)
        self.ctl = ctl
        self.mesh = make_mesh(tuple(mix["mesh"]), AXES, self.device.type)
        set_activation_sharding(ActivationSharding(self.mesh, LOGICAL))
        self._fault = contextlib.ExitStack()
        self._announce = False
        self.host = None

    def plant(self, fault: str | None) -> None:
        """The step rebuilt with ``fault`` planted in the program (none: sound)."""
        from repro_torch.runtime import train

        self._fault.close()
        self._fault = contextlib.ExitStack()
        self._fault.enter_context(faults.planted(fault))
        self.step_fn = train.make_train_step(self.model, self.opt,
                                             num_microbatches=self.mix["microbatches"])

    def load(self, seed: int) -> None:
        from repro_torch.optim import adamw_init
        from repro_torch.runtime.sharding import distribute_params, make_sharding_rules, param_specs
        from repro_torch.runtime.train import TrainState

        specs = param_specs(self.model.abstract_params(), make_sharding_rules(self.mesh, "train"))

        def own(path, index, w):  # a leaf the rules replicate would keep its group's draw alive
            spec = functools.reduce(lambda t, k: t[k], path, specs)
            return w.clone() if all(s is None for s in spec) else w

        whole = program.params(self.model, self.conf, seed, self.device).map_stacked(own)
        masters = distribute_params(whole, specs, self.mesh).requires_grad_()
        del whole
        self.state = TrainState(params=masters, opt_state=adamw_init(self.opt, masters),
                                step=torch.zeros((), dtype=torch.int32, device=self.device))

    def checked(self, seed: int) -> dict:
        """``Job.checked``'s numbers, each leaf gathered whole on every rank."""
        from repro_torch.models.spmd import full

        out = {"loss": []}
        for i in range(self.mix["checked_steps"]):
            out["loss"].append(self.step(self.batch(seed, i)))
            if i == 0:
                m = program.leaves(self.state.opt_state["m"])
                out["grad_norm"] = {k: float(torch.linalg.vector_norm(full(t))) / (1 - self.opt.b1)
                                    for k, t in m.items()}
        masters = program.leaves(self.state.params)
        out["change"] = {}
        for g in weights.groups(self.conf):
            for p, t0 in weights.draw(self.conf, seed, g, self.device).items():
                out["change"][g, p] = float(torch.linalg.vector_norm(full(masters[g, p]) - t0))
        return out

    def _go(self, go: bool | None) -> bool:
        """Rank 0 tells the others whether another step starts (``go``);
        another rank passes None and learns it."""
        import torch.distributed as dist

        flag = torch.tensor([int(bool(go))])
        dist.broadcast(flag, 0, group=self.ctl)
        return bool(flag.item())

    def step(self, host_batch: dict) -> float:
        if self._announce:
            self._go(True)
        return super().step(host_batch)

    def window(self, seed: int, seconds: float, profiler=None) -> list:
        """Rank 0's window: each step it starts is announced first."""
        self._announce = True
        h0 = _host()
        try:
            records = super().window(seed, seconds, profiler)
        finally:
            self._announce = False
        self._go(False)
        self.host = [b - a for a, b in zip(h0, _host())]
        return records

    def follow(self, seed: int) -> None:
        """Another rank's window: the steps rank 0 announces, on the same batches."""
        i = self.mix["checked_steps"]
        h0 = _host()
        with settled_heap():
            while self._go(None):
                self.step(self.batch(seed, i))
                i += 1
        self.host = [b - a for a, b in zip(h0, _host())]

    def peaks(self) -> list:
        """Every rank's device memory peak, in rank order."""
        import torch.distributed as dist

        mine = torch.cuda.max_memory_allocated(self.device) if self.device.type == "cuda" else 0
        got = [None] * dist.get_world_size()
        dist.all_gather_object(got, mine, group=self.ctl)
        return got

    def hosts(self) -> list:
        """Every rank's host clocks over its window (:func:`_host`), in rank order."""
        import torch.distributed as dist

        got = [None] * dist.get_world_size()
        dist.all_gather_object(got, self.host, group=self.ctl)
        return got


def _rank(rank: int, world: int, port: int, device: str, conf: dict, mix: dict, fault) -> None:
    """A rank other than 0: what rank 0 asks, until it says stop."""
    import torch.distributed as dist

    dev = devices(device, world)[rank]
    torch.set_num_threads(threads(device, world))
    ctl = _join(rank, world, port, dev)
    try:
        job = MeshJob(conf, mix, dev, ctl)
        job.plant(fault)
        while True:
            box = [None]
            dist.broadcast_object_list(box, src=0, group=ctl)
            name, args = box[0]
            if name == "stop":
                break
            getattr(job, name)(*args)
    finally:
        dist.destroy_process_group()


class Group:
    """Rank 0's handle on the job: this process on the first device, one
    started process on each further one, each with a :class:`MeshJob`."""

    def __init__(self, conf: dict, mix: dict, device):
        import torch.multiprocessing as mp

        import repro_torch.launch.mesh  # noqa: F401  (without the program, fail before any rank starts)

        self.world = math.prod(mix["mesh"])
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        ctx = mp.get_context("spawn")
        self.procs = [ctx.Process(target=_rank,
                                  args=(r, self.world, port, str(device), conf, mix, faults.ACTIVE))
                      for r in range(1, self.world)]
        for p in self.procs:
            p.start()
        try:
            dev = devices(device, self.world)[0]
            if dev.type == "cuda":
                torch.set_num_threads(threads(device, self.world))
            self.ctl = _join(0, self.world, port, dev)
            self.job = MeshJob(conf, mix, dev, self.ctl)
        except BaseException:
            self._end(announce=False)
            raise

    def _ask(self, name: str, *args) -> None:
        import torch.distributed as dist

        dist.broadcast_object_list([(name, args)], src=0, group=self.ctl)

    def call(self, name: str, *args):
        """``MeshJob.<name>(*args)`` on every rank; rank 0's result."""
        self._ask(name, *args)
        return getattr(self.job, name)(*args)

    def window(self, seed: int, seconds: float, profiler=None) -> list:
        self._ask("follow", seed)
        return self.job.window(seed, seconds, profiler)

    def close(self, ok: bool = True) -> None:
        """Stop every rank (after a fault of rank 0's, end them) and wait for each."""
        self._end(announce=ok)

    def _end(self, announce: bool) -> None:
        import torch.distributed as dist
        from repro_torch.runtime.axes import set_activation_sharding

        try:
            if announce:
                self._ask("stop")
        finally:
            set_activation_sharding(None)
            if not announce:  # they may wait in a collective this rank left: end them first
                for p in self.procs:
                    p.kill()
            if dist.is_initialized():
                dist.destroy_process_group()
            deadline = time.monotonic() + TIMEOUT_S
            for p in self.procs:
                p.join(timeout=max(0.0, deadline - time.monotonic()))
            for p in self.procs:
                if p.is_alive():
                    p.kill()
                    p.join()


def reference(conf: dict, mix: dict, seed: int, devs: list, prec: Prec = REF) -> dict:
    """The checked steps by the plain reference spread over ``devs``, with
    the program's dispatch shards (one a rank of the mesh's data axis)."""
    strict()
    m = dims(conf)
    rows = mix["batch"] // mix["microbatches"]
    shards = counts.dispatch_shards(m, rows * mix["seq_len"], rows, mix["mesh"][0])
    batches = [{k: torch.from_numpy(v).to(devs[0])
                for k, v in generate.train_batch(mix, seed, m.vocab, i).items()}
               for i in range(mix["checked_steps"])]
    return spread.steps(conf, mix, seed, batches, prec, devs, shards)


def run(conf: dict, mix: dict, limits: dict, seed: int, seconds: float, profiler, device) -> dict:
    """One run: the ranks' set-up (with the checked steps), the window, then the check."""
    marks = [("start", time.perf_counter())]
    group = Group(conf, mix, device)
    ok = False
    try:
        marks.append(("ranks joined", time.perf_counter()))
        group.call("load", seed)
        marks.append(("masters placed", time.perf_counter()))
        got = group.call("checked", seed)
        if group.job.device.type == "cuda":
            torch.cuda.synchronize()
        setup_done = time.perf_counter()
        marks.append(("checked steps", setup_done))
        with settled_heap():
            records = group.window(seed, seconds, profiler)
        peaks = group.call("peaks")
        hosts = group.call("hosts")
        group.call("free")
        ok = True
    finally:
        group.close(ok)
    marks.append(("window and ranks ended", time.perf_counter()))
    readings = compare(got, reference(conf, mix, seed, devices(device, group.world)))
    marks.append(("reference", time.perf_counter()))
    print(f"memory_peak_bytes by card: {peaks}", file=sys.stderr)
    print("window's host by rank (wall s, main thread's CPU s, involuntary and voluntary switches): "
          + "; ".join(f"{w:.3f} {c:.3f} {n} {v}" for w, c, n, v in hosts), file=sys.stderr)
    print("seconds: " + ", ".join(f"{name} {b - a:.2f}" for (_, a), (name, b) in zip(marks, marks[1:])),
          file=sys.stderr, flush=True)
    window_s = records[-1].done - records[0].start
    return {
        "setup_done": setup_done,
        "attempted": len(records),
        "failed": 0,
        "e2e": {"train_tok_s": sum(r.tokens for r in records) / window_s},
        "records": records,
        "window_s": window_s,
        "memory_peak_bytes": max(peaks),
        "checks": {k: (v, limits["limits"][k]) for k, v in readings.items()},
    }
