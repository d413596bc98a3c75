"""Multi-pod dry-run on PyTorch (port of ``repro.launch.dryrun``).

Per (arch x shape x mesh) cell this driver:
  1. joins a ``fake`` process group of 512 ranks as rank 0 (no devices, no
     traffic: collectives return at once) and builds the production mesh
     (16x16 single-pod / 2x16x16 multi-pod) over it, typed ``cuda`` as the
     cards' meshes are, so that DTensor issues the collectives it issues
     there (an all-to-all where a CPU mesh would all-gather and chunk);
  2. builds the cell's step with every argument a meta-device DTensor placed
     by the sharding rules (``runtime/sharding.py``): parameters, AdamW's
     moments and step, the batch and the decode cache — the counterpart of
     the reference's ``ShapeDtypeStruct`` inputs with ``NamedSharding``s
     (train_4k -> train_step with grad accumulation; prefill_32k -> prefill;
     decode_32k / long_500k -> one-token decode);
  3. runs it once on the meta device under :class:`Counters`, a dispatch
     mode that sees each rank's local ops (DTensor's ops are let through and
     come back as the ops on local shards, as ``CommDebugMode`` sees them):
       * matmul FLOPs per device, from the local shards' shapes
         (``torch.utils.flop_counter``'s formulas), plus the flash-attention
         and expert-FFN kernels by their own formulas (a kernel given meta
         tensors runs nothing and reports its products and bytes);
       * collective bytes and counts by op, under the ring model of
         ``launch/hlo.py``: the port's own program's collectives.  Of them,
         ``param_gather_bytes`` are those whose input is parameter storage
         (or a copy of it, or the output of such a gather): the weight
         gathers.  ``models/spmd.py``'s products gather a weight only where
         that moves fewer bytes than moving the activation to it (the train
         rules' FSDP gathers, prefill); at decode the serve rules' weights
         stay where they are put, and a decode cell's collectives are
         activations;
       * eager per-op bytes: each op's inputs read and outputs written, on
         local shards, views excluded.  XLA counts bytes at its fusion
         boundaries; an eager op's intermediates are all written and read
         again, so this figure is an upper bound of the reference's
         ``hbm_bytes_per_chip`` for the same program and is named
         ``eager_op_bytes_per_chip``;
       * per-device bytes: the arguments' local shards, plus the peak of the
         bytes the step allocates (tracked storage by storage, live from the
         op that makes it until it is freed);
  4. writes the record in the reference's JSON schema (``status``,
     ``memory.per_device_total_bytes``, ``cost_model``, ``roofline``) under
     ``experiments/dryrun_torch/``.

The train step is counted loop-aware, as the reference's ``hlo_analysis``
counts a scan body once and multiplies by its trip count: one step of one
microbatch (forward, backward and the AdamW update), plus ``nmb - 1`` times
one more microbatch's forward and backward.

CLI:
  python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k [--multi-pod]
  python -m repro_torch.launch.dryrun --all        # the work list
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
import weakref
from typing import Any, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack

from ..archs import PORT_ONLY
from ..configs import SHAPES, ArchConfig, ShapeConfig, cells, get_config, param_count
from ..kernels import _build
from ..models import Model
from ..models.params import tree_leaves
from ..models.transformer import cast_params_for_compute
from ..optim import AdamWConfig, adamw_init
from ..runtime.axes import ActivationSharding, set_activation_sharding
from ..runtime.serve import make_decode_step, make_prefill_step
from ..runtime.sharding import (
    batch_specs,
    cache_spec_tree,
    distribute_params,
    make_sharding_rules,
    named,
    param_specs,
)
from ..runtime.train import TrainState, make_train_step
from .hlo import HW, CollectiveStats, ring_traffic, roofline_terms
from .mesh import make_production_mesh
from .specs import decode_input_specs, prefill_input_specs, train_input_specs

__all__ = ["Counters", "build_decode", "build_prefill", "build_train", "init_fake_world",
           "local_bytes", "main", "measure", "run_cell", "work_list"]

DEFAULT_OUT = "experiments/dryrun_torch"
WORLD = 512


def init_fake_world(world: int = WORLD) -> None:
    """Join a ``fake`` process group of ``world`` ranks as rank 0, unless a
    group exists already."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def _dp_size(mesh) -> int:
    axes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    return axes.get("data", 1) * axes.get("pod", 1)


def _opt_config(cfg: ArchConfig) -> AdamWConfig:
    return AdamWConfig(lr=1e-4, state_dtype=None)  # moments in param dtype


def _install_profile(mesh, rules) -> None:
    """Activation-sharding hints (runtime/axes.py) for this mesh/mode."""
    set_activation_sharding(
        ActivationSharding(mesh=mesh, logical={"batch": tuple(rules.dp), "model": ("model",)})
    )


def _place(tree: dict, specs: dict, rules) -> dict:
    """The meta tensors of ``tree`` as DTensors placed by ``specs``."""
    from torch.distributed.tensor import distribute_tensor

    return {k: (_place(v, specs[k], rules) if isinstance(v, dict)
                else distribute_tensor(v, rules.mesh, named(rules, specs[k])))
            for k, v in tree.items()}


def _microbatches(shape: ShapeConfig, mesh) -> int:
    return max(1, shape.global_batch // _dp_size(mesh))


def build_train(cfg: ArchConfig, shape: ShapeConfig, mesh, num_microbatches=None):
    """``(step, args, meta)``: the train step on one microbatch, the placed
    arguments of the whole step (the state's parameters, moments and step
    count, and the global batch), and in ``meta`` ``loss_step``, one more
    microbatch's forward and backward, for the loop-aware count."""
    rules = make_sharding_rules(mesh, "train")
    _install_profile(mesh, rules)
    model = Model(cfg, "meta")
    nmb = num_microbatches or _microbatches(shape, mesh)
    opt_cfg = _opt_config(cfg)
    accum = torch.bfloat16 if cfg.param_dtype == "bfloat16" else torch.float32
    step_fn = make_train_step(model, opt_cfg, num_microbatches=1, accum_dtype=accum)

    masters = model.abstract_params()
    params = distribute_params(masters, param_specs(masters, rules), mesh).requires_grad_()
    state = TrainState(params=params, opt_state=adamw_init(opt_cfg, params),
                       step=torch.zeros((), dtype=torch.int32, device="meta"))
    batch_abs = train_input_specs(cfg, shape)
    batch = _place(batch_abs, batch_specs(batch_abs, rules), rules)
    mb_abs = train_input_specs(cfg, ShapeConfig(shape.name, shape.kind, shape.seq_len,
                                                shape.global_batch // nmb))
    mb = _place(mb_abs, batch_specs(mb_abs, rules), rules)

    def loss_step():
        loss, _ = model.loss_fn(params, mb)
        loss.backward()

    meta = {"num_microbatches": nmb, "mode": "train", "loss_step": loss_step}
    args = (state.params, state.opt_state, state.step, batch)
    return (lambda: step_fn(state, mb)), args, meta


def _serving_params(model, cfg, rules, mesh):
    """Serving holds weights in the compute dtype (bf16), as the reference's
    dry-run does: an f32 master copy is a training artifact."""
    params = cast_params_for_compute(model.abstract_params(), cfg)
    return distribute_params(params, param_specs(params, rules), mesh)


def build_prefill(cfg: ArchConfig, shape: ShapeConfig, mesh):
    rules = make_sharding_rules(mesh, "serve")
    _install_profile(mesh, rules)
    model = Model(cfg, "meta")
    step_fn = make_prefill_step(model, max_len=shape.seq_len)
    params = _serving_params(model, cfg, rules, mesh)
    batch_abs = prefill_input_specs(cfg, shape)
    batch = _place(batch_abs, batch_specs(batch_abs, rules), rules)
    return (lambda: step_fn(params, batch)), (params, batch), {"mode": "prefill"}


def build_decode(cfg: ArchConfig, shape: ShapeConfig, mesh):
    """One token at position ``seq_len - 1`` against a cache of ``seq_len``;
    tokens replicated and the cache placed by ``cache_spec_tree``, as the
    reference's in_shardings."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    rules = make_sharding_rules(mesh, "serve")
    _install_profile(mesh, rules)
    model = Model(cfg, "meta")
    step_fn = make_decode_step(model)
    params = _serving_params(model, cfg, rules, mesh)
    ins = decode_input_specs(cfg, shape)
    cache = _place(ins["cache"], cache_spec_tree(ins["cache"], rules), rules)
    replicated = [Replicate()] * mesh.ndim
    tokens = distribute_tensor(ins["tokens"], mesh, replicated)
    pos = distribute_tensor(ins["pos"], mesh, replicated)
    args = (params, cache, tokens, pos)
    return (lambda: step_fn(params, cache, tokens, shape.seq_len - 1)), args, {"mode": "decode"}


# ---------------------------------------------------------------------------
# Counting
# ---------------------------------------------------------------------------

_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "detach",
             "lift_fresh", "alias"}
_COPIES = {"clone", "_to_copy", "copy_", "constant_pad_nd", "cat", "stack", "index_select",
           "wait_tensor", "_wrap_tensor_autograd"}  # the last two: a collective's output, handed on
_COLLECTIVES = {"all_reduce": "all-reduce", "all_reduce_": "all-reduce",
                "all_gather_into_tensor": "all-gather", "reduce_scatter_tensor": "reduce-scatter",
                "all_to_all_single": "all-to-all", "shard_dim_alltoall": "all-to-all"}


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def local_bytes(tree) -> int:
    """Bytes of one rank's shards of every tensor in ``tree`` (nested dicts,
    lists, ``Params``; a plain tensor counts whole)."""
    from torch.distributed.tensor import DTensor

    leaves = tree_leaves(tree)
    return sum(_nbytes(x.to_local() if isinstance(x, DTensor) else x) for x in leaves
               if isinstance(x, torch.Tensor))


class Counters(TorchDispatchMode):
    """Counts what one rank runs: FLOPs, eager op bytes, collectives and the
    peak of the bytes allocated, on local tensors only.  ``known`` are the
    step's argument shards (not counted as allocated); ``params`` those of
    them that are parameters: a collective whose input is their storage, or
    a copy of it, counts in ``param_gather_bytes`` too.

    DTensor ops are handed back (``NotImplemented``) so that DTensor runs
    them and their local ops and collectives come back here; the ops DTensor
    runs on global shapes to propagate shapes (under a fake-tensor mode) are
    skipped."""

    def __init__(self, known=(), params=()):
        super().__init__()
        self.flops = 0.0
        self.op_bytes = 0.0
        self.collectives = CollectiveStats()
        self.param_gather_bytes = 0.0
        self.kernels: dict = {}
        self.live = 0
        self.peak = 0
        self._known = {t.untyped_storage()._cdata for t in known}
        self._params = {t.untyped_storage()._cdata for t in params}
        self._copies: set = set()  # storages copied from parameter storage
        self._storages: dict = {}

    def _kernel(self, name, flops, nbytes):
        self.flops += flops
        self.op_bytes += nbytes
        self.kernels[name] = self.kernels.get(name, 0) + 1

    def __enter__(self):
        _build.meta_listeners.append(self._kernel)
        return super().__enter__()

    def __exit__(self, *exc):
        _build.meta_listeners.remove(self._kernel)
        return super().__exit__(*exc)

    def _free(self, key):
        self.live -= self._storages.pop(key)

    def _track(self, out) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._known or key in self._storages:
                continue
            self._storages[key] = st.nbytes()
            self.live += st.nbytes()
            weakref.finalize(st, self._free, key)
        self.peak = max(self.peak, self.live)

    def _from_params(self, t) -> bool:
        key = t.untyped_storage()._cdata
        return key in self._params or key in self._copies

    def _mark_copy(self, func, args, kwargs, out) -> None:
        """Follow a copy of parameter storage (``.contiguous()``, a cast, a
        pad, a concatenation of such copies, a selection of its rows) to its
        source, so that a copy cannot hide a gather of it."""
        name = func._overloadpacket.__name__
        if name not in _COPIES:
            return
        srcs = ([args[1]] if name == "copy_" else [args[0]] if name == "index_select"
                else _tensors((args, kwargs)))
        if srcs and all(self._from_params(t) for t in srcs):
            self._mark(args[0] if name == "copy_" else out)

    def _mark(self, out) -> None:
        for t in _tensors(out):
            key = t.untyped_storage()._cdata
            if key not in self._copies:
                self._copies.add(key)
                weakref.finalize(t.untyped_storage(), self._copies.discard, key)

    def _collective(self, op, name, args, out):
        import torch.distributed.distributed_c10d as c10d

        group = c10d._resolve_process_group(args[-1])
        n = group.size()
        nbytes = _nbytes(out) if op in ("all-gather", "reduce-scatter") else _nbytes(args[0])
        traffic = ring_traffic(op, nbytes, n)
        self.collectives.add(op, traffic)
        if self._from_params(args[0]):  # a gather in steps: its output is followed too
            self.param_gather_bytes += traffic
            self._mark(out)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if any(isinstance(m, FakeTensorMode) for m in _get_current_dispatch_mode_stack()):
            return out  # DTensor's shape propagation, on global shapes
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        name = packet.__name__
        op = _COLLECTIVES.get(name)
        if op is not None:
            self._collective(op, name, args, out)
        elif not func.is_view and name not in _NO_BYTES:
            self.op_bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.op_bytes += sum(_nbytes(t) for t in _tensors(out))
            if self._params:
                self._mark_copy(func, args, kwargs, out)
        self._track(out)
        return out


def _local_tensors(tree) -> list:
    from torch.distributed.tensor import DTensor

    return [x.to_local() if isinstance(x, DTensor) else x for x in tree_leaves(tree)
            if isinstance(x, torch.Tensor)]


def _count(fn, args) -> tuple[Counters, Any]:
    """``fn()`` counted; ``args[0]`` is the step's parameter tree."""
    counters = Counters(known=_local_tensors(args), params=_local_tensors(args[0]))
    with counters:
        out = fn()
    return counters, out


def measure(cfg: ArchConfig, shape: ShapeConfig, mesh, num_microbatches=None) -> dict:
    """One step of ``shape``'s kind for ``cfg`` on ``mesh``, counted: the
    record's ``mode``, ``memory``, ``cost_model`` and ``roofline`` (per
    device; the roofline on :class:`~repro_torch.launch.hlo.HW`'s data-sheet
    constants).  Raises if the step fails."""
    rec: dict[str, Any] = {}
    t0 = time.perf_counter()
    try:
        if shape.kind == "train":
            step, args, meta = build_train(cfg, shape, mesh, num_microbatches)
        else:
            builder = build_prefill if shape.kind == "prefill" else build_decode
            step, args, meta = builder(cfg, shape, mesh)
        loss_step = meta.pop("loss_step", None)
        rec.update(meta)
        rec["build_s"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        with torch.no_grad() if shape.kind != "train" else torch.enable_grad():
            counters, _ = _count(step, args)
        flops, op_bytes, coll = counters.flops, counters.op_bytes, counters.collectives
        param_gather = counters.param_gather_bytes
        if loss_step is not None and rec["num_microbatches"] > 1:
            more, _ = _count(loss_step, args)
            k = rec["num_microbatches"] - 1
            flops += k * more.flops
            op_bytes += k * more.op_bytes
            for name, traffic in more.collectives.op_bytes.items():
                coll.op_bytes[name] = coll.op_bytes.get(name, 0.0) + k * traffic
                coll.op_counts[name] = (coll.op_counts.get(name, 0)
                                        + k * more.collectives.op_counts[name])
            coll.per_chip_bytes += k * more.collectives.per_chip_bytes
            param_gather += k * more.param_gather_bytes
        rec["run_s"] = time.perf_counter() - t1
    finally:
        set_activation_sharding(None)

    arg_bytes = local_bytes(args)
    rec["memory"] = {
        "argument_size_in_bytes": arg_bytes,
        "output_size_in_bytes": counters.live,
        "temp_size_in_bytes": counters.peak - counters.live,
        "alias_size_in_bytes": 0,
        "per_device_total_bytes": arg_bytes + counters.peak,
    }
    rec["cost_model"] = {
        "flops_per_chip": flops,
        "eager_op_bytes_per_chip": op_bytes,
        "collective_bytes_per_chip": coll.per_chip_bytes,
        "collective_op_bytes": coll.op_bytes,
        "collective_op_counts": coll.op_counts,
        "param_gather_bytes": param_gather,
        "kernel_calls": counters.kernels,
    }
    chips = mesh.size()
    terms = roofline_terms(flops, op_bytes, coll.per_chip_bytes, chips=1)
    pc = param_count(cfg)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    factor = 6 if shape.kind == "train" else 2
    model_flops = factor * pc["active"] * tokens
    total = flops * chips
    rec["roofline"] = {
        "compute_s": terms.compute_s,
        "memory_s": terms.memory_s,
        "collective_s": terms.collective_s,
        "dominant": terms.dominant,
        "step_time_s": terms.step_time_s,
        "model_flops": model_flops,
        "hlo_flops_total": total,
        "useful_flops_ratio": model_flops / total if total else 0.0,
        "roofline_fraction": terms.roofline_fraction(model_flops, chips, HW()),
        "hw": "H100 SXM data-sheet constants (launch/hlo.py HW), not measured",
    }
    return rec


def run_cell(
    arch: str,
    shape_name: str,
    multi_pod: bool = False,
    out_dir: Optional[str] = DEFAULT_OUT,
    verbose: bool = True,
) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    init_fake_world()
    mesh = make_production_mesh(multi_pod=multi_pod)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    rec: dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name, "chips": mesh.size(),
        "kind": shape.kind,
    }
    try:
        rec.update(measure(cfg, shape, mesh))
    except Exception as e:
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        if verbose:
            print(json.dumps({k: rec[k] for k in ("arch", "shape", "mesh", "status", "error")}))
        _write(rec, out_dir, arch, shape_name, mesh_name)
        return rec

    rec["status"] = "ok"
    if verbose:
        r = rec["roofline"]
        print(json.dumps({
            "arch": arch, "shape": shape_name, "mesh": mesh_name, "status": "ok",
            "mem_GB": rec["memory"]["per_device_total_bytes"] / 1e9,
            "compute_s": round(r["compute_s"], 6), "memory_s": round(r["memory_s"], 6),
            "collective_s": round(r["collective_s"], 6), "dominant": r["dominant"],
            "mfu": round(r["roofline_fraction"], 4),
            "build_s": round(rec["build_s"], 1), "run_s": round(rec["run_s"], 1),
        }))
    _write(rec, out_dir, arch, shape_name, mesh_name)
    return rec


def _write(rec, out_dir, arch, shape_name, mesh_name):
    if out_dir is None:
        return
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_name}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)


def work_list() -> list[str]:
    """The reference's ``--all`` lines: each runnable cell on both meshes,
    and a SKIP line for each skipped one (of the reference's archs: the
    port's own, ``archs.PORT_ONLY``, have no cells there)."""
    lines = []
    for arch, shape, status in cells(include_skips=True):
        if arch in PORT_ONLY:
            continue
        for mp in ("", "--multi-pod"):
            if status == "run":
                lines.append(f"--arch {arch} --shape {shape} {mp}".strip())
            else:
                lines.append(f"# SKIP {arch} {shape}: {status}")
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=sorted(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true", help="list runnable cells")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    if args.all:
        print("\n".join(work_list()))
        return 0

    if not args.arch or not args.shape:
        ap.error("--arch and --shape required (or --all)")
    rec = run_cell(args.arch, args.shape, args.multi_pod, args.out)
    return 0 if rec.get("status") == "ok" else 1


if __name__ == "__main__":
    sys.exit(main())
