"""The port's model on a real 2x2 ('data', 'model') mesh: four gloo processes on the CPU.

Every case runs in one group of four spawned ranks (started once for the
module): the sharded prefill, decode step and train step of reduced
qwen3-moe (8 experts, so E divides the 'model' axis and each rank runs its
expert slice; and 5 experts, so every rank runs every expert), reduced
granite-3-8b (dense) and mamba2-2.7b (ssm), the sharded prefill and decode
of reduced jamba-1.5-large-398b (hybrid), one Mamba layer's forward and
backward at both families' widths, a train step whose experts' F dim is on
'data', the differentiable slab sum and ``compressed_psum`` over the four
ranks (against its numpy formula), the sharded checkpoint of each train
case (:func:`remesh_case`: restored on the same placements, on (4, 1), (1,
4) and plain, byte for byte the unsharded save, a ``FaultTolerantLoop``
restart, a failed rank's save) and its regions against DTensor's chunking
on uneven leaves, each against the unsharded port
on the same weights in the same process, with the same
activation-sharding profile installed (so MoE splits its capacity into the
same two dispatch shards).  Jamba's whole train step is not among them: one
Mamba layer's ``A_log`` gradient, a small sum of cancelling terms, differs
from the unsharded step's by 1.9e-5 of its largest entry, on the tree
before the Mamba parts path too; its layer's forward and backward alone
agree within 1e-6.  Serve runs under the serve rules (wide TP), the
train step under the train rules (FSDP + TP), 2 microbatches, AdamW at
lr 1e-5 (a larger step turns last-ulp gradient differences of near-zero
entries into whole steps of the learning rate).  Tolerance 1e-5: float32
sums taken in another order across ranks differ by a few 1e-6.  The parent
kills the group after ``TIMEOUT_S``, so that a hung collective fails these
tests instead of stalling the suite.

The harness (:func:`run_ranks` and the case functions) is also the one
``scripts/sharded_cards.py`` runs over NCCL on four cards, at published
widths.
"""
import dataclasses
import math
import os
import socket
import time
import traceback

import numpy as np
import pytest

torch = pytest.importorskip("torch")

TIMEOUT_S = 300
TOL = 1e-5
SERVE = [("qwen3-moe-30b-a3b", 0), ("qwen3-moe-30b-a3b", 5), ("granite-3-8b", 0),
         ("jamba-1.5-large-398b", 0), ("mamba2-2.7b", 0)]
SERVE_EXPERT_F = [("qwen3-moe-30b-a3b", 0), ("qwen3-moe-30b-a3b", 5)]
TRAIN = [("qwen3-moe-30b-a3b", 0), ("qwen3-moe-30b-a3b", 5), ("granite-3-8b", 0),
         ("mamba2-2.7b", 0)]
TRAIN_EXPERT_F = [("qwen3-moe-30b-a3b", 0)]
# One Mamba layer forward and backward under the train rules (the mixer's
# parts path, spmd.split_parts): ssm and hybrid widths.
MIXER = [("mamba2-2.7b", 0), ("jamba-1.5-large-398b", 0)]
SERVE_SIZES = (4, 16, 2)  # batch, prompt, greedy tokens
TRAIN_SIZES = (4, 16, 2)  # batch, sequence, microbatches


def config(arch, reduced=True, changes=()):
    """``arch``'s config with ``changes`` (``n_experts`` goes into its MoE)."""
    from repro_torch.configs import get_config

    changes = dict(changes)
    cfg = get_config(arch, reduced=reduced)
    if changes.get("n_experts"):
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               n_experts=changes["n_experts"]))
    changes.pop("n_experts", None)
    return dataclasses.replace(cfg, **changes)


def expert_f_over_data(specs, axis="data"):
    """The specs with every routed expert leaf's F dim on ``axis`` ('data',
    as the rules place a leaf whose 'model' shard is over 1e9 bytes, which
    the reduced configs' leaves are far under; None: whole): ``(E, D, F)``
    gate and up, ``(E, F, D)`` down."""
    out = {}
    for name, spec in specs.items():
        if isinstance(spec, dict):
            out[name] = expert_f_over_data(spec, axis) if name != "shared" else spec
        elif name in ("w_gate", "w_up", "w_down") and len(spec) >= 4:  # stacked (.., E, ., .)
            f = len(spec) - (2 if name == "w_down" else 1)
            out[name] = tuple(axis if i == f else a for i, a in enumerate(spec))
        else:
            out[name] = spec
    return out


def serve_case(mesh, cfg, device, sizes, expert_f=False):
    """Prefill B prompts of S tokens, then greedy decode steps (the last
    through ``make_decode_step``), unsharded and with the weights placed by
    the serve rules (``expert_f``: with the experts' F dim over 'data', see
    :func:`expert_f_over_data`): whether the tokens agree, the largest logit
    and cache differences, each run's kernel launches, the placements of
    the first expert leaf, and the collective bytes of the last decode step
    (counted by the dry-run's ``Counters`` on this rank) with the part whose
    input is parameter storage."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.dryrun import Counters
    from repro_torch.models import Model
    from repro_torch.models.params import tree_leaves
    from repro_torch.models.spmd import full, is_dtensor
    from repro_torch.runtime.serve import make_decode_step, make_prefill_step
    from repro_torch.runtime.sharding import distribute_params, make_sharding_rules, param_specs

    b, s, gen = sizes
    model = Model(cfg, device)
    params = model.init(0)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(2, cfg.vocab_size, (b, s)))
    prefill, decode = make_prefill_step(model, s + gen), make_decode_step(model)

    def run(p):
        reset_launch_counts()
        local = [x.to_local() if is_dtensor(x) else x for x in tree_leaves(p)]
        with torch.no_grad():
            with _gather_counters(params=local) as at_prefill:
                tok, cache = prefill(p, {"tokens": tokens.to(device)})
            toks, logits = [full(tok)], []
            for i in range(gen - 1):
                lg, cache = model.decode_step(p, cache, {"tokens": toks[-1][:, None]}, s + i)
                logits.append(full(lg))
                toks.append(torch.argmax(logits[-1], -1).to(toks[-1].dtype))
            with Counters(params=local) as counted:
                nxt, cache = decode(p, cache, toks[-1][:, None], s + gen - 1)
            toks.append(full(nxt).reshape(-1))
        launches = {k: v for k, v in launch_counts().items() if v}
        return (torch.stack(toks, 1), logits, {k: full(v) for k, v in cache.items()}, launches,
                counted, at_prefill)

    t0, l0, c0, n0, _, _ = run(params)
    specs = param_specs(params, make_sharding_rules(mesh, "serve"))
    if expert_f:
        specs = expert_f_over_data(specs)
    sharded = distribute_params(params, specs, mesh)
    t1, l1, c1, n1, counted, at_prefill = run(sharded)
    experts = [str(x.placements) for name, x in sharded.named_parameters()
               if name.endswith("moe.w_gate")][:1]
    return {"tokens_equal": bool(torch.equal(t0, t1)),
            "logits_err": max(float((a - c).abs().max()) for a, c in zip(l0, l1)),
            "cache_err": max(float((c0[k] - c1[k]).abs().max()) for k in c0),
            "cache_keys": sorted(c1), "launches_plain": n0, "launches": n1,
            "expert_placements": experts,
            "decode_collective_bytes": counted.collectives.per_chip_bytes,
            "decode_param_bytes": counted.param_gather_bytes,
            "prefill_collective_bytes": at_prefill.collectives.per_chip_bytes,
            "prefill_largest_gather": max(at_prefill.gathered, default=0)}


def _gather_counters(params):
    """The dry-run's ``Counters`` that also lists the elements of each
    all-gather's output whose input is no parameter (an activation)."""
    from repro_torch.launch.dryrun import Counters

    class Gathers(Counters):
        gathered: list

        def _collective(self, op, name, args, out):
            if op == "all-gather" and not self._from_params(args[0]):
                self.gathered.append(out.numel())
            super()._collective(op, name, args, out)

    counters = Gathers(params=params)
    counters.gathered = []
    return counters


def train_case(mesh, cfg, device, sizes, expert_f=None):
    """One train step unsharded, then from the same seed under the train
    rules (``expert_f`` 'data' or 'whole': with the experts' F dim over
    'data' or whole, see :func:`expert_f_over_data`): the loss, grad-norm, gradient (relative to
    each leaf's largest magnitude) and updated-weight differences, the
    placements of the first expert leaf, and the collective bytes of the
    sharded step whose input is an expert leaf (counted by the dry-run's
    ``Counters`` on this rank).  The unsharded state is copied to the host
    and freed before the sharded step."""
    from repro_torch.launch.dryrun import Counters
    from repro_torch.models import Model
    from repro_torch.models.spmd import full
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.runtime.sharding import distribute_params, make_sharding_rules, param_specs
    from repro_torch.runtime.train import TrainState, init_train_state, make_train_step

    b, s, nmb = sizes
    model = Model(cfg, device)
    opt = AdamWConfig(lr=1e-5)
    rng = np.random.default_rng(2)
    batch = {k: torch.from_numpy(rng.integers(2, cfg.vocab_size, (b, s))).to(device)
             for k in ("tokens", "labels")}
    step = make_train_step(model, opt, num_microbatches=nmb)
    plain, m0 = step(init_train_state(model, opt, 0), batch)
    want = [(p.grad.detach().cpu(), p.detach().cpu()) for p in plain.params.parameters()]
    del plain
    fresh = init_train_state(model, opt, 0)  # the sharded state may alias its masters
    specs = param_specs(fresh.params, make_sharding_rules(mesh, "train"))
    if expert_f is not None:
        specs = expert_f_over_data(specs, None if expert_f == "whole" else expert_f)
    params = distribute_params(fresh.params, specs, mesh)
    experts = [(name, x) for name, x in params.named_parameters()
               if name.split(".")[-1] in ("w_gate", "w_up", "w_down") and x.dim() == 3]
    with Counters(params=[x.to_local() for _, x in experts]) as counted:
        sharded, m1 = step(TrainState(params=params, opt_state=adamw_init(opt, params),
                                      step=fresh.step), batch)
    placed = [str(x.placements) for name, x in experts if name.endswith("w_gate")][:1]
    del fresh, params, experts
    got = [(full(p.grad).detach().cpu(), full(p.detach()).cpu())
           for p in sharded.params.parameters()]
    grad = [float((g - w).abs().max() / w.abs().max().clamp(min=1e-30))
            for (g, _), (w, _) in zip(got, want)]
    names = [n for n, _ in sharded.params.named_parameters()]
    # an expert leaf apart by more than TOL: how many of its experts are
    apart = {n: int(((g - w).abs().amax(dim=(1, 2)) > TOL * w.abs().max()).sum())
             for n, (g, _), (w, _), e in zip(names, got, want, grad) if e > TOL and w.dim() == 3}
    return {"loss": float(m0["loss"]), "loss_err": float((m0["loss"] - m1["loss"]).abs()),
            "grad_norm_err": float((m0["grad_norm"] - m1["grad_norm"]).abs()),
            "grad_rel_err": max(grad),
            "weight_err": max(float((g - w).abs().max()) for (_, g), (_, w) in zip(got, want)),
            "leaves": len(want),
            "worst_leaves": sorted(zip(names, grad), key=lambda kv: -kv[1])[:4],
            "expert_placements": placed, "expert_param_bytes": counted.param_gather_bytes,
            "experts_apart": apart}


def mixer_case(mesh, cfg, device, sizes):
    """The first Mamba layer of ``cfg`` (``mamba_block``: norm, mixer,
    residual) over a seeded batch of B x S, forward and backward against a
    seeded output gradient, unsharded and with the weights placed by the
    train rules: the output's, the input gradient's and each of the layer's
    weight gradients' largest difference, relative to its largest
    magnitude."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.models import Model
    from repro_torch.models.params import Params
    from repro_torch.models.spmd import full, placements
    from repro_torch.models.transformer import mamba_block
    from repro_torch.runtime.sharding import distribute_params, make_sharding_rules, param_specs

    b, s = sizes[:2]
    rng = np.random.default_rng(3)
    h0, r0 = (torch.from_numpy(rng.standard_normal((b, s, cfg.d_model), dtype=np.float32))
              .to(device) for _ in range(2))

    def run(params, h, r):
        layer = next(m for _, m in params.named_modules()
                     if isinstance(m, Params) and "mamba" in m and "in_proj" in m["mamba"])
        out = mamba_block(layer, cfg, h)
        torch.autograd.backward(out, r)
        return full(out), full(h.grad), {n: full(w.grad) for n, w in layer.named_parameters()}

    model = Model(cfg, device)
    want = run(model.init(0).requires_grad_(), h0.clone().requires_grad_(), r0)
    params = model.init(0)
    params = distribute_params(params, param_specs(params, make_sharding_rules(mesh, "train")),
                               mesh).requires_grad_()
    pl = placements(h0.shape, ("batch", None, None))
    got = run(params, distribute_tensor(h0, mesh, pl).requires_grad_(),
              distribute_tensor(r0, mesh, pl))
    rel = lambda g, w: float((g - w).abs().max() / w.abs().max().clamp(min=1e-30))
    return {"out_err": rel(got[0], want[0]), "input_grad_err": rel(got[1], want[1]),
            "grad_errs": {n: rel(got[2][n], want[2][n]) for n in want[2]}}


def slab_sum_case(mesh):
    """``spmd.slab_sum`` inside ``shard_map``, the stationary experts'
    pattern: ``(x @ w1) @ w2`` with ``x`` whole and the contracted F dim of
    ``w1`` and ``w2`` split over 'model', each rank's partial product summed
    over 'model' and its own block of rows kept (the output's rows over
    'model').  The result and the gradients of all three against the plain
    product's."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models.spmd import full, shard_map, slab_sum

    rng = np.random.default_rng(4)
    x0, w10, w20, r = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
                       for shape in ((6, 8), (8, 12), (12, 5), (6, 5)))
    plain = [t.clone().requires_grad_() for t in (x0, w10, w20)]
    want = (plain[0] @ plain[1]) @ plain[2]
    want.backward(r)
    m = mesh.mesh_dim_names.index("model")
    whole = [Replicate(), Replicate()]
    split = lambda d: [Shard(d) if i == m else Replicate() for i in range(2)]

    def body(x, w1, w2):
        rows = x.shape[0] // mesh.size(m)
        return slab_sum((x @ w1) @ w2, [m]).narrow(0, mesh.get_local_rank(m) * rows, rows)

    dts = [distribute_tensor(t, mesh, pl).requires_grad_()
           for t, pl in ((x0, whole), (w10, split(1)), (w20, split(0)))]
    got = shard_map(body, tuple(dts), (whole, split(1), split(0)), split(0))
    got.backward(distribute_tensor(r, mesh, split(0)))
    err = lambda a, b: float((full(a) - b).abs().max())
    return {"out_err": err(got, want),
            "grad_errs": [err(d.grad, p.grad) for d, p in zip(dts, plain)]}


def compressed_psum_case(device, n: int):
    """``optim.compress.compressed_psum`` over the whole group: each rank's
    seeded ``(n,)`` float32 vector (rank r's scaled by r + 1), against the
    numpy formula of the reference's ``pmax`` + ``psum`` (one scale from
    the largest amax, int8 payloads summed as int32, rescaled), and the
    time of a warm call beside a plain float32 all-reduce's (host clock,
    synchronised)."""
    import torch.distributed as dist

    from repro_torch.optim.compress import compressed_psum

    rank, world = dist.get_rank(), dist.get_world_size()
    rng = np.random.default_rng(5)
    xs = [rng.standard_normal(n).astype(np.float32) * np.float32(r + 1) for r in range(world)]
    x = torch.from_numpy(xs[rank]).to(device)
    got = compressed_psum(x).cpu().numpy()
    scale = np.float32(max(np.abs(v).max() for v in xs)) / np.float32(127.0)
    want = sum(np.clip(np.round(v / scale), -127, 127).astype(np.int32) for v in xs)
    want = want.astype(np.float32) * scale

    def ms(fn, reps=5):
        fn()
        times = []
        for _ in range(reps):
            dist.barrier()
            if x.is_cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            if x.is_cuda:
                torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return min(times)

    return {"equal": bool(np.array_equal(got, want)), "max_err": float(np.abs(got - want).max()),
            "n": n, "ms": ms(lambda: compressed_psum(x)),
            "all_reduce_ms": ms(lambda: dist.all_reduce(x.clone()))}


def hint_case(mesh):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.runtime.axes import hint

    x = distribute_tensor(torch.arange(4 * 6 * 8, dtype=torch.float32).reshape(4, 6, 8), mesh,
                          [Replicate(), Replicate()])
    y = hint(x, "batch", None, "model")
    odd = hint(distribute_tensor(torch.zeros(3, 8), mesh, [Replicate(), Replicate()]),
               "batch", "model")
    return {"placements": [str(p) for p in y.placements], "local": list(y.to_local().shape),
            "values_kept": bool(torch.equal(y.full_tensor(), x.full_tensor())),
            "guarded": [str(p) for p in odd.placements],
            "plain_untouched": hint(torch.ones(4, 8), "batch", "model").shape == (4, 8),
            "expected": [str(Shard(0)), str(Shard(2))],
            "expected_guarded": [str(Replicate()), str(Shard(1))]}


def _profile(mesh):
    from repro_torch.runtime.axes import ActivationSharding, set_activation_sharding

    set_activation_sharding(ActivationSharding(mesh, {"batch": ("data",), "model": ("model",)}))


def _shared_dir():
    """A new directory made by rank 0 (``TMPDIR``), its path on every rank."""
    import tempfile

    import torch.distributed as dist

    box = [tempfile.mkdtemp(prefix="ckpt_") if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _drop_dir(root):
    import shutil

    import torch.distributed as dist

    dist.barrier()
    if dist.get_rank() == 0:
        shutil.rmtree(root, ignore_errors=True)


def _train_setup(cfg, device, sizes):
    """The model, AdamW (lr 1e-5), the train step and ``batch(i)``, a seeded batch for step i."""
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.train import make_train_step

    b, s, nmb = sizes
    model = Model(cfg, device)
    opt = AdamWConfig(lr=1e-5)

    def batch(i):
        rng = np.random.default_rng(10 + i)
        return {k: torch.from_numpy(rng.integers(2, cfg.vocab_size, (b, s))).to(device)
                for k in ("tokens", "labels")}

    return model, opt, make_train_step(model, opt, num_microbatches=nmb), batch


def train_state(model, opt, mesh, like=False):
    """The train state from seed 0 placed by ``mesh``'s train rules (None:
    plain); ``like``: the same on the meta device, a restore's template."""
    from repro_torch.optim import adamw_init
    from repro_torch.runtime.sharding import distribute_params, make_sharding_rules, param_specs
    from repro_torch.runtime.train import TrainState

    params = (model.abstract_params() if like else model.init(0)).requires_grad_()
    if mesh is not None:
        params = distribute_params(params, param_specs(params, make_sharding_rules(mesh, "train")),
                                   mesh)
    return TrainState(params=params, opt_state=adamw_init(opt, params),
                      step=torch.zeros((), dtype=torch.int32,
                                       device="meta" if like else model.device))


def state_leaves(state):
    """Every leaf of a train state (weights, moments, count, step)."""
    from repro_torch.models.params import tree_leaves

    return tree_leaves([state.params, state.opt_state, state.step])


def _locals(state):
    """This rank's shard of every leaf of a train state, on the host."""
    from repro_torch.models.spmd import is_dtensor

    return [(x.to_local() if is_dtensor(x) else x).detach().cpu().clone()
            for x in state_leaves(state)]


def _layouts(state):
    from repro_torch.models.spmd import is_dtensor

    return [(str(x.device_mesh.mesh.tolist()), str(x.placements)) if is_dtensor(x) else None
            for x in state_leaves(state)]


def _plain(state):
    """The train state with every leaf gathered whole (a plain copy)."""
    from repro_torch.models.spmd import full
    from repro_torch.runtime.train import TrainState

    gather = lambda _, w: full(w).detach()
    o = state.opt_state
    return TrainState(params=state.params.map(gather),
                      opt_state={"m": o["m"].map(gather), "v": o["v"].map(gather),
                                 "count": o["count"]}, step=state.step)


def _same_files(a, b):
    names = sorted(os.listdir(a))
    if names != sorted(os.listdir(b)):
        return False
    for name in names:
        with open(os.path.join(a, name), "rb") as fa, open(os.path.join(b, name), "rb") as fb:
            if fa.read() != fb.read():
                return False
    return True


def _room(root, logical, world):
    """Raise unless the disk under ``root`` can take ``logical`` bytes and the
    host's available memory the ranks' snapshots (``logical`` in all)."""
    import shutil

    free = shutil.disk_usage(root).free
    with open("/proc/meminfo") as f:
        avail = next(int(line.split()[1]) * 1024 for line in f if line.startswith("MemAvailable"))
    if free < 1.05 * logical or avail < 1.25 * logical:
        raise RuntimeError(f"{logical} checkpoint bytes: {free} bytes free on disk under {root}, "
                           f"{avail} bytes of host memory available ({world} ranks)")
    return {"disk_free_bytes": free, "host_available_bytes": avail}


def _peak_rss() -> int:
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def remesh_case(mesh, cfg, device, sizes, meshes, steps=1, cpu_checks=True):
    """A sharded train state checkpointed and restored elsewhere.

    ``steps`` steps under the train rules on the 2x2 ``mesh``, then
    ``CheckpointManager.save`` (async, then ``wait()``), restored: (a) onto a
    meta template of the same placements: every local shard against the
    saved state's, and the next step against the unbroken run's; (b) onto
    plain tensors (the unsharded continuation), onto the (4, 1) mesh by
    ``param_shardings`` of its rules and onto a meta template on the (1, 4)
    mesh: one step each, its loss and every gradient leaf (relative to its
    largest magnitude) against the unsharded continuation's, the 2x2 one's
    too.  The unsharded continuation routes each token to the experts the
    sharded step routed it to, and counts the tokens whose own top-k
    differs (two float32 programs may break a near-tie in a token's router
    logits apart: at published widths a few tokens in 4,096 do, and their
    experts' gradients, and all below them, then part by ~0.1).
    ``cpu_checks`` adds (c) the directory against the unsharded
    ``save_pytree`` of the gathered values, byte for byte, (d)
    ``FaultTolerantLoop`` from the same seed over the same batches,
    checkpointing every step, with a failure injected before its last step:
    every local shard at its end against the unbroken run's, and (e) a save
    in which rank 1's writer raises, then one in which rank 0's commit (its
    manifest) does.  For a MoE model, a control: the plain restore with
    layers 0 and 1's routers swapped (a restore that put a layer's weights
    at another's index) routes with the 2x2 step's experts replayed, and
    counts the tokens whose own top-k differs, per routing call.  Also this
    rank's snapshot, local and
    logical bytes, the times, the bytes each restore read on this rank and
    the host's peak RSS."""
    import torch.distributed as dist

    from repro_torch.ckpt import CheckpointManager, checkpoint, save_pytree
    from repro_torch.models import moe
    from repro_torch.models.spmd import full, is_dtensor
    from repro_torch.runtime import FaultTolerantLoop
    from repro_torch.runtime.sharding import make_sharding_rules, param_shardings, param_specs
    from repro_torch.runtime.train import TrainState

    rank = dist.get_rank()
    model, opt, step, batch = _train_setup(cfg, device, sizes)
    state = train_state(model, opt, mesh)
    for i in range(steps):
        state, _ = step(state, batch(i))
    leaves = state_leaves(state)
    logical = sum(x.numel() * x.element_size() for x in leaves)
    local = sum((x.to_local() if is_dtensor(x) else x).nbytes for x in leaves)
    root = _shared_dir()
    out = {"logical_bytes": logical, "local_bytes": local, **_room(root, logical, 4)}
    mgr = CheckpointManager(root)
    t0 = time.perf_counter()
    mgr.save(steps, state)
    out["save_return_s"] = time.perf_counter() - t0
    mgr.wait()
    out.update(mgr.last_save)
    out["files"] = len(os.listdir(mgr.directory(steps)))
    if cpu_checks:
        save_pytree(_plain(state), os.path.join(root, "plain"))
        out["same_bytes"] = _same_files(mgr.directory(steps), os.path.join(root, "plain"))

        def failed_save(n, name, on_rank):  # (e): ``checkpoint.<name>`` raises on ``on_rank``
            real = getattr(checkpoint, name)

            def fail(*args):
                raise OSError("injected write failure")

            setattr(checkpoint, name, fail if rank == on_rank else real)
            t0 = time.perf_counter()
            try:
                mgr.save(n, state)
                try:
                    mgr.wait()
                    raised = None
                except Exception as e:
                    raised = type(e).__name__
            finally:
                setattr(checkpoint, name, real)
            wait_s = time.perf_counter() - t0
            dist.barrier()  # every rank's save has ended before any lists or saves again
            after = {"raised": raised, "wait_s": wait_s, "latest": mgr.latest(),
                     "names": sorted(os.listdir(root))}
            dist.barrier()
            return after

        out["failed_saves"] = {"rank1_write": failed_save(steps + 1, "_write_pieces", 1),
                               "rank0_commit": failed_save(steps + 2, "_write_manifest", 0)}

    restore_s, read = {}, {}

    def restore(name, like, **kw):
        t0 = time.perf_counter()
        got = mgr.restore(like, steps, device=device, **kw)[1]
        restore_s[name] = time.perf_counter() - t0
        read[name] = sum((x.to_local() if is_dtensor(x) else x).nbytes for x in state_leaves(got))
        return got

    def routed(s, replay=None):
        """One step from ``s`` on the next batch, and the experts each token
        went to in each MoE routing call, in call order.  ``replay``: such a
        list from another run; each call routes its tokens to those experts
        instead (weighted by this run's own router probabilities), and the
        tokens whose own top-k differs are counted, per call."""
        log, otherwise, route = [], [], moe.route

        def recording(x, router, top_k, norm_topk=True, **routing):
            probs, weights, ids = route(x, router, top_k, norm_topk, **routing)
            if replay is not None:
                theirs = replay[len(log)].to(ids.device)
                otherwise.append(int((torch.sort(ids, -1).values != torch.sort(theirs, -1).values)
                                     .any(-1).sum()))
                ids, weights = theirs, probs.gather(-1, theirs)
                if norm_topk:
                    weights = weights / weights.sum(dim=-1, keepdim=True).clamp(min=1e-9)
            log.append(full(ids).detach().cpu())
            return probs, weights, ids

        moe.route = recording
        try:
            s, m = step(s, batch(steps))
        finally:
            moe.route = route
        return s, m, (log if replay is None else otherwise)

    # (a) the same placements, bit for bit, and the next step
    same = restore("2x2", train_state(model, opt, mesh, like=True))
    out["same_layouts"] = _layouts(same) == _layouts(state)
    out["same_shards_equal"] = all(torch.equal(a, b) for a, b in zip(_locals(same), _locals(state)))
    state, m_unbroken = step(state, batch(steps))
    unbroken = _locals(state)
    del state, leaves
    same, m_same, ids_same = routed(same)
    out["next_step_equal"] = (bool(torch.equal(m_same["loss"], m_unbroken["loss"]))
                              and all(torch.equal(a, b) for a, b in zip(_locals(same), unbroken)))
    if cpu_checks:  # (d)
        fired, calls = [], []

        def batch_fn(i):
            calls.append(i)
            if i == steps and not fired:
                fired.append(i)
                raise RuntimeError(f"injected failure at step {i}")
            return batch(i)

        loop = FaultTolerantLoop(step_fn=step, batch_fn=batch_fn, ckpt_every=1,
                                 ckpt=CheckpointManager(os.path.join(root, "loop"), keep=2))
        looped, _ = loop.run(train_state(model, opt, mesh), 0, steps + 1)
        out["loop"] = {"equal": all(torch.equal(a, b) for a, b in zip(_locals(looped), unbroken)),
                       "calls": calls, "step": int(looped.step)}
        del looped
    del unbroken

    # (b) each layout's step against the unsharded continuation under the
    # same profile (MoE splits its capacity into as many dispatch shards as
    # the batch axes have ranks, unsharded too)
    names = [n for n, _ in model.abstract_params().named_parameters()]

    def grads(s):
        return [full(p.grad).detach().cpu() for p in s.params.parameters()]

    def against_plain(name, target, m, got, ids):
        _profile(target)
        plain, m0, otherwise = routed(restore(f"plain/{name}", train_state(model, opt, None,
                                                                         like=True)), ids)
        want = grads(plain)
        del plain
        errs = [float((g - w).abs().max() / w.abs().max().clamp(min=1e-30))
                for g, w in zip(got, want)]
        return {"loss_err": float((m["loss"] - m0["loss"]).abs()), "grad_rel_err": max(errs),
                "worst_leaves": sorted(zip(names, errs), key=lambda kv: -kv[1])[:3],
                "tokens_routed_otherwise": otherwise}

    got = grads(same)
    del same
    out["continuations"] = {"2x2": against_plain("2x2", mesh, m_same, got, ids_same)}
    for name in ("4x1", "1x4"):
        other = meshes[name]
        _profile(other)
        if name == "4x1":  # by shardings over the 2x2 template: the reference's NamedSharding tree
            ps = param_shardings(param_specs(model.abstract_params(),
                                             make_sharding_rules(other, "train")), other)
            moved = restore(name, train_state(model, opt, mesh, like=True), shardings=TrainState(
                params=ps, opt_state={"m": ps, "v": ps, "count": None}, step=None))
        else:  # by a meta template on that mesh
            moved = restore(name, train_state(model, opt, other, like=True))
        layouts = {str(lay) for lay in _layouts(moved) if lay is not None}
        moved, m, ids = routed(moved)
        got = grads(moved)
        del moved
        out["continuations"][name] = {
            **against_plain(name, other, m, got, ids), "layouts": len(layouts),
            "on_mesh": all(str(other.mesh.tolist()) in lay for lay in layouts)}
    _profile(mesh)
    if ids_same:
        wrong = restore("plain/swapped", train_state(model, opt, None, like=True))
        r0, r1 = (wrong.params.blocks[i].ffn.moe.router for i in (0, 1))
        with torch.no_grad():
            swap = r0.clone()
            r0.copy_(r1)
            r1.copy_(swap)
        out["swapped_routers_routed_otherwise"] = routed(wrong, ids_same)[2]
        del wrong, r0, r1
    out.update({"restore_s": restore_s, "read_bytes": read, "host_peak_rss": _peak_rss()})
    _drop_dir(root)
    return out


def boxes_case(mesh):
    """The checkpoint's shard regions against DTensor's own chunking on
    uneven leaves (5 rows over 2 and over 4 ranks, 7 columns over 2):
    ``distribute_tensor`` of an arange, each rank's local shard against the
    arange's region; a tree of such leaves saved by the group byte for byte
    as one process saves the whole tensors, and restored onto other uneven
    placements, each local shard equal to ``distribute_tensor``'s."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.ckpt import restore_pytree, save_pytree
    from repro_torch.ckpt.checkpoint import _shard_box

    layouts = [[Shard(0), Shard(0)], [Shard(0), Shard(1)], [Shard(1), Replicate()],
               [Replicate(), Shard(0)], [Shard(1), Shard(0)], [Shard(0), Replicate()]]
    whole = torch.arange(5 * 7 * 3, dtype=torch.float32).reshape(5, 7, 3)
    boxes = []
    for pls in layouts:
        off, size, _ = _shard_box(whole.shape, mesh, pls)
        region = whole[tuple(slice(o, o + z) for o, z in zip(off, size))]
        boxes.append(bool(torch.equal(distribute_tensor(whole, mesh, pls).to_local(), region)))
    tree = {f"x{i}": distribute_tensor(whole + i, mesh, pls) for i, pls in enumerate(layouts)}
    tree["bf16"] = distribute_tensor(whole.bfloat16(), mesh, layouts[0])
    plain = {k: v.full_tensor() for k, v in tree.items()}
    root = _shared_dir()
    save_pytree(tree, os.path.join(root, "sharded"))
    save_pytree(plain, os.path.join(root, "plain"))
    moved = layouts[1:] + layouts[:1]
    shardings = {k: (mesh, moved[i % len(moved)]) for i, k in enumerate(sorted(tree))}
    got = restore_pytree(os.path.join(root, "sharded"), tree, shardings=shardings)
    restored = all(torch.equal(got[k].to_local(),
                               distribute_tensor(plain[k], mesh, shardings[k][1]).to_local())
                   and list(got[k].placements) == list(shardings[k][1]) for k in tree)
    out = {"boxes": boxes, "same_bytes": _same_files(os.path.join(root, "sharded"),
                                                     os.path.join(root, "plain")),
           "restored": restored, "rank": dist.get_rank()}
    _drop_dir(root)
    return out


def elastic_tree_case(mesh, directory):
    """The reference's elastic re-mesh test on the port: the tree saved
    under ``directory`` by one process, restored onto ``mesh`` through
    ``shardings`` (every leaf replicated): each leaf's placements, and its
    values as numpy."""
    from torch.distributed.tensor import Replicate

    from repro_torch.ckpt import restore_pytree
    from repro_torch.models.params import tree_map
    from repro_torch.models.spmd import is_dtensor

    like = {"a": torch.zeros(4, 8, device="meta"),
            "nested": {"b": torch.zeros(3, dtype=torch.bfloat16, device="meta"),
                       "c": torch.zeros(3, dtype=torch.int32, device="meta")}}
    pls = [Replicate()] * mesh.ndim
    got = restore_pytree(directory, like, shardings=tree_map(lambda _: (mesh, pls), like))
    leaves = {"a": got["a"], "b": got["nested"]["b"], "c": got["nested"]["c"]}
    return {k: {"dtensor": is_dtensor(v), "placements": [type(p).__name__ for p in v.placements],
                "dtype": str(v.dtype), "values": v.to_local().float().numpy()
                if v.dtype == torch.bfloat16 else v.to_local().numpy()}
            for k, v in leaves.items()}


def from_reference_case(mesh, cfg, device, args):
    """A reduced qwen3-moe ``TrainState`` that the reference's
    ``CheckpointManager`` wrote under ``args["root"]`` (step 1), restored by
    the group onto a meta template under the train rules (AdamW lr 1e-3, as
    the reference's), saved again by the group under ``args["out"]``, then
    one step on ``args["batch"]`` (2 microbatches) with the batch whole on
    every rank (so MoE dispatches in one shard, as the reference's one
    device does): its loss and the restored placements of the first expert
    leaf."""
    from repro_torch.ckpt import CheckpointManager, save_pytree
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.axes import ActivationSharding, set_activation_sharding
    from repro_torch.runtime.train import make_train_step

    model, opt = Model(cfg, device), AdamWConfig(lr=1e-3)
    step, state = CheckpointManager(args["root"]).restore(train_state(model, opt, mesh, like=True),
                                                          device=device)
    save_pytree(state, args["out"])
    batch = {k: torch.from_numpy(v).to(device) for k, v in args["batch"].items()}
    set_activation_sharding(ActivationSharding(mesh, {"batch": (), "model": ("model",)}))
    _, m = make_train_step(model, opt, num_microbatches=2)(state, batch)
    _profile(mesh)
    return {"step": step, "loss": float(m["loss"]),
            "placements": str(state.params.blocks[0].ffn.moe.w_gate.placements)}


def _worker(rank, port, backend, cases, out, shape=(2, 2)):
    import torch.distributed as dist

    if backend == "nccl":  # rank r on card r
        torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        device = f"cuda:{rank}"
    else:
        torch.set_num_threads(1)  # the ranks share the caller's cores
        device = "cpu"
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=math.prod(shape))
    res = {"rank": rank}
    try:
        from repro_torch.launch.mesh import make_mesh

        mesh = make_mesh(shape, ("data", "model"), torch.device(device).type)
        others = {}

        def meshes():  # built on first use, by every rank in the same order
            for name, dims in (("4x1", (4, 1)), ("1x4", (1, 4))):
                others.setdefault(name, make_mesh(dims, ("data", "model"), mesh.device_type))
            return others

        _profile(mesh)
        for key, kind, arch, reduced, changes, sizes in cases:
            cfg = config(arch, reduced, changes) if arch is not None else None
            if kind == "hint":
                res[key] = hint_case(mesh)
            elif kind == "compressed_psum":
                res[key] = compressed_psum_case(device, *sizes)
            elif kind == "slab_sum":
                res[key] = slab_sum_case(mesh)
            elif kind == "boxes":
                res[key] = boxes_case(mesh)
            elif kind == "elastic_tree":
                res[key] = elastic_tree_case(mesh, sizes)
            elif kind == "from_reference":
                res[key] = from_reference_case(mesh, cfg, device, sizes)
            elif kind == "mixer":
                res[key] = mixer_case(mesh, cfg, device, sizes)
            elif kind in ("remesh", "train_remesh"):
                res[key] = remesh_case(mesh, cfg, device, sizes, meshes(),
                                       steps=1 if kind == "remesh" else 2,
                                       cpu_checks=kind == "remesh")
            elif kind in ("train", "train_expert_f", "train_expert_whole"):
                res[key] = train_case(mesh, cfg, device, sizes,
                                      expert_f={"train_expert_f": "data",
                                                "train_expert_whole": "whole"}.get(kind))
            else:
                res[key] = serve_case(mesh, cfg, device, sizes,
                                      expert_f=kind == "serve_expert_f")
        if backend == "nccl":
            res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    except Exception:
        res["error"] = traceback.format_exc()
    finally:
        dist.destroy_process_group()
    out[rank] = res


def run_ranks(cases, backend="gloo", timeout=TIMEOUT_S, shape=(2, 2)):
    """``cases`` (``(key, kind, arch, reduced, changes, sizes)``, kind
    ``serve``, ``serve_expert_f`` (the experts' F dim over 'data'), ``train``,
    ``train_expert_f``, ``train_expert_whole`` (the experts' F dim whole),
    ``mixer``, ``slab_sum``, ``compressed_psum`` (sizes: ``(n,)``), ``hint``,
    the checkpoint's ``remesh`` (one step, then (a) to (e) of
    :func:`remesh_case`), ``train_remesh`` (two steps, (a) and (b)),
    ``boxes``, ``elastic_tree`` (sizes: the directory) or
    ``from_reference`` (sizes: :func:`from_reference_case`'s ``args``)) on a
    mesh of ``shape`` (two dims, ('data', 'model')) over as many spawned
    ranks in a ``backend`` group (``nccl``: rank r on ``cuda:r``).  Returns
    ``({rank: results}, hung ranks)``; ranks still running after
    ``timeout`` seconds are killed."""
    import torch.multiprocessing as mp

    world = math.prod(shape)
    ctx = mp.get_context("spawn")
    with ctx.Manager() as manager:
        out = manager.dict()
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        procs = [ctx.Process(target=_worker, args=(r, port, backend, cases, out, shape))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(timeout=max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        return {r: dict(out[r]) for r in range(world) if r in out}, hung


CASES = ([("hint", "hint", None, True, {}, None), ("slab_sum", "slab_sum", None, True, {}, None),
          ("compressed_psum", "compressed_psum", None, True, {}, (257,))]
         + [(f"serve/{arch}/{e}", "serve", arch, True, {"n_experts": e}, SERVE_SIZES)
            for arch, e in SERVE]
         + [(f"serve_expert_f/{arch}/{e}", "serve_expert_f", arch, True, {"n_experts": e},
             SERVE_SIZES) for arch, e in SERVE_EXPERT_F]
         + [(f"train/{arch}/{e}", "train", arch, True, {"n_experts": e}, TRAIN_SIZES)
            for arch, e in TRAIN]
         + [(f"train_expert_f/{arch}/{e}", "train_expert_f", arch, True, {"n_experts": e},
             TRAIN_SIZES) for arch, e in TRAIN_EXPERT_F]
         + [(f"mixer/{arch}/{e}", "mixer", arch, True, {"n_experts": e}, TRAIN_SIZES)
            for arch, e in MIXER]
         + [("boxes", "boxes", None, True, {}, None)]
         + [(f"remesh/{arch}/{e}", "remesh", arch, True, {"n_experts": e}, TRAIN_SIZES)
            for arch, e in TRAIN])


@pytest.fixture(scope="module")
def ranks():
    """Every rank's results; the group is killed after TIMEOUT_S."""
    results, hung = run_ranks(CASES)
    assert not hung, f"ranks {hung} still running after {TIMEOUT_S} s: killed"
    assert len(results) == 4, f"ranks that returned: {sorted(results)}"
    for r, res in results.items():
        assert "error" not in res, f"rank {r}: {res['error']}"
    return results


def test_hint_places_on_the_mesh(ranks):
    for res in ranks.values():
        h = res["hint"]
        assert h["placements"] == h["expected"]  # batch over 'data', last dim over 'model'
        assert h["local"] == [2, 6, 4] and h["values_kept"]
        assert h["guarded"] == h["expected_guarded"]  # 3 rows do not split in 2; 8 columns do
        assert h["plain_untouched"]


@pytest.mark.parametrize("arch,n_experts", SERVE)
def test_sharded_prefill_and_decode_match_unsharded(ranks, arch, n_experts):
    for res in ranks.values():
        r = res[f"serve/{arch}/{n_experts}"]
        assert r["tokens_equal"], r
        assert r["cache_err"] <= TOL and r["logits_err"] <= TOL, r
        assert r["launches"] == r["launches_plain"], r
        # the decode step leaves every weight where the serve rules put it
        assert r["decode_param_bytes"] == 0 and r["decode_collective_bytes"] > 0, r


@pytest.mark.parametrize("arch,n_experts", SERVE_EXPERT_F)
def test_stationary_experts_match_unsharded(ranks, arch, n_experts):
    """The experts' F dim over 'data' (the rules' placement of a large
    expert leaf): the decode step moves the tokens, not the expert slices,
    and agrees with the unsharded port."""
    for res in ranks.values():
        r = res[f"serve_expert_f/{arch}/{n_experts}"]
        assert "Shard(dim=2)" in r["expert_placements"][0], r  # (E, D, F): F split
        assert r["tokens_equal"], r
        assert r["cache_err"] <= TOL and r["logits_err"] <= TOL, r
        assert r["launches"] == r["launches_plain"], r
        assert r["decode_param_bytes"] == 0 and r["decode_collective_bytes"] > 0, r


@pytest.mark.parametrize("arch,n_experts", TRAIN)
def test_sharded_train_step_matches_unsharded(ranks, arch, n_experts):
    for res in ranks.values():
        r = res[f"train/{arch}/{n_experts}"]
        assert r["loss_err"] <= TOL and r["grad_norm_err"] <= TOL, r
        assert r["grad_rel_err"] <= TOL and r["weight_err"] <= TOL, r


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "jamba-1.5-large-398b"])
def test_sharded_mamba_prefill_gathers_no_whole_projection(ranks, arch):
    """The sharded prefill's Mamba layers move ``in_proj``'s output once, by
    an all-to-all: no activation all-gather is as large as this rank's rows
    of the whole ``(B, S, d_in_proj)`` output (the parent gathered it six
    times a layer, once for each slice)."""
    cfg = config(arch)
    d_inner = cfg.ssm.expand * cfg.d_model
    h = d_inner // cfg.ssm.head_dim
    d_in_proj = 2 * d_inner + 2 * cfg.ssm.n_groups * cfg.ssm.d_state + h
    b, s, _ = SERVE_SIZES
    rows = b // 2 * s  # the batch over 'data'
    for res in ranks.values():
        r = res[f"serve/{arch}/0"]
        assert 0 < r["prefill_largest_gather"] < rows * d_in_proj, r
        assert r["prefill_collective_bytes"] > 0, r


@pytest.mark.parametrize("arch,n_experts", MIXER)
def test_sharded_mamba_layer_forward_and_backward_match_unsharded(ranks, arch, n_experts):
    for res in ranks.values():
        r = res[f"mixer/{arch}/{n_experts}"]
        assert r["out_err"] <= TOL and r["input_grad_err"] <= TOL, r
        assert max(r["grad_errs"].values()) <= TOL, r
        assert len(r["grad_errs"]) == 9, r  # the norm and the mixer's eight weights


@pytest.mark.parametrize("arch,n_experts", TRAIN_EXPERT_F)
def test_stationary_experts_train_step_matches_unsharded(ranks, arch, n_experts):
    """The experts' F dim over 'data' in a train step over few tokens a rank:
    the byte rule keeps the expert slices in place (0 expert parameter
    bytes), the slab sum's gradient reaches them, and the step agrees with
    the unsharded one."""
    for res in ranks.values():
        r = res[f"train_expert_f/{arch}/{n_experts}"]
        assert "Shard(dim=2)" in r["expert_placements"][0], r
        assert r["expert_param_bytes"] == 0, r
        assert r["loss_err"] <= TOL and r["grad_norm_err"] <= TOL, r
        assert r["grad_rel_err"] <= TOL and r["weight_err"] <= TOL, r


def test_slab_sum_gradient_matches_the_plain_sum(ranks):
    for res in ranks.values():
        r = res["slab_sum"]
        assert r["out_err"] <= TOL and max(r["grad_errs"]) <= TOL, r


def test_compressed_psum_over_the_group_matches_numpy(ranks):
    for res in ranks.values():
        r = res["compressed_psum"]
        assert r["equal"] and r["n"] == 257, r


def test_checkpoint_regions_follow_dtensor_chunking(ranks):
    """The checkpoint's shard regions are DTensor's own chunks on uneven
    leaves; a group's save of such leaves is one process's save byte for
    byte, and restores onto other uneven placements."""
    for res in ranks.values():
        r = res["boxes"]
        assert all(r["boxes"]) and r["same_bytes"] and r["restored"], r


@pytest.mark.parametrize("arch,n_experts", TRAIN)
def test_sharded_checkpoint_restores_bit_exact_on_the_same_placements(ranks, arch, n_experts):
    """(a): every local shard and the next step bit for bit."""
    for res in ranks.values():
        r = res[f"remesh/{arch}/{n_experts}"]
        assert r["same_layouts"] and r["same_shards_equal"], r
        assert r["next_step_equal"], r


@pytest.mark.parametrize("arch,n_experts", TRAIN)
def test_sharded_checkpoint_restores_onto_other_meshes(ranks, arch, n_experts):
    """(b): on (4, 1) by ``shardings``, on (1, 4) by a meta template, and the
    2x2 restore: one step each within TOL of the unsharded continuation."""
    for res in ranks.values():
        r = res[f"remesh/{arch}/{n_experts}"]
        assert sorted(r["continuations"]) == ["1x4", "2x2", "4x1"], r
        for name, c in r["continuations"].items():
            assert c["loss_err"] <= TOL and c["grad_rel_err"] <= TOL, (name, c)
            assert c.get("on_mesh", True), (name, c)
            assert not any(c["tokens_routed_otherwise"]), (name, c)


@pytest.mark.parametrize("arch,n_experts", TRAIN)
def test_sharded_checkpoint_is_the_unsharded_save(ranks, arch, n_experts):
    """(c): the group's directory is the unsharded ``save_pytree`` of the
    same values, byte for byte; each rank copied only its regions, every
    byte of the state once over the group."""
    rs = [res[f"remesh/{arch}/{n_experts}"] for res in ranks.values()]
    for r in rs:
        assert r["same_bytes"], r
        assert r["snapshot_bytes"] <= r["local_bytes"] < r["logical_bytes"], r
    assert sum(r["snapshot_bytes"] for r in rs) == rs[0]["logical_bytes"]


@pytest.mark.parametrize("arch,n_experts", TRAIN)
def test_sharded_fault_tolerant_loop_resumes_bit_exact(ranks, arch, n_experts):
    """(d): a failure before the second step restores the first step's
    checkpoint on every rank and ends on the unbroken run's shards."""
    for res in ranks.values():
        r = res[f"remesh/{arch}/{n_experts}"]["loop"]
        assert r["calls"] == [0, 1, 1] and r["step"] == 2, r
        assert r["equal"], r


@pytest.mark.parametrize("arch,n_experts", TRAIN)
def test_sharded_save_with_a_failed_rank_is_never_committed(ranks, arch, n_experts):
    """(e): rank 1's writer raises; ``wait()`` raises on every rank, the
    newest step stays the one before, and only the staged directory is left."""
    for res in ranks.values():
        after = res[f"remesh/{arch}/{n_experts}"]["failed_saves"]["rank1_write"]
        assert after["raised"] is not None, after
        assert after["latest"] == 1, after
        staged = [n for n in after["names"] if ".tmp." in n]
        assert [n for n in after["names"] if n.startswith("step_") and ".tmp." not in n] == \
            ["step_00000001"], after
        assert len(staged) == 1 and staged[0].startswith("step_00000002.tmp."), after


@pytest.mark.parametrize("arch,n_experts", TRAIN)
def test_sharded_save_whose_commit_fails_on_rank_0_is_never_committed(ranks, arch, n_experts):
    """(e): rank 0's manifest write raises after every rank's regions are
    on disk; ``wait()`` raises on every rank at once (the other ranks would
    otherwise poll for the commit until the 1,800 s ``TIMEOUT_S``), the
    newest step stays the one before, and only staged directories are left."""
    from repro_torch.ckpt import checkpoint

    for res in ranks.values():
        after = res[f"remesh/{arch}/{n_experts}"]["failed_saves"]["rank0_commit"]
        assert after["raised"] is not None and after["wait_s"] < 60 < checkpoint.TIMEOUT_S, after
        assert after["latest"] == 1, after
        assert [n for n in after["names"] if n.startswith("step_") and ".tmp." not in n] == \
            ["step_00000001"], after
        assert [n.split(".tmp.")[0] for n in after["names"] if ".tmp." in n] == \
            ["step_00000002", "step_00000003"], after


@pytest.mark.parametrize("arch,n_experts", [(a, e) for a, e in TRAIN if a == "qwen3-moe-30b-a3b"])
def test_a_restore_with_swapped_layers_routes_tokens_otherwise(ranks, arch, n_experts):
    """The control of (b)'s routing count: a plain restore with layers 0
    and 1's routers swapped sends most tokens of every routing call to
    other experts than the 2x2 step did, where a sound restore sends none."""
    for res in ranks.values():
        r = res[f"remesh/{arch}/{n_experts}"]
        counts = r["swapped_routers_routed_otherwise"]
        tokens = TRAIN_SIZES[0] * TRAIN_SIZES[1] // TRAIN_SIZES[2]  # a microbatch's
        assert len(counts) == len(r["continuations"]["2x2"]["tokens_routed_otherwise"]), r
        assert min(counts) > tokens // 2, counts
