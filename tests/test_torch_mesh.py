"""The port's model on a real 2x2 ('data', 'model') mesh: four gloo processes on the CPU.

Every case runs in one group of four spawned ranks (started once for the
module): the sharded prefill, decode step and train step of reduced
qwen3-moe (8 experts, so E divides the 'model' axis and each rank runs its
expert slice; and 5 experts, so every rank runs every expert), reduced
granite-3-8b (dense) and mamba2-2.7b (ssm), the sharded prefill and decode
of reduced jamba-1.5-large-398b (hybrid), one Mamba layer's forward and
backward at both families' widths, a train step whose experts' F dim is on
'data', the differentiable slab sum and ``compressed_psum`` over the four
ranks (against its numpy formula), each against the unsharded port
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


def _worker(rank, port, backend, cases, out):
    import torch.distributed as dist

    if backend == "nccl":  # rank r on card r
        torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        device = f"cuda:{rank}"
    else:
        torch.set_num_threads(1)  # four ranks share the caller's cores
        device = "cpu"
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=4)
    res = {"rank": rank}
    try:
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.runtime.axes import ActivationSharding, set_activation_sharding

        mesh = make_mesh((2, 2), ("data", "model"), torch.device(device).type)
        set_activation_sharding(ActivationSharding(mesh, {"batch": ("data",), "model": ("model",)}))
        for key, kind, arch, reduced, changes, sizes in cases:
            if kind == "hint":
                res[key] = hint_case(mesh)
            elif kind == "compressed_psum":
                res[key] = compressed_psum_case(device, *sizes)
            elif kind == "slab_sum":
                res[key] = slab_sum_case(mesh)
            elif kind == "mixer":
                res[key] = mixer_case(mesh, config(arch, reduced, changes), device, sizes)
            elif kind in ("train", "train_expert_f", "train_expert_whole"):
                res[key] = train_case(mesh, config(arch, reduced, changes), device, sizes,
                                      expert_f={"train_expert_f": "data",
                                                "train_expert_whole": "whole"}.get(kind))
            else:
                res[key] = serve_case(mesh, config(arch, reduced, changes), device, sizes,
                                      expert_f=kind == "serve_expert_f")
        if backend == "nccl":
            res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    except Exception:
        res["error"] = traceback.format_exc()
    finally:
        dist.destroy_process_group()
    out[rank] = res


def run_ranks(cases, backend="gloo", timeout=TIMEOUT_S):
    """``cases`` (``(key, kind, arch, reduced, changes, sizes)``, kind
    ``serve``, ``serve_expert_f`` (the experts' F dim over 'data'), ``train``,
    ``train_expert_f``, ``train_expert_whole`` (the experts' F dim whole),
    ``mixer``, ``slab_sum``, ``compressed_psum`` (sizes: ``(n,)``) or
    ``hint``) on a 2x2 mesh of four spawned ranks in a ``backend`` group
    (``nccl``: rank r on ``cuda:r``).  Returns
    ``({rank: results}, hung ranks)``; ranks still running after
    ``timeout`` seconds are killed."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    with ctx.Manager() as manager:
        out = manager.dict()
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        procs = [ctx.Process(target=_worker, args=(r, port, backend, cases, out))
                 for r in range(4)]
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
        return {r: dict(out[r]) for r in range(4) if r in out}, hung


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
            for arch, e in MIXER])


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
