"""The port's model on a real 2x2 ('data', 'model') mesh: four gloo processes on the CPU.

Every case runs in one group of four spawned ranks (started once for the
module): the sharded prefill, decode step and train step of reduced
qwen3-moe (8 experts, so E divides the 'model' axis and each rank runs its
expert slice; and 5 experts, so every rank runs every expert), reduced
granite-3-8b (dense), and the sharded prefill and decode of reduced
jamba-1.5-large-398b (hybrid) and mamba2-2.7b (ssm), each against the
unsharded port on the same weights in the same process, with the same
activation-sharding profile installed (so MoE splits its capacity into the
same two dispatch shards).  Serve runs under the serve rules (wide TP), the
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
TRAIN = [("qwen3-moe-30b-a3b", 0), ("qwen3-moe-30b-a3b", 5), ("granite-3-8b", 0)]
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


def expert_f_over_data(specs):
    """The serve specs with every routed expert leaf's F dim on 'data', as
    the rules place a leaf whose 'model' shard is over 1e9 bytes (the
    reduced configs' leaves are far under it): ``(E, D, F)`` gate and up,
    ``(E, F, D)`` down."""
    out = {}
    for name, spec in specs.items():
        if isinstance(spec, dict):
            out[name] = expert_f_over_data(spec) if name != "shared" else spec
        elif name in ("w_gate", "w_up", "w_down") and len(spec) >= 4:  # stacked (.., E, ., .)
            f = len(spec) - (2 if name == "w_down" else 1)
            out[name] = tuple("data" if i == f else a for i, a in enumerate(spec))
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
        with torch.no_grad():
            tok, cache = prefill(p, {"tokens": tokens.to(device)})
            toks, logits = [full(tok)], []
            for i in range(gen - 1):
                lg, cache = model.decode_step(p, cache, {"tokens": toks[-1][:, None]}, s + i)
                logits.append(full(lg))
                toks.append(torch.argmax(logits[-1], -1).to(toks[-1].dtype))
            local = [x.to_local() if is_dtensor(x) else x for x in tree_leaves(p)]
            with Counters(params=local) as counted:
                nxt, cache = decode(p, cache, toks[-1][:, None], s + gen - 1)
            toks.append(full(nxt).reshape(-1))
        launches = {k: v for k, v in launch_counts().items() if v}
        return (torch.stack(toks, 1), logits, {k: full(v) for k, v in cache.items()}, launches,
                counted)

    t0, l0, c0, n0, _ = run(params)
    specs = param_specs(params, make_sharding_rules(mesh, "serve"))
    if expert_f:
        specs = expert_f_over_data(specs)
    sharded = distribute_params(params, specs, mesh)
    t1, l1, c1, n1, counted = run(sharded)
    experts = [str(x.placements) for name, x in sharded.named_parameters()
               if name.endswith("moe.w_gate")][:1]
    return {"tokens_equal": bool(torch.equal(t0, t1)),
            "logits_err": max(float((a - c).abs().max()) for a, c in zip(l0, l1)),
            "cache_err": max(float((c0[k] - c1[k]).abs().max()) for k in c0),
            "cache_keys": sorted(c1), "launches_plain": n0, "launches": n1,
            "expert_placements": experts,
            "decode_collective_bytes": counted.collectives.per_chip_bytes,
            "decode_param_bytes": counted.param_gather_bytes}


def train_case(mesh, cfg, device, sizes):
    """One train step unsharded, then from the same seed under the train
    rules: the loss, grad-norm, gradient (relative to each leaf's largest
    magnitude) and updated-weight differences.  The unsharded state is
    copied to the host and freed before the sharded step."""
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
    params = distribute_params(fresh.params, param_specs(fresh.params,
                                                         make_sharding_rules(mesh, "train")), mesh)
    sharded, m1 = step(TrainState(params=params, opt_state=adamw_init(opt, params),
                                  step=fresh.step), batch)
    del fresh, params
    got = [(full(p.grad).detach().cpu(), full(p.detach()).cpu())
           for p in sharded.params.parameters()]
    grad = [float((g - w).abs().max() / w.abs().max().clamp(min=1e-30))
            for (g, _), (w, _) in zip(got, want)]
    names = [n for n, _ in sharded.params.named_parameters()]
    return {"loss": float(m0["loss"]), "loss_err": float((m0["loss"] - m1["loss"]).abs()),
            "grad_norm_err": float((m0["grad_norm"] - m1["grad_norm"]).abs()),
            "grad_rel_err": max(grad),
            "weight_err": max(float((g - w).abs().max()) for (_, g), (_, w) in zip(got, want)),
            "leaves": len(want),
            "worst_leaves": sorted(zip(names, grad), key=lambda kv: -kv[1])[:4]}


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
            elif kind == "train":
                res[key] = train_case(mesh, config(arch, reduced, changes), device, sizes)
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
    ``serve``, ``serve_expert_f`` (the experts' F dim over 'data'), ``train``
    or ``hint``) on a 2x2 mesh of four spawned ranks in
    a ``backend`` group (``nccl``: rank r on ``cuda:r``).  Returns
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


CASES = ([("hint", "hint", None, True, {}, None)]
         + [(f"serve/{arch}/{e}", "serve", arch, True, {"n_experts": e}, SERVE_SIZES)
            for arch, e in SERVE]
         + [(f"serve_expert_f/{arch}/{e}", "serve_expert_f", arch, True, {"n_experts": e},
             SERVE_SIZES) for arch, e in SERVE_EXPERT_F]
         + [(f"train/{arch}/{e}", "train", arch, True, {"n_experts": e}, TRAIN_SIZES)
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
