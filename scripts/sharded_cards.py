#!/usr/bin/env python3
"""The sharded path on a 2x2 ('data', 'model') mesh of four cards, against the unsharded path.

    python3 scripts/sharded_cards.py                             # four processes, NCCL
    python3 scripts/sharded_cards.py --time-against DIR [prefill|decode]
                                        # and time DIR's tree against this one

It runs the harness of ``tests/test_torch_mesh.py`` (the same case
functions that the CPU test runs in four gloo processes at reduced widths)
over NCCL, rank r on ``cuda:r``, at published widths: qwen3-moe-30b-a3b cut
to 2 layers, in float32 compute with TF32 off (two bf16 runs that sum in
other orders differ by whole ulps), weights drawn from seed 0 on every rank.
It serves B = 4 prompts of 2,048 tokens and 8 greedy tokens unsharded, then
with the weights placed by the serve rules (``distribute_params``): q heads
and experts split over 'model' (16 heads and 64 experts a card, so each card
launches the flash and expert-FFN kernels on its own heads and experts), the
batch and the MoE dispatch shards over 'data', the cache's sequence over
'model' (decode's softmax combines the two halves).  Then one train step
(4 x 2,048 tokens, 2 microbatches, AdamW at lr 1e-5) unsharded and under the
train rules.  Both runs install the same activation profile, so MoE splits
its capacity into the same two dispatch shards.  A third case serves the
same model cut to 4 layers: its stacked expert leaf is 4 x 128 x 2,048 x 768
x 4 B = 3.22 GB, 1.61 GB a 'model' shard, over the rules' 1e9-byte
threshold, so the rules split the experts' F dim over 'data' (the case
records the placement) and decode runs the stationary experts: each card
runs the expert-FFN kernel on its (64, D, 384) slices and the tokens move.
``train_expert_f`` takes a train step of the 2-layer cut with the experts'
F dim over 'data' (``expert_f_over_data``): 2,048 tokens a card a
microbatch are fewer bytes than the expert slices, so the slices stay (0
expert parameter bytes) and their gradients come through the slab sum;
``train_expert_f_4`` does the same at the 4-layer cut, where the rules
split F themselves, and ``train_expert_whole`` trains that cut with F whole
(its slices gathered).  Then mamba2-2.7b cut to 4 layers at published
widths, served and trained as qwen3-moe is (its Mamba mixer moves
``in_proj``'s output to z, xBC and dt by one all-to-all over 'model'), and
``compressed_psum`` over the four cards (``PSUM_N`` float32 elements a
card) against its numpy formula, timed beside a plain all-reduce.

It prints one JSON line per rank, then ``{"ok": ...}``, and exits 1 unless
on every rank the greedy tokens are equal, the decode logits, the 2-layer
and mamba2 train steps' loss and every gradient leaf (relative to its
largest magnitude) agree within 1e-4, each kernel ran as many times in the
sharded run as in the unsharded one, the F-split cases' experts are
F-split, no decode step moved parameter bytes, no F-split train step moved
expert bytes and ``compressed_psum`` equals its formula.  The 4-layer train
steps' gradients are printed, not compared: there both sharded steps, F
split or whole, part from the unsharded one's expert gradients by 6.47e-2
of a leaf's largest entry (most likely a token routed otherwise as the
two float32 programs drift apart), where the 2-layer steps agree within
1e-5.  The
group is killed after ``TIMEOUT_S``.

``--time-against DIR`` then times, on the tree unpacked in DIR (the parent
commit, say: ``git archive HEAD^ | tar -x -C build/parent``) and on this
one, in turns (DIR, this, this, DIR), each run four fresh processes
importing that tree's ``repro_torch`` with sharded weights only: ``prefill``
(the default) the 4-layer mamba2 case's warm prefill of 4 x 2,048 tokens (2
warm-up, ``PREFILLS`` timed) and its collective bytes on each card counted
by that tree's ``Counters``; ``decode`` the 4-layer qwen3-moe case's warm
decode step (a prefill, 3 warm-up steps, ``DECODE_STEPS`` timed).  Times
are CUDA-synchronised wall times on each card, after a barrier.  It prints
one JSON line per run and the card's name and power limit; it compares
nothing.
"""
from __future__ import annotations

import json
import socket
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4
TIMEOUT_S = 1500
FULL_WIDTH = {"n_layers": 2, "compute_dtype": "float32"}
EXPERT_F = {"n_layers": 4, "compute_dtype": "float32"}
MAMBA2 = {"n_layers": 4, "compute_dtype": "float32"}
PSUM_N = 1 << 24  # compressed_psum's elements a rank (64 MiB of float32)
CASES = [("serve", "serve", "qwen3-moe-30b-a3b", False, FULL_WIDTH, (4, 2048, 8)),
         ("train", "train", "qwen3-moe-30b-a3b", False, FULL_WIDTH, (4, 2048, 2)),
         ("serve_expert_f", "serve", "qwen3-moe-30b-a3b", False, EXPERT_F, (4, 2048, 8)),
         ("train_expert_f", "train_expert_f", "qwen3-moe-30b-a3b", False, FULL_WIDTH,
          (4, 2048, 2)),
         ("train_expert_f_4", "train_expert_f", "qwen3-moe-30b-a3b", False, EXPERT_F, (4, 2048, 2)),
         ("train_expert_whole", "train_expert_whole", "qwen3-moe-30b-a3b", False, EXPERT_F,
          (4, 2048, 2)),
         ("serve_mamba2", "serve", "mamba2-2.7b", False, MAMBA2, (4, 2048, 8)),
         ("train_mamba2", "train", "mamba2-2.7b", False, MAMBA2, (4, 2048, 2)),
         ("compressed_psum", "compressed_psum", None, False, {}, (PSUM_N,))]
DECODE_STEPS = 20  # timed, after 3 warm-up steps; at most 29
PREFILLS = 5  # timed, after 2 warm-up prefills


def _time_worker(rank, port, src, what, out):
    """One rank of the timed run: ``src``'s ``repro_torch`` and sharded
    weights; ``what`` is ``decode`` (the 4-layer qwen3-moe case: prefill,
    then warm decode steps) or ``prefill`` (the 4-layer mamba2 case: warm
    prefills, and one more counted by that tree's dry-run ``Counters``)."""
    sys.path.insert(0, src)
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(rank)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=4)
    res = {"rank": rank}
    try:
        import dataclasses

        import repro_torch
        from repro_torch.configs import get_config
        from repro_torch.launch.dryrun import Counters
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models import Model
        from repro_torch.models.params import tree_leaves
        from repro_torch.runtime.axes import ActivationSharding, set_activation_sharding
        from repro_torch.runtime.serve import make_decode_step, make_prefill_step
        from repro_torch.runtime.sharding import (distribute_params, make_sharding_rules,
                                                  param_specs)

        res["repro_torch"] = str(Path(repro_torch.__file__).resolve().parents[1])
        mesh = make_mesh((2, 2), ("data", "model"), "cuda")
        set_activation_sharding(ActivationSharding(mesh, {"batch": ("data",),
                                                          "model": ("model",)}))
        arch, changes = (("mamba2-2.7b", MAMBA2) if what == "prefill"
                         else ("qwen3-moe-30b-a3b", EXPERT_F))
        cfg = dataclasses.replace(get_config(arch), **changes)
        model = Model(cfg, f"cuda:{rank}")
        params = model.init(0)
        params = distribute_params(params, param_specs(params, make_sharding_rules(mesh, "serve")),
                                   mesh)
        torch.cuda.empty_cache()
        b, s = 4, 2048
        tokens = torch.from_numpy(np.random.default_rng(1).integers(2, cfg.vocab_size, (b, s)))
        tokens = {"tokens": tokens.cuda()}
        prefill = make_prefill_step(model, s + 32)  # the cache's sequence splits over 'model'
        decode = make_decode_step(model)

        def timed(fn):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            return out

        times = []
        with torch.no_grad():
            if what == "prefill":
                for _ in range(2 + PREFILLS):
                    timed(lambda: prefill(params, tokens))
                local = [x.to_local() for x in tree_leaves(params)]
                with Counters(params=local) as counted:
                    prefill(params, tokens)
                res.update({"prefill_collective_bytes": counted.collectives.per_chip_bytes,
                            "prefill_param_bytes": counted.param_gather_bytes})
                warm = times[2:]
            else:
                tok, cache = prefill(params, tokens)
                tok = tok[:, None]
                for i in range(3 + DECODE_STEPS):
                    tok, cache = timed(lambda: decode(params, cache, tok, s + i))
                warm = times[3:]
        res.update({f"{what}_ms_min": min(warm), f"{what}_ms_median": sorted(warm)[len(warm) // 2],
                    f"{what}_ms": warm, "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
    except Exception:
        import traceback

        res["error"] = traceback.format_exc()
    finally:
        dist.destroy_process_group()
    out[rank] = res


def _timed_run(src: str, what: str) -> dict:
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    with ctx.Manager() as manager:
        out = manager.dict()
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        procs = [ctx.Process(target=_time_worker, args=(r, port, src, what, out))
                 for r in range(4)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + TIMEOUT_S
        for p in procs:
            p.join(timeout=max(0.0, deadline - time.monotonic()))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        return {r: dict(out[r]) for r in range(4) if r in out}


def time_against(parent: Path, what: str) -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"nvidia_smi": smi.strip().splitlines()}))
    trees = {"parent": str(parent.resolve() / "src"), "change": str(ROOT / "src")}
    for name in ("parent", "change", "change", "parent"):
        ranks = _timed_run(trees[name], what)
        print(json.dumps({"timed": name, "what": what, "ranks": [
            {k: v for k, v in ranks[r].items() if k != f"{what}_ms"} for r in sorted(ranks)],
            f"rank0_{what}_ms": ranks.get(0, {}).get(f"{what}_ms")}))


def main() -> int:
    import torch

    if torch.cuda.device_count() < 4:
        print(f"sharded_cards: needs 4 cards, found {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]  # the spawned ranks inherit it
    import test_torch_mesh as harness

    results, hung = harness.run_ranks(CASES, "nccl", TIMEOUT_S)
    for r in sorted(results):
        print(json.dumps(results[r]))
    ok = not hung and len(results) == 4
    for res in results.values():
        if "error" in res:
            ok = False
            continue
        for key in ("serve", "serve_expert_f", "serve_mamba2"):
            serve = res[key]
            ok = ok and serve["tokens_equal"] and serve["logits_err"] <= TOL
            ok = ok and serve["launches"] == serve["launches_plain"]
            ok = ok and serve["decode_param_bytes"] == 0
        for key in ("serve_expert_f", "train_expert_f", "train_expert_f_4"):
            ok = ok and "Shard(dim=2)" in res[key]["expert_placements"][0]
        for key in ("train_expert_f", "train_expert_f_4"):
            ok = ok and res[key]["expert_param_bytes"] == 0
        for key in ("train", "train_expert_f", "train_mamba2"):
            train = res[key]
            ok = ok and train["loss_err"] <= TOL and train["grad_rel_err"] <= TOL
        ok = ok and res["compressed_psum"]["equal"]
    print(json.dumps({"ok": ok, "hung": hung, "tol": TOL}))
    if ok and sys.argv[1:2] == ["--time-against"]:
        time_against(Path(sys.argv[2]), sys.argv[3] if len(sys.argv) > 3 else "prefill")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
