#!/usr/bin/env python3
"""The sharded path on a 2x2 ('data', 'model') mesh of four cards, against the unsharded path.

    python3 scripts/sharded_cards.py                       # four processes, cuda:0..3, NCCL
    python3 scripts/sharded_cards.py --time-against DIR    # and time decode: DIR's tree and this one

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

It prints one JSON line per rank, then ``{"ok": ...}``, and exits 1 unless
on every rank the greedy tokens are equal, the decode logits, the train
loss and every gradient leaf (relative to its largest magnitude) agree
within 1e-4, each kernel ran as many times in the sharded run as in the
unsharded one, the 4-layer case's experts are F-split and no decode step
moved parameter bytes.  The group is killed after ``TIMEOUT_S``.

``--time-against DIR`` then times the 4-layer case's warm decode step on
the tree unpacked in DIR (the parent commit, say: ``git archive HEAD^ | tar
-x -C build/parent``) and on this one, in turns (DIR, this, this, DIR), each
run four fresh processes importing that tree's ``repro_torch``: sharded
weights only, a prefill of 4 x 2,048 tokens, 3 warm-up steps and
``DECODE_STEPS`` timed ones (CUDA-synchronised wall time on each card, after
a barrier).  It prints one JSON line per run and the card's name and power
limit; it compares nothing.
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
TIMEOUT_S = 900
FULL_WIDTH = {"n_layers": 2, "compute_dtype": "float32"}
EXPERT_F = {"n_layers": 4, "compute_dtype": "float32"}
CASES = [("serve", "serve", "qwen3-moe-30b-a3b", False, FULL_WIDTH, (4, 2048, 8)),
         ("train", "train", "qwen3-moe-30b-a3b", False, FULL_WIDTH, (4, 2048, 2)),
         ("serve_expert_f", "serve", "qwen3-moe-30b-a3b", False, EXPERT_F, (4, 2048, 8))]
DECODE_STEPS = 20  # timed, after 3 warm-up steps; at most 29


def _time_worker(rank, port, src, out):
    """One rank of the timed run: ``src``'s ``repro_torch``, the 4-layer
    case's sharded weights, prefill, then warm decode steps."""
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
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models import Model
        from repro_torch.runtime.axes import ActivationSharding, set_activation_sharding
        from repro_torch.runtime.serve import make_decode_step, make_prefill_step
        from repro_torch.runtime.sharding import (distribute_params, make_sharding_rules,
                                                  param_specs)

        res["repro_torch"] = str(Path(repro_torch.__file__).resolve().parents[1])
        mesh = make_mesh((2, 2), ("data", "model"), "cuda")
        set_activation_sharding(ActivationSharding(mesh, {"batch": ("data",),
                                                          "model": ("model",)}))
        cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b"), **EXPERT_F)
        model = Model(cfg, f"cuda:{rank}")
        params = model.init(0)
        params = distribute_params(params, param_specs(params, make_sharding_rules(mesh, "serve")),
                                   mesh)
        torch.cuda.empty_cache()
        b, s = 4, 2048
        tokens = torch.from_numpy(np.random.default_rng(1).integers(2, cfg.vocab_size, (b, s)))
        prefill = make_prefill_step(model, s + 32)  # the cache's sequence splits over 'model'
        decode = make_decode_step(model)
        times = []
        with torch.no_grad():
            tok, cache = prefill(params, {"tokens": tokens.cuda()})
            tok = tok[:, None]
            for i in range(3 + DECODE_STEPS):
                dist.barrier()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tok, cache = decode(params, cache, tok, s + i)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
        warm = sorted(times[3:])
        res.update({"decode_ms_min": warm[0], "decode_ms_median": warm[len(warm) // 2],
                    "decode_ms": times[3:], "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
    except Exception:
        import traceback

        res["error"] = traceback.format_exc()
    finally:
        dist.destroy_process_group()
    out[rank] = res


def _timed_run(src: str) -> dict:
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    with ctx.Manager() as manager:
        out = manager.dict()
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        procs = [ctx.Process(target=_time_worker, args=(r, port, src, out)) for r in range(4)]
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


def time_against(parent: Path) -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"nvidia_smi": smi.strip().splitlines()}))
    trees = {"parent": str(parent.resolve() / "src"), "change": str(ROOT / "src")}
    for name in ("parent", "change", "change", "parent"):
        ranks = _timed_run(trees[name])
        print(json.dumps({"timed": name, "ranks": [
            {k: v for k, v in ranks[r].items() if k != "decode_ms"} for r in sorted(ranks)],
            "rank0_decode_ms": ranks.get(0, {}).get("decode_ms")}))


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
        for key in ("serve", "serve_expert_f"):
            serve = res[key]
            ok = ok and serve["tokens_equal"] and serve["logits_err"] <= TOL
            ok = ok and serve["launches"] == serve["launches_plain"]
            ok = ok and serve["decode_param_bytes"] == 0
        ok = ok and "Shard(dim=2)" in res["serve_expert_f"]["expert_placements"][0]
        train = res["train"]
        ok = ok and train["loss_err"] <= TOL and train["grad_rel_err"] <= TOL
    print(json.dumps({"ok": ok, "hung": hung, "tol": TOL}))
    if ok and sys.argv[1:2] == ["--time-against"]:
        time_against(Path(sys.argv[2]))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
