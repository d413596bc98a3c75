#!/usr/bin/env python3
"""The sharded path on a 2x2 ('data', 'model') mesh of four cards, against the unsharded path.

    python3 scripts/sharded_cards.py     # four processes, cuda:0..3, NCCL

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
its capacity into the same two dispatch shards.

It prints one JSON line per rank, then ``{"ok": ...}``, and exits 1 unless
on every rank the greedy tokens are equal, the decode logits, the train
loss and every gradient leaf (relative to its largest magnitude) agree
within 1e-4, and each kernel ran as many times in the sharded run as in the
unsharded one.  The group is killed after ``TIMEOUT_S``.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4
TIMEOUT_S = 900
FULL_WIDTH = {"n_layers": 2, "compute_dtype": "float32"}
CASES = [("serve", "serve", "qwen3-moe-30b-a3b", False, FULL_WIDTH, (4, 2048, 8)),
         ("train", "train", "qwen3-moe-30b-a3b", False, FULL_WIDTH, (4, 2048, 2))]


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
        serve, train = res["serve"], res["train"]
        ok = ok and serve["tokens_equal"] and serve["logits_err"] <= TOL
        ok = ok and serve["launches"] == serve["launches_plain"]
        ok = ok and train["loss_err"] <= TOL and train["grad_rel_err"] <= TOL
    print(json.dumps({"ok": ok, "hung": hung, "tol": TOL}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
