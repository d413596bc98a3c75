#!/usr/bin/env python3
"""Time the LM kernels of several checkouts of this repository on one card, in turns.

    python3 scripts/kernel_ab.py PARENT_ROOT CHANGE_ROOT [--rounds 2]

Each argument is the root of a checkout (for instance the parent commit,
unpacked with ``git archive`` into a directory that ``.gitignore`` lists, and
``.``).  Every run is a process of its own that imports that checkout's
``repro_torch``, builds its kernels from its own ``csrc/`` and times, with
CUDA events over back-to-back launches after a warm-up, at the
``lm_serving`` shapes of ``chip_smoke.py`` (qwen3-moe-30b-a3b's widths, bf16,
random inputs from fixed seeds, the same in every run):

  flash_rep      flash_attention, 4 x 32 x 2,048^2 x 128, causal, head-repeated K/V
  flash_gqa      the same with un-repeated K/V (4 kv heads), where the checkout takes it
  moe_prefill    moe_mlp, 128 experts x 640 x 2,048 -> 768 -> 2,048
  moe_decode     moe_mlp at capacity 8, every expert's slab filled
  moe_routed     moe_mlp at capacity 8, 4 tokens routed top-8 to random experts

The runs go in turns, A B ... then ... B A, ``--rounds`` times, so a
drift of the card's clocks hits every checkout alike.  Prints one JSON line
per run, then one with each case's runs by checkout and the card's name and
power limit.  Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

CASES = ("flash_rep", "flash_gqa", "moe_prefill", "moe_decode", "moe_routed")


def _time_ms(fn, iters):
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def worker(root: Path) -> dict:
    """One run: the kernels of the checkout at ``root``, timed."""
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch

    from repro_torch.kernels import _build, flash_attention, moe_mlp

    _build.build_all(["flash_attention", "moe_mlp"])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)

    def randn(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    b, h, hkv, s, dh = 4, 32, 4, 2048, 128
    e, cap, d, f = 128, 640, 2048, 768
    q, k, v = randn((b, h, s, dh)), randn((b, hkv, s, dh)), randn((b, hkv, s, dh))
    kr, vr = (t.repeat_interleave(h // hkv, 1).contiguous() for t in (k, v))
    wg, wu = randn((e, d, f), d ** -0.5), randn((e, d, f), d ** -0.5)
    wd = randn((e, f, d), f ** -0.5)
    x_prefill, x_decode = randn((e, cap, d)), randn((e, 8, d))
    x_routed = torch.zeros_like(x_decode)
    experts = np.random.default_rng(3).random((4, e)).argsort(axis=1)[:, :8]  # top-8 of 4 tokens
    tokens = randn((4, d))
    for t in range(4):
        x_routed[torch.from_numpy(experts[t]).to(dev), t] = tokens[t]
    runs = {
        "flash_rep": (lambda: flash_attention(q, kr, vr, causal=True), 20),
        "flash_gqa": (lambda: flash_attention(q, k, v, causal=True), 20),
        "moe_prefill": (lambda: moe_mlp(x_prefill, wg, wu, wd), 10),
        "moe_decode": (lambda: moe_mlp(x_decode, wg, wu, wd), 20),
        "moe_routed": (lambda: moe_mlp(x_routed, wg, wu, wd), 20),
    }
    out = {"root": str(root), "occupied_experts": int(np.unique(experts).size)}
    for name, (fn, iters) in runs.items():
        try:
            out[name] = _time_ms(fn, iters)
        except ValueError as err:  # an older checkout that does not take the input
            out[name] = None
            out[f"{name}_refused"] = str(err)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+", type=Path)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.roots[0].resolve())), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    roots = [r.resolve() for r in args.roots]
    order = [r for _ in range(args.rounds) for r in roots + roots[::-1]]
    by_root = {str(r): {c: [] for c in CASES} for r in roots}
    for root in order:
        proc = subprocess.run([sys.executable, __file__, "--worker", str(root)],
                              capture_output=True, text=True, check=True)
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps(run), flush=True)
        for c in CASES:
            by_root[run["root"]][c].append(run[c])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"ms": by_root, "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
