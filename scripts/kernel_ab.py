#!/usr/bin/env python3
"""Time the kernels of several checkouts of this repository on one card, in turns.

    python3 scripts/kernel_ab.py PARENT_ROOT CHANGE_ROOT [--rounds 2] [--cases a,b]

Each argument is the root of a checkout (for instance the parent commit,
unpacked with ``git archive`` into a directory that ``.gitignore`` lists, and
``.``).  Every run is a process of its own that imports that checkout's
``repro_torch``, builds its kernels from its own ``csrc/`` and times, with
CUDA events over back-to-back launches after a warm-up, the LM kernels at
the ``lm_serving`` shapes of ``chip_smoke.py`` (qwen3-moe-30b-a3b's widths,
bf16, random inputs from fixed seeds, the same in every run):

  flash_rep      flash_attention, 4 x 32 x 2,048^2 x 128, causal, head-repeated K/V
  flash_gqa      the same with un-repeated K/V (4 kv heads), where the checkout takes it
  moe_prefill    moe_mlp, 128 experts x 640 x 2,048 -> 768 -> 2,048
  moe_decode     moe_mlp at capacity 8, every expert's slab filled
  moe_routed     moe_mlp at capacity 8, 4 tokens routed top-8 to random experts

and the streaming SpMV kernel, f32, on synthetic task tiles drawn from a
seed at the shapes and occupancy of ``chip_smoke.py``'s two streaming
entries (no partition: each row holds its share of the tasks on its share
of the occupied y slots, the first ones, as ``build_pack_plan`` packs them,
and gathers from its share of the x entries the plans' tiles touch, drawn
from a window of columns as wide as makes them fall on as many 32-byte
sectors as the plans' do):

  spmv_stream          spmv_streaming, k 1,024, e_max 4,224, y_max 1,920,
                       n 262,144, 4,165,041 tasks on 1,700,783 y slots,
                       1,688,685 x entries in windows of 7,500 columns
                       (the plan: 811 sectors a tile)
  spmv_stream_batched  spmv_streaming_batched, B 8, k 64, e_max = y_max =
                       5,376, n 16,384, 2,054,243 tasks on 331,914 y slots,
                       332,403 x entries in windows of 930 columns (the
                       plans: 116 sectors a tile)

These kernels are shorter than the wrapper's host cost per launch, so their
runs also give ``<case>_device_ms``, the kernel alone from torch.profiler,
and ``<case>_sha``, a hash of the output's bytes, which must be the same in
every checkout (the kernels keep the twin's bits; the script exits 1 if not).  The cases call only the
public wrappers, so an older checkout runs them too.

The runs go in turns, A B ... then ... B A, ``--rounds`` times, so a
drift of the card's clocks hits every checkout alike.  Prints one JSON line
per run, then one with each case's runs by checkout and the card's name and
power limit.  Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

LM_CASES = ("flash_rep", "flash_gqa", "moe_prefill", "moe_decode", "moe_routed")
# (B, k, e_max, y_max, n_cols, valid tasks, occupied y slots, x entries, x
# window) of each SpMV case
SPMV_SHAPES = {
    "spmv_stream": (1, 1024, 4224, 1920, 262_144, 4_165_041, 1_700_783, 1_688_685, 7500),
    "spmv_stream_batched": (8, 64, 5376, 5376, 16_384, 2_054_243, 331_914, 332_403, 930),
}
CASES = LM_CASES + tuple(SPMV_SHAPES)


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


def _device_ms(fn, reps, symbol):
    """The device time of the kernels named ``symbol`` per call of ``fn`` (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and symbol in e.key) / 1e3 / reps


def synthetic_tiles(shape, gen):
    """Streaming operands ``(vals, xg_task, y_lidx, x, seg)`` on the card, f32.

    Row r of the ``(B * k, e_max)`` tiles holds its share of the tasks, sorted
    by y slot, on its share of the occupied slots, which are the row's first
    slots (each at least one task, the rest of the tasks on uniform slots);
    then zero padding, in no run.  Its tasks gather from its share of the x
    entries (each at least once, the rest uniformly), distinct columns drawn
    from a window of ``x_window`` columns that starts at column
    ``p * n_cols / k`` for cluster p.  Task values and x are normal draws.
    """
    import torch

    b, k, e_max, y_max, n_cols, tasks, occupied, x_entries, x_window = shape
    dev, rows = gen.device, b * k
    r = torch.arange(rows, device=dev)[:, None]
    e_count = tasks // rows + (r < tasks % rows).long()
    y_count = occupied // rows + (r < occupied % rows).long()
    x_count = x_entries // rows + (r < x_entries % rows).long()
    slot = torch.arange(e_max, device=dev)[None, :].expand(rows, e_max)
    drawn = (torch.rand((rows, e_max), generator=gen, device=dev) * y_count).long()
    y = torch.where(slot < y_count, slot, drawn)
    y = torch.where(slot < e_count, y, y_max).sort(1).values  # padding last
    valid = y < y_max
    counts = torch.zeros((rows, y_max + 1), dtype=torch.long, device=dev)
    counts.scatter_add_(1, y, torch.ones_like(y))
    seg = torch.zeros((rows, y_max + 1), dtype=torch.int32, device=dev)
    seg[:, 1:] = counts[:, :y_max].cumsum(1)
    vals = torch.randn((rows, e_max), generator=gen, device=dev) * valid
    window = torch.rand((rows, x_window), generator=gen, device=dev).argsort(1)
    drawn = (torch.rand((rows, e_max), generator=gen, device=dev) * x_count).long()
    pick = torch.where(slot < x_count, slot, drawn)  # each x entry read at least once
    xg = ((r % k) * n_cols // k + torch.gather(window, 1, pick)) % n_cols * valid
    x = torch.randn((b, n_cols), generator=gen, device=dev)
    shape3 = (b, k, e_max)
    return (vals.view(shape3), xg.int().view(shape3), (y * valid).int().view(shape3), x,
            seg.view(b, k, y_max + 1))


def worker(root: Path, cases) -> dict:
    """One run: the named cases' kernels of the checkout at ``root``, timed."""
    sys.path.insert(0, str(root / "src"))
    import torch

    out = {"root": str(root)}
    runs = {}
    if any(c in LM_CASES for c in cases):
        runs.update(_lm_runs(out))
    spmv = [c for c in cases if c in SPMV_SHAPES]
    if spmv:
        runs.update(_spmv_runs(spmv))
    for name in cases:
        fn, iters = runs[name]
        try:
            out[name] = _time_ms(fn, iters)
        except ValueError as err:  # an older checkout that does not take the input
            out[name] = None
            out[f"{name}_refused"] = str(err)
            continue
        if name in SPMV_SHAPES:
            out[f"{name}_device_ms"] = _device_ms(fn, 20, "stream_kernel")
            got = fn()
            torch.cuda.synchronize()
            out[f"{name}_sha"] = hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()[:16]
    return out


def _spmv_runs(cases) -> dict:
    import torch

    from repro_torch.kernels import _build, spmv_streaming, spmv_streaming_batched

    _build.build_all(["ep_spmv"])
    gen = torch.Generator(device=torch.device("cuda")).manual_seed(13)
    runs = {}
    for name in cases:
        v, xg, yl, x, seg = synthetic_tiles(SPMV_SHAPES[name], gen)
        y_max = seg.shape[-1] - 1
        if name == "spmv_stream":
            ops = (v[0], xg[0], yl[0], x[0], y_max)
            runs[name] = (lambda ops=ops, s=seg[0]: spmv_streaming(*ops, seg=s), 100)
        else:
            runs[name] = (lambda ops=(v, xg, yl, x, y_max), s=seg:
                          spmv_streaming_batched(*ops, seg=s), 100)
    return runs


def _lm_runs(out) -> dict:
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
    out["occupied_experts"] = int(np.unique(experts).size)
    return {
        "flash_rep": (lambda: flash_attention(q, kr, vr, causal=True), 20),
        "flash_gqa": (lambda: flash_attention(q, k, v, causal=True), 20),
        "moe_prefill": (lambda: moe_mlp(x_prefill, wg, wu, wd), 10),
        "moe_decode": (lambda: moe_mlp(x_decode, wg, wu, wd), 20),
        "moe_routed": (lambda: moe_mlp(x_routed, wg, wu, wd), 20),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+", type=Path)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--cases", default=",".join(CASES),
                    help=f"comma-separated, of {', '.join(CASES)} (default: all)")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    cases = args.cases.split(",")
    unknown = sorted(set(cases) - set(CASES))
    if unknown:
        ap.error(f"unknown cases {unknown}")
    if args.worker:
        print(json.dumps(worker(args.roots[0].resolve(), cases)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    roots = [r.resolve() for r in args.roots]
    order = [r for _ in range(args.rounds) for r in roots + roots[::-1]]
    keys = [k for c in cases
            for k in ((c, f"{c}_device_ms", f"{c}_sha") if c in SPMV_SHAPES else (c,))]
    by_root = {str(r): {k: [] for k in keys} for r in roots}
    for root in order:
        proc = subprocess.run([sys.executable, __file__, "--worker", str(root),
                               "--cases", ",".join(cases)],
                              capture_output=True, text=True, check=True)
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps(run), flush=True)
        for k in keys:
            by_root[run["root"]][k].append(run.get(k))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"ms": by_root, "nvidia_smi": smi}), flush=True)
    differ = [c for c in cases if c in SPMV_SHAPES
              and len({h for runs in by_root.values() for h in runs[f"{c}_sha"]}) > 1]
    if differ:
        print(f"kernel_ab: outputs differ between checkouts in {differ}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
