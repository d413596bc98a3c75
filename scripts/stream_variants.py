#!/usr/bin/env python3
"""Time variants of the streaming SpMV kernel on the plans chip_smoke.py serves, on one card.

    python3 scripts/stream_variants.py [--parent PARENT_ROOT] [--reps 30]

Writes copies of ``src/repro_torch/kernels/csrc/ep_spmv.cu`` that each differ
from it in one design choice of ``stream_kernel`` (``VARIANTS`` names the
text each replaces), builds them with ``nvcc`` (one process each, all at
once) into ``build/stream_variants/``, and times ``stream_kernel`` alone
(torch.profiler, device ms per launch) at the shapes of ``chip_smoke.py``'s
two streaming entries, on real plans: the dedicated plan (262,144 x 262,144,
16 nnz per row, k 1,024, pad 128) and the 8 batched plans (16,384 x 16,384,
k 64) stacked in a 5,376-wide bucket, f32.  ``--parent`` adds the kernel of
another checkout's ``csrc/ep_spmv.cu`` (for instance the parent commit,
unpacked with ``git archive`` into a directory that ``.gitignore`` lists).

The variants run in two rounds, the second in the opposite order, and each
must give the adopted kernel's bits.  Prints one JSON line with each
variant's device ms by plan, its ``ptxas`` registers, and the card's name and
power limit.  Needs one CUDA device; the plans take about a minute to
partition.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src/repro_torch/kernels/csrc/ep_spmv.cu"
OUT = ROOT / "build/stream_variants"
_TASK_LOADS = [(f"__ldcs({a}", f"__ldg({a}") for a in (
    "reinterpret_cast<const V*>(vals + t0))", "reinterpret_cast<const I*>(xg + t0))",
    "vals + t)", "xg + t)")]
# name -> (what it changes, [(text of the adopted source, replacement), ...])
VARIANTS = {
    "adopted": ("1,024 y slots a CTA, 2 vectors a lane, evict-first task loads", []),
    "window_512": ("512 y slots a CTA",
                   [("kSlotsPerThread = 4;", "kSlotsPerThread = 2;")]),
    "window_2048": ("2,048 y slots a CTA (one CTA per dedicated tile)",
                    [("kSlotsPerThread = 4;", "kSlotsPerThread = 8;")]),
    "tasks_ldg": ("task loads through __ldg (L1-allocating) instead of __ldcs", _TASK_LOADS),
    "chunk_4": ("4 vectors a lane per chunk (4,096 f32 task slots)",
                [("kChunkVectors = 2;", "kChunkVectors = 4;")]),
    "carveout_25": ("a 25% shared-memory carveout hint", [(
        "    stream_kernel<T><<<",
        "    cudaFuncSetAttribute(stream_kernel<T>,"
        " cudaFuncAttributePreferredSharedMemoryCarveout, 25);\n    stream_kernel<T><<<")]),
    "ctas_8": ("__launch_bounds__(256, 8): at most 32 registers, 8 CTAs an SM", [(
        "__launch_bounds__(kStreamThreads)\nstream_kernel",
        "__launch_bounds__(kStreamThreads, 8)\nstream_kernel")]),
}


def _build(sources: dict[str, Path]) -> dict:
    """Compile each source; returns name -> (f32 entry point, ptxas registers)."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build as build

    nvcc = build.find_nvcc()
    procs = {name: subprocess.Popen(
        [nvcc, *build.NVCC_FLAGS, "-o", str(OUT / f"{name}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, src in sources.items()}
    built = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {name} variant:\n{out}")
        regs = re.findall(r"stream_kernelIfE\S*' for 'sm_90a'\n.*\n.*\n.*Used (\d+) registers",
                          out)
        fn = ctypes.CDLL(str(OUT / f"{name}.so")).ep_spmv_stream_f32
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        built[name] = (fn, int(regs[0]) if regs else None)
    return built


def _plans(dev):
    """``(vals, xg_task, seg, x, batch, k, e_max, n_cols, y_max)`` of both plans."""
    import numpy as np
    import torch

    from repro_torch.core import build_pack_plan, edge_partition, synthetic_bipartite_graph

    K = importlib.import_module("repro_torch.kernels.ep_spmv")
    pad = torch.nn.functional.pad

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def tiles(n, k, seed, e_max, y_max=None):
        edges, rows, cols = synthetic_bipartite_graph(n, n, 16, seed=seed)
        plan = build_pack_plan(n, n, rows, cols,
                               edge_partition(edges, k, method="ep", seed=0).labels, k, pad=128)
        vals = np.random.default_rng(seed + 1).standard_normal(rows.shape[0]).astype(np.float32)
        xl, yl = t(plan.x_lidx.astype(np.int32)), t(plan.y_lidx.astype(np.int32))
        xg = torch.gather(t(plan.x_gidx.astype(np.int32)), 1, xl.long())
        more = e_max - plan.e_max  # zero padding to the bucket's width, in no run
        ops = [pad(a, (0, more)) for a in (t(plan.pack_values(vals)), xg, yl)]
        seg = K.tile_order(ops[2], y_max or plan.y_max, pad(t(plan.edge_valid), (0, more)))
        return ops[0], ops[1], seg, plan

    v, xg, seg, plan = tiles(262_144, 1024, 0, 4224)
    x = torch.randn((1, plan.n_cols), device=dev)
    dedicated = (v, xg, seg, x, 1, plan.k, plan.e_max, plan.n_cols, plan.y_max)
    stacked = [tiles(16_384, 64, 100 + i, 5376, 5376)[:3] for i in range(8)]
    v, xg, seg = (torch.stack(a).contiguous() for a in zip(*stacked))
    batched = (v, xg, seg, torch.randn((8, 16_384), device=dev), 8, 64, 5376, 16_384, 5376)
    return {"dedicated": dedicated, "batched": batched}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="another checkout whose kernel to time beside")
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("stream_variants: no CUDA device", file=sys.stderr)
        return 1
    OUT.mkdir(parents=True, exist_ok=True)
    text = SOURCE.read_text()
    sources = {}
    for name, (_, edits) in VARIANTS.items():
        src = text
        for old, new in edits:
            if old not in src:
                raise RuntimeError(f"variant {name}: {old!r} is not in {SOURCE.name}")
            src = src.replace(old, new)
        sources[name] = OUT / f"{name}.cu"
        sources[name].write_text(src)
    if args.parent:
        sources["parent"] = args.parent / SOURCE.relative_to(ROOT)
    built = _build(sources)
    dev = torch.device("cuda")
    plans = _plans(dev)

    ms = {case: {name: [] for name in built} for case in plans}
    for case, (v, xg, seg, x, b, k, e_max, n_cols, y_max) in plans.items():
        want = None
        for order in (list(built), list(built)[::-1]):
            for name in order:
                fn = built[name][0]
                out = torch.empty((b * k, y_max), device=dev)

                def run():
                    err = fn(v.data_ptr(), xg.data_ptr(), seg.data_ptr(), x.data_ptr(),
                             out.data_ptr(), b, k, e_max, n_cols, y_max,
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")

                for _ in range(5):
                    run()
                torch.cuda.synchronize()
                want = out.clone() if want is None else want
                if not torch.equal(out, want):
                    raise AssertionError(f"{name} on the {case} plan: bits differ from adopted")
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(args.reps):
                        run()
                    torch.cuda.synchronize()
                ms[case][name].append(sum(
                    e.self_device_time_total for e in prof.key_averages()
                    if "stream_kernel" in e.key) / 1e3 / args.reps)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"device_ms": ms, "registers": {n: r for n, (_, r) in built.items()},
                      "changes": {n: VARIANTS[n][0] for n in VARIANTS}, "nvidia_smi": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
