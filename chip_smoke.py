#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving paths on one GPU and check them.

    python3 chip_smoke.py

Builds the kernels from ``src/repro_torch/kernels/csrc`` (nvcc, one process
per source, all at once), then drives the port's two main paths through the
entry points a user calls, each with the kernels' launch counts set to 0
just before it and read just after.

The EP-SpMV path, in three phases:

  dedicated      GraphServer(PartitionService(), k=1024, pad=128) on a
                 262,144 x 262,144 matrix with 16 nnz per row (4.2M nnz, the
                 scale of the paper's in-2004 / cant): too big for a bucket,
                 so the dedicated lane; 1 cold + 4 warm requests in each mode;
  graph_serving  run_graph_serving at 65,536 x 65,536 x 16 (1M nnz, the
                 paper's scircuit scale), k=256: the bucketed software lane,
                 a 1% churn repartitioned behind a double buffer, and a
                 post-swap dedicated launch;
  batched        8 distinct 16,384 x 16,384 x 16 matrices, k=64, submitted
                 concurrently through the micro-batcher in each mode.

Every y served in the dedicated and batched phases, and in graph_serving
a warm y, a y served during the repartition and the post-swap y, is held
against a float64 COO product on the host (rtol = atol = 1e-5); a stacked
batch must equal each batch of one bit for bit, and in
software mode the bucketed lane must equal the dedicated lane bit for bit.
Then each SpMV kernel is run at the main path's shapes, held against its
plain PyTorch twin on the same card tensors (and the two streaming kernels
bit for bit against the twin run on the CPU, on host copies of the same
tensors), and timed with CUDA events over
back-to-back launches (and alone, from the profiler's trace) beside its
bound (the bytes this run's data needs: valid tasks, the x entries they
read, the y runs and the output, over the card's memory rate), its twin
and one PyTorch library call that computes the same product; and one
warm request in each lane is profiled: its wall time, the host's heaviest
functions (cProfile) and the device's busy time by kernel and copy
(torch.profiler), whose ratio to the wall time is the device's idle share.

The LM serving path (``lm_serving``): qwen3-moe-30b-a3b at its published
widths (d_model 2048, 32/4 heads of 128, 128 experts top-8 of d_ff 768,
vocab 151,936), cut to 8 of its 48 layers, f32 master weights and bf16
compute copies drawn on the card from a seed, serves a batch of 4 prompts
of 2,048 tokens and greedily decodes 32 tokens through ``serve_config`` (what
``run_serving`` runs).  Flash attention must have run once per layer in
prefill and the expert FFN once per layer per step.  Then each kernel is
held against its twin at the shapes that run gave it (bf16: 5e-2, and
1e-2 |want| + 5e-2 rms(row) elementwise) and in
float32 at a smaller shape (2e-5), and timed beside its bound (the larger
of its bytes over the memory rate and its products over the bf16 tensor-core
rate), its twin and one library call (SDPA; three ``bmm`` and a SiLU):
flash attention on the un-repeated K/V prefill passes (4 kv heads) and on
head-repeated K/V, the expert FFN at the prefill capacity and at the decode
capacity on a dense slab and on a slab routed through layer 0's router, whose
bound counts only the experts that hold a pair; a warm
prefill and a warm decode step are profiled (wall, device busy by kernel,
idle share); and the model is checked end to end in float32: reduced
qwen3-moe and granite on the card against the CPU (1e-4), and prefill +
decode against teacher forcing at full width, 2 layers (2e-4).

The build phase also counts the HGMMA (wgmma) and UTMALDG (TMA load)
instructions in each kernel of the flash-attention and expert-FFN libraries,
and the 16-byte global loads (LDG.E...128) in each SpMV kernel
(``cuobjdump -sass``), and fails if a bf16 kernel lacks either of the first
two or the streaming SpMV kernel the third.

Any failure raises, so the exit code is not 0.  Without a CUDA device, or
without the repository beside it, the script prints no result and exits 1.
The line before the last lists every kernel's numbers; the last line is the
device record.
"""
from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM bf16 tensor cores, dense
TOL = 1e-5
# The reference's kernel tolerances (tests/test_kernels.py): bf16 and float32.
BF16_TOL, F32_TOL = 5e-2, 2e-5
# A bf16 kernel is also held elementwise to BF16_RTOL * |want| + BF16_ROW * the
# RMS of want's row (last axis).  The reference's 5e-2 is as large as a typical
# output of causal attention at 2,048 tokens (row i's output has a std of about
# sqrt(e / i)), so it says little of the late rows; a fixed limit far below it
# fails a right kernel on the first rows, whose outputs are O(1) and whose p
# the kernel and its twin round to bf16 (2^-8) at different scales.  Scaled by
# the row, the limit is about 2e-3 at row 2,048 and 5e-2 at the first rows;
# one bf16 ulp of the output is at most 2^-7 of it.
BF16_RTOL, BF16_ROW = 1e-2, 5e-2
# Reduced float32 models on the card against the CPU: sums in other orders
# over 2 layers move logits by a few 1e-6; a fault moves them by 1e-2 or more.
E2E_TOL = 1e-4
# Teacher forcing, the reference's own tolerance (tests/test_models.py).
TF_TOL = 2e-4
# (matrix side, clusters k[, batch]) of the three serving phases
DEDICATED = (262_144, 1024)
SERVING = (65_536, 256)
BATCHED = (16_384, 64, 8)
# LM serving: qwen3-moe-30b-a3b at its published widths, 8 of its 48 layers;
# (batch, prompt tokens, generated tokens).
LM_ARCH, LM_LAYERS = "qwen3-moe-30b-a3b", 8
LM_TRAFFIC = (4, 2048, 32)
DEVICE = "cuda"
SPMV_KERNELS = ("spmv_software_cache", "spmv_streaming", "spmv_streaming_batched", "ep_combine")
LM_KERNELS = ("flash_attention", "moe_mlp")
# The CUDA kernels each wrapper launches (bf16 for the LM ones), as the
# profiler names them.
SYMBOLS = {"spmv_software_cache": ("smem_kernel",), "spmv_streaming": ("stream_kernel",),
           "spmv_streaming_batched": ("stream_kernel",), "ep_combine": ("combine_kernel",),
           "flash_attention": ("flash_bf16_kernel",),
           "moe_mlp": ("gemm_bf16_kernel", "gemm_swap_bf16_kernel")}
LIBRARIES = ("ep_spmv", "flash_attention", "moe_mlp")  # csrc/<name>.cu
# The SASS instructions counted in every kernel (cuobjdump -sass), by name
# and pattern: Hopper's tensor-core and TMA-load instructions, and 16-byte
# global loads with any cache qualifier.  A kernel whose name holds a key of
# SASS_NEEDS must contain each of its instructions: the bf16 LM kernels run
# on wgmma and TMA, the streaming SpMV kernel streams its tasks 16 bytes a
# load.
SASS_OPS = {"HGMMA": r"\bHGMMA\b", "UTMALDG": r"\bUTMALDG\b",
            "LDG.128": r"\bLDG\.E\.(?:\w+\.)*128\b"}
SASS_NEEDS = {"bf16": ("HGMMA", "UTMALDG"), "stream_kernel": ("LDG.128",)}


def _emit(obj) -> None:
    print(json.dumps(obj, default=str), flush=True)


def _is_kernel(name, key) -> bool:
    """Whether the profiler's kernel ``key`` is one that wrapper ``name`` launches."""
    return any(sym in key for sym in SYMBOLS[name])


def sass_counts(name) -> dict:
    """SASS_OPS instructions in each kernel of ``csrc/<name>.cu``'s library
    (``cuobjdump -sass``), by the kernel's mangled name."""
    import re

    from repro_torch.kernels import _build

    counts, fn = {}, None
    for line in _build.sass(name).splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = counts.setdefault(m.group(1), dict.fromkeys(SASS_OPS, 0))
        elif fn is not None:
            for op, pattern in SASS_OPS.items():
                fn[op] += re.search(pattern, line) is not None
    return counts


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _coo_f64(n_rows, rows, cols, vals, x):
    import numpy as np

    return np.bincount(rows, weights=vals.astype(np.float64) * x.astype(np.float64)[cols],
                       minlength=n_rows)


def _check_y(y, n_rows, rows, cols, vals, x, what):
    import numpy as np

    got = y.double().cpu().numpy() if hasattr(y, "cpu") else y.astype(np.float64)
    if got.shape != (n_rows,) or not np.isfinite(got).all():
        raise AssertionError(f"{what}: y of shape {got.shape} is not {n_rows} finite values")
    np.testing.assert_allclose(got, _coo_f64(n_rows, rows, cols, vals, x), rtol=TOL, atol=TOL,
                               err_msg=what)


def _matrix(n_rows, n_cols, nnz_per_row, seed):
    import numpy as np

    from repro_torch.core import synthetic_bipartite_graph

    _, rows, cols = synthetic_bipartite_graph(n_rows, n_cols, nnz_per_row, seed=seed)
    vals = np.random.default_rng(seed + 1).standard_normal(rows.shape[0]).astype(np.float32)
    return rows, cols, vals


def phase_dedicated(svc, rng):
    import numpy as np
    import torch

    from repro_torch.runtime import GraphRequest, GraphServer

    n, k = DEDICATED
    rows, cols, vals = _matrix(n, n, 16, seed=0)
    out = {"phase": "dedicated", "n_rows": n, "n_cols": n, "nnz": int(rows.shape[0]), "k": k}
    for mode in ("software", "streaming"):
        server = GraphServer(svc, k=k, pad=128, mode=mode, start_batcher=False)
        times, plan_hits = [], []
        for i in range(5):
            x = rng.standard_normal(n).astype(np.float32)
            t0 = time.perf_counter()
            res = server.serve(GraphRequest(n, n, rows, cols, vals, x))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            plan_hits.append(res.info.cache_hit)
            if res.info.bucket is not None:
                raise AssertionError("the 4.2M-nnz matrix must take the dedicated lane")
            _check_y(res.y, n, rows, cols, vals, x, f"dedicated {mode} request {i}")
        plan = svc.lookup(res.info.fingerprint).plan
        out[mode] = {"cold_s": times[0], "warm_s": times[1:], "plan_cache_hits": plan_hits}
    out["tiles"] = {"e_max": plan.e_max, "x_max": plan.x_max, "y_max": plan.y_max}
    _emit(out)
    return plan, rows, cols, vals


def phase_graph_serving():
    from repro_torch.launch.serve import run_graph_serving

    n, k = SERVING
    stats = run_graph_serving(n_rows=n, n_cols=n, nnz_per_row=16, k=k, requests=8, churn=0.01,
                              keep_samples=True)
    if len(stats["compile_cache"]["buckets"]) != 1:
        raise AssertionError("the 1M-nnz matrix must take one bucket")
    samples = stats.pop("samples")
    if set(samples) != {"warm", "during_repartition", "post_swap"}:
        raise AssertionError(f"graph_serving kept samples {sorted(samples)}")
    for name, s in samples.items():  # the old matrix, then the churned one
        _check_y(s["y"], n, s["rows"], s["cols"], s["vals"], s["x"], f"graph_serving {name}")
    _emit({"phase": "graph_serving", "y_checked": sorted(samples), **stats})


def phase_batched(svc):
    import numpy as np
    import torch

    from repro_torch.runtime import GraphRequest, GraphServer

    n, k, b = BATCHED
    reqs, mats = [], []
    for i in range(b):
        rows, cols, vals = _matrix(n, n, 16, seed=100 + i)
        x = np.random.default_rng(200 + i).standard_normal(n).astype(np.float32)
        reqs.append(GraphRequest(n, n, rows, cols, vals, x))
        mats.append((rows, cols, vals, x))
    out = {"phase": "batched", "graphs": b, "n": n, "k": k}
    for mode in ("software", "streaming"):
        with GraphServer(svc, k=k, pad=128, mode=mode, max_batch=b,
                         max_wait_ms=300.0) as server:
            alone = [server.serve(r).y.cpu() for r in reqs]  # warms plans and operands
            barrier, results = threading.Barrier(b), [None] * b

            def client(i):
                barrier.wait()
                results[i] = server.submit(reqs[i]).wait(120.0)

            threads = [threading.Thread(target=client, args=(i,)) for i in range(b)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(180.0)
            elapsed = time.perf_counter() - t0
            if any(t.is_alive() for t in threads) or any(r is None for r in results):
                raise AssertionError(f"batched {mode}: a submitted request did not finish")
            sizes = [r.info.batch_size for r in results]
            if max(sizes) < 2:
                raise AssertionError(f"batched {mode}: no batch of more than one ({sizes})")
            for i, (r, y1) in enumerate(zip(results, alone)):
                _check_y(r.y, n, *mats[i], f"batched {mode} request {i}")
                if not torch.equal(r.y.cpu(), y1):
                    raise AssertionError(f"batched {mode}: stacked y != batch-of-1 y ({i})")
            spec = next(iter(server.stats()["buckets"].values()))
            plans = [(svc.lookup(r.info.fingerprint), req) for r, req in zip(results, reqs)]
        same_as_dedicated = None
        if mode == "software":
            dedicated = GraphServer(svc, k=k, pad=128, mode=mode, bucketing=None,
                                    start_batcher=False)
            for i, r in enumerate(reqs):
                if not torch.equal(dedicated.serve(r).y.cpu(), alone[i]):
                    raise AssertionError(f"bucketed y != dedicated y (request {i})")
            same_as_dedicated = True
        out[mode] = {"batch_sizes": sizes, "elapsed_s": elapsed,
                     "bucketed_equals_dedicated": same_as_dedicated,
                     "stacked_equals_batch_of_1": True, "bucket": spec}
    _emit(out)
    return plans


def phase_profile(svc, big, small):
    """Where one warm request's time goes, in each lane.

    Wall time per request on the host clock (ending in a synchronize); the
    host's heaviest functions by self time (cProfile); and the device's busy
    time by kernel, memset and copy (torch.profiler), from which the idle
    share of the wall time follows.
    """
    import cProfile
    import pstats

    import numpy as np
    import torch

    from repro_torch.runtime import GraphRequest, GraphServer

    n, k = DEDICATED
    x = np.random.default_rng(9).standard_normal(n).astype(np.float32)
    lanes = {
        "dedicated": (GraphServer(svc, k=k, pad=128, start_batcher=False),
                      GraphRequest(n, n, *big, x)),
        "bucketed": (GraphServer(svc, k=BATCHED[1], pad=128, start_batcher=False), small),
    }
    reps = 3
    out = {"phase": "profile", "requests_per_lane": reps}

    def serve_all(server, req):
        for _ in range(reps):
            server.serve(req)
        torch.cuda.synchronize()

    for lane, (server, req) in lanes.items():
        serve_all(server, req)  # warm: plan, operands and callable cached
        t0 = time.perf_counter()
        serve_all(server, req)
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps

        host = cProfile.Profile()
        host.runcall(serve_all, server, req)
        stats = pstats.Stats(host).stats
        top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:10]
        host_top = [{"fn": f"{Path(f).name}:{line}({fn})", "self_ms": tt * 1e3 / reps,
                     "cum_ms": ct * 1e3 / reps} for (f, line, fn), (_, _, tt, ct, _) in top]

        device = _device_ms(lambda: server.serve(req), reps)
        busy_ms = sum(device.values()) if device else None  # None: the trace had no device
        out[lane] = {
            "nnz": int(req.rows.shape[0]), "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": None if busy_ms is None else 1.0 - busy_ms / wall_ms,
            "device_top": sorted(device.items(), key=lambda kv: -kv[1])[:8],
            "host_top_self": host_top,
        }
    _emit(out)


def _device_ms(fn, reps):
    """Device time per call of ``fn``, by kernel, memset and copy (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out[e.key] = out.get(e.key, 0.0) + e.self_device_time_total / 1e3 / reps
    return out


def _time_ms(fn, iters):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _bound(nbytes, flops, peak_flops=F32_FLOPS):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak_flops
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def _csr(n_rows, n_cols, rows, cols, vals, dev):
    """The matrix as one torch.sparse_csr_tensor (the library yardstick)."""
    import numpy as np
    import torch

    order = np.lexsort((cols, rows))
    crow = np.zeros(n_rows + 1, dtype=np.int64)
    crow[1:] = np.cumsum(np.bincount(rows, minlength=n_rows))
    return torch.sparse_csr_tensor(
        torch.from_numpy(crow), torch.from_numpy(cols[order].astype(np.int64)),
        torch.from_numpy(vals[order]), (n_rows, n_cols), check_invariants=False).to(dev)


def phase_kernels(plan, big, batched_plans, launches):
    """Each SpMV kernel at the main path's shapes against its twin, timed."""
    import importlib

    import numpy as np
    import torch

    from repro_torch.kernels.ops import pad_plan_operands
    from repro_torch.runtime import BucketPolicy

    K = importlib.import_module("repro_torch.kernels.ep_spmv")
    dev = torch.device(DEVICE)
    cu = "src/repro_torch/kernels/csrc/ep_spmv.cu"
    entries = []

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def entry(name, replaces, run, plain, nbytes, flops, library, shapes):
        entries.append(_kernel_entry(name, replaces, cu, launches[name], run, plain, library,
                                     nbytes, flops, shapes, tol=TOL, peak_flops=F32_FLOPS,
                                     iters=100))

    # Bounds count the bytes this run's data needs, each read or written
    # once: per valid task its value and x index (8 B; plan padding is in no
    # run, so no kernel reads it), one run offset per occupied y slot (4 B),
    # each x entry some task reads (4 B) and the (k, y_max) output (4 B each).
    def spmv_bytes(tasks, y_used, x_used, out):
        return 8 * tasks + 4 * y_used + 4 * x_used + 4 * out

    # Kernels 1, 2 and the combine at the dedicated phase's plan.
    rows, cols, vals = big
    k, e_max, x_max, y_max = plan.k, plan.e_max, plan.x_max, plan.y_max
    n_rows, n_cols = plan.n_rows, plan.n_cols
    tasks, y_used = int(plan.e_count.sum()), int(plan.y_count.sum())
    x = t(np.random.default_rng(5).standard_normal(n_cols).astype(np.float32))
    vp = t(plan.pack_values(vals))
    xl, yl = t(plan.x_lidx.astype(np.int32)), t(plan.y_lidx.astype(np.int32))
    xg = t(plan.x_gidx.astype(np.int32))
    x_packed = x[xg.long()]
    xg_task = torch.gather(xg, 1, xl.long())
    seg = K.tile_order(yl, y_max, t(plan.edge_valid))  # as make_ep_spmv_fn builds it
    a = _csr(n_rows, n_cols, rows, cols, vals, dev)
    xcol = x.unsqueeze(1)
    shapes = {"k": k, "e_max": e_max, "x_max": x_max, "y_max": y_max, "n_cols": n_cols,
              "valid_tasks": tasks, "y_used": y_used}
    entry("spmv_software_cache", "src/repro/kernels/ep_spmv.py:65",
          lambda: K.spmv_software_cache(vp, xl, yl, x_packed, y_max, seg=seg),
          lambda: K.software_cache_plain(vp, xl, yl, x_packed, y_max, seg),
          spmv_bytes(tasks, y_used, int(plan.x_count.sum()), k * y_max), 2 * tasks,
          lambda: a @ xcol, {**shapes, "x_used": int(plan.x_count.sum())})
    cols_used = int(np.unique(cols).size)
    entry("spmv_streaming", "src/repro/kernels/ep_spmv.py:90",
          lambda: K.spmv_streaming(vp, xg_task, yl, x, y_max, seg=seg),
          lambda: K.streaming_plain(vp, xg_task, yl, x, y_max, seg),
          spmv_bytes(tasks, y_used, cols_used, k * y_max), 2 * tasks,
          lambda: a @ xcol, {**shapes, "x_used": cols_used})

    # Kernel 3 at the batched phase's bucket: 8 plans stacked, streaming mode.
    policy = BucketPolicy()
    spec = policy.bucket_for(batched_plans[0][0].padding, "streaming").spec(
        len(batched_plans), pad=128, slack=policy.balance_slack)
    ops = [pad_plan_operands(sp.plan, req.vals, spec) for sp, req in batched_plans]
    v3, yl3 = t(np.stack([o.vals for o in ops])), t(np.stack([o.y_lidx for o in ops]))
    xg3 = torch.gather(t(np.stack([o.x_gidx for o in ops])), 2,
                       t(np.stack([o.x_lidx for o in ops])).long())
    x3 = torch.zeros((spec.batch, spec.n_cols), device=dev)  # zero-padded to the bucket
    for i, (_, req) in enumerate(batched_plans):
        x3[i, : req.n_cols] = t(req.x)
    seg3 = t(np.stack([o.seg for o in ops]))
    tasks3 = sum(int(sp.plan.e_count.sum()) for sp, _ in batched_plans)
    y_used3 = sum(int(sp.plan.y_count.sum()) for sp, _ in batched_plans)
    cols_used3 = sum(int(np.unique(req.cols).size) for _, req in batched_plans)
    nb = batched_plans[0][1].n_rows
    brows = np.concatenate([req.rows + i * nb for i, (_, req) in enumerate(batched_plans)])
    bcols = np.concatenate([req.cols + i * nb for i, (_, req) in enumerate(batched_plans)])
    bvals = np.concatenate([req.vals for _, req in batched_plans])
    a3 = _csr(nb * spec.batch, nb * spec.batch, brows, bcols, bvals, dev)
    x3col = x3[:, :nb].reshape(-1, 1)
    entry("spmv_streaming_batched", "src/repro/kernels/ep_spmv.py:127",
          lambda: K.spmv_streaming_batched(v3, xg3, yl3, x3, spec.y_max, seg=seg3),
          lambda: K.streaming_batched_plain(v3, xg3, yl3, x3, spec.y_max, seg3),
          spmv_bytes(tasks3, y_used3, cols_used3, spec.batch * spec.k * spec.y_max),
          2 * tasks3, lambda: a3 @ x3col,
          {"batch": spec.batch, "k": spec.k, "e_max": spec.e_max, "y_max": spec.y_max,
           "n_cols": spec.n_cols, "valid_tasks": tasks3, "y_used": y_used3,
           "x_used": cols_used3})

    # The streaming kernels keep the twin's bits: each y slot sums its run in
    # task order with the same roundings, so the card's partials equal the
    # twin's run on the CPU on host copies of the same tensors.
    def cpu(*ts):
        return [a.cpu() for a in ts]

    streams = {
        "spmv_streaming": (
            K.spmv_streaming(vp, xg_task, yl, x, y_max, seg=seg),
            K.streaming_plain(*cpu(vp, xg_task, yl, x), y_max, seg.cpu())),
        "spmv_streaming_batched": (
            K.spmv_streaming_batched(v3, xg3, yl3, x3, spec.y_max, seg=seg3),
            K.streaming_batched_plain(*cpu(v3, xg3, yl3, x3), spec.y_max, seg3.cpu())),
    }
    for en in entries:
        if en["name"] in streams:
            got, want = streams[en["name"]]
            got = got.cpu()
            if not torch.equal(got, want):
                raise AssertionError(f"{en['name']}: partials differ from the CPU twin's bits "
                                     f"(max abs {(got - want).abs().max().item()})")
            en["bits_equal_cpu_twin"] = True
    del streams

    # The combine of the dedicated phase's partials: per table entry one
    # partial and its index (8 B), the row pointers and y (4 B each).
    partials = K.spmv_software_cache(vp, xl, yl, x_packed, y_max, seg=seg)
    yg = t(plan.y_gidx.astype(np.int32))
    row_ptr, src = K.combine_table(yg, n_rows)
    n_entries = int(src.shape[0])
    y_acc = torch.zeros(n_rows + 1, device=dev)
    yg_flat, p_flat = yg.reshape(-1).long(), partials.reshape(-1)
    entry("ep_combine", "src/repro/kernels/ops.py:288",
          lambda: K.ep_combine(partials, row_ptr, src, n_rows),
          lambda: K.combine_plain(partials, row_ptr, src, n_rows),
          8 * n_entries + 4 * (n_rows + 1) + 4 * n_rows, n_entries,
          lambda: y_acc.index_add_(0, yg_flat, p_flat),
          {"k": k, "y_max": y_max, "n_rows": n_rows, "entries": n_entries})
    return entries


# ---------------------------------------------------------------------------
# LM serving: prefill + greedy decode of qwen3-moe-30b-a3b
# ---------------------------------------------------------------------------


def phase_lm_serving():
    """The port's run_serving path at full width, launches counted.

    Drives ``serve_config`` (what ``run_serving`` hands a resolved config to)
    with qwen3-moe-30b-a3b cut to LM_LAYERS layers: f32 master weights drawn
    on the card from seed 0, bf16 compute copies (router f32) cast once before
    the prompts (``cast_ms``), a batch of seeded prompts, prefill, then greedy
    decode.  Counts are set to 0 just
    before and read just after: flash attention runs once per layer in
    prefill, the expert FFN once per layer in prefill and in every decode
    step.
    """
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import serve_config
    from repro_torch.models.transformer import moe_capacity

    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=LM_LAYERS)
    b, s, gen = LM_TRAFFIC
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    tokens, stats, state = serve_config(cfg, b, s, gen, seed=0)
    launches = launch_counts()
    want = {"flash_attention": cfg.n_layers, "moe_mlp": cfg.n_layers * gen}
    for name in launches:
        if launches[name] != want.get(name, 0):
            raise AssertionError(f"lm_serving launches {launches}, expected {want}")
    if (tuple(tokens.shape) != (b, gen) or int(tokens.min()) < 0
            or int(tokens.max()) >= cfg.vocab_size):
        raise AssertionError(f"lm_serving tokens {tuple(tokens.shape)} out of range")
    n_params = sum(p.numel() for p in state["params"].parameters())
    _emit({"phase": "lm_serving", "arch": cfg.name, "layers": cfg.n_layers,
           "of_layers": get_config(LM_ARCH).n_layers, "params": n_params,
           "batch": b, "prompt_len": s, "gen": gen,
           "capacity": {"prefill": moe_capacity(cfg, b * s), "decode": moe_capacity(cfg, b)},
           "cast_ms": stats["cast_s"] * 1e3, "prefill_ms": stats["prefill_s"] * 1e3,
           "decode_ms_per_token": stats["decode_s"] * 1e3 / (gen - 1),
           "tok_per_s": stats["tok_per_s"], "launches": launches,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "tokens_head": tokens[0, :8].tolist()})
    return cfg, state, launches


def bf16_scaled_err(got, want) -> float:
    """The worst ``|got - want| / (BF16_RTOL |want| + BF16_ROW rms(want's row))``:
    at most 1 passes."""
    import torch

    w = want.double()
    err = (got.double() - w).abs()
    limit = BF16_RTOL * w.abs() + BF16_ROW * w.square().mean(-1, keepdim=True).sqrt()
    return torch.where(err == 0, 0.0, err / limit).max().item()


def _kernel_entry(name, replaces, source, launches, run, plain, library, nbytes, flops,
                  shapes, *, tol, peak_flops, iters):
    """One kernel against its twin on the same card tensors, then timed.

    ``ms`` is CUDA events over ``iters`` back-to-back launches (never below
    the wrapper's host cost per launch); ``device_ms`` the kernel alone from
    the profiler's trace; ``bound_ms`` the larger of ``nbytes`` over the
    memory rate and ``flops`` over ``peak_flops``.  A bf16 output is held to
    ``tol`` and to the scaled limit of :func:`bf16_scaled_err`.
    """
    import torch

    got, want = run(), plain()
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    err = (got.double() - want.double()).abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol,
                               msg=lambda m: f"{name} {shapes}: {m}")
    scaled = bf16_scaled_err(got, want) if got.dtype == torch.bfloat16 else None
    if scaled is not None and scaled > 1:
        raise AssertionError(f"{name} {shapes}: error up to {scaled:.3g} times "
                             f"{BF16_RTOL} |want| + {BF16_ROW} rms(row)")
    del got, want
    ms = _time_ms(run, iters)
    reps = max(5, iters // 5)
    for _ in range(3):  # a trace now and then holds no device events of a short kernel
        device_ms = sum(v for key, v in _device_ms(run, reps).items() if _is_kernel(name, key))
        if device_ms:
            break
    bound_ms, bound_by = _bound(nbytes, flops, peak_flops)
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": err, "tol": tol, "scaled_err": scaled,
            "ms": ms,
            "device_ms": device_ms or None, "plain_ms": _time_ms(plain, max(3, iters // 5)),
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": _time_ms(library, iters),
            "bytes": nbytes, "flops": flops, "shapes": shapes}


def phase_lm_kernels(cfg, state, launches):
    """flash_attention and moe_mlp at the lm_serving shapes, bf16, against
    their twins (5e-2, and 1e-2 |want| + 5e-2 rms(row) elementwise), timed beside their
    bounds and one library call; and each in float32 at a smaller shape
    against its twin (2e-5, no TF32).

    Flash attention on the un-repeated K/V the prefill passes (Hkv = 4; the
    main entry) and on head-repeated K/V (``head_repeated``, the reference's layout).
    The expert FFN at the prefill capacity (the main entry), and at the
    decode capacity on a dense random slab (``decode``, every expert busy) and on a
    routed slab built as moe_ffn builds it, 4 tokens through layer 0's router
    (``decode_routed``), whose bound counts only the experts that hold a pair.
    """
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention, moe_mlp
    from repro_torch.kernels.ref import flash_attention_ref, moe_mlp_ref
    from repro_torch.models.moe import dispatch, route
    from repro_torch.models.transformer import moe_capacity

    dev = torch.device(DEVICE)
    b, s, _ = LM_TRAFFIC
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    gen = torch.Generator(device=dev).manual_seed(7)

    def randn(shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    entries = []
    # Prefill attention, bf16, causal.  The two products over the causal
    # pairs (i >= j) on the tensor cores; q, k, v read and o written once.
    pairs = s * (s + 1) // 2

    def flash_entry(q, k, v, **library_kw):
        return _kernel_entry(
            "flash_attention", "src/repro/kernels/flash_attention.py:77",
            "src/repro_torch/kernels/csrc/flash_attention.cu", launches["flash_attention"],
            lambda: flash_attention(q, k, v, causal=True),
            lambda: flash_attention_ref(q, k, v, True),
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, **library_kw),
            2 * (q.numel() + k.numel()) * 2, 4 * b * h * dh * pairs,
            {"B": b, "H": h, "Hkv": k.shape[1], "S": s, "T": s, "Dh": dh, "causal": True},
            tol=BF16_TOL, peak_flops=BF16_FLOPS, iters=20)

    q, k, v = randn((b, h, s, dh)), randn((b, hkv, s, dh)), randn((b, hkv, s, dh))
    flash = flash_entry(q, k, v, enable_gqa=True)
    g = h // hkv
    flash["head_repeated"] = flash_entry(q, k.repeat_interleave(g, 1).contiguous(),
                                         v.repeat_interleave(g, 1).contiguous())
    entries.append(flash)
    del q, k, v

    # The expert FFN on layer 0's bf16 expert weights: three products per
    # slab row that holds a token; x read, the output written and the
    # weights of every expert that has to be computed read once.
    moe = state["compute"].blocks[0].ffn.moe
    wg, wu, wd = moe.w_gate, moe.w_up, moe.w_down
    e, d, f = wg.shape

    def moe_entry(x, iters, experts=e, rows=None):
        cap = x.shape[1]
        rows = e * cap if rows is None else rows

        def library():
            return torch.bmm(F.silu(torch.bmm(x, wg)) * torch.bmm(x, wu), wd)

        return _kernel_entry(
            "moe_mlp", "src/repro/kernels/moe_mlp.py:37",
            "src/repro_torch/kernels/csrc/moe_mlp.cu", launches["moe_mlp"],
            lambda: moe_mlp(x, wg, wu, wd), lambda: moe_mlp_ref(x, wg, wu, wd), library,
            2 * (2 * e * cap * d + 3 * experts * d * f), 6 * rows * d * f,
            {"E": e, "C": cap, "D": d, "F": f, "experts_computed": experts, "rows": rows},
            tol=BF16_TOL, peak_flops=BF16_FLOPS, iters=iters)

    prefill = moe_entry(randn((e, moe_capacity(cfg, b * s), d), wg.dtype), 10)
    cap = moe_capacity(cfg, b)
    prefill["decode"] = moe_entry(randn((e, cap, d), wg.dtype), 20)
    tokens = randn((b, d), wg.dtype)
    _, _, ids = route(tokens, moe.router, cfg.moe.top_k)
    slab, _, keep = dispatch(tokens, ids, e, cap)
    occupied = int(torch.unique(ids).numel())
    routed = moe_entry(slab, 20, experts=occupied, rows=int(keep.sum()))
    routed["bound_all_experts_ms"] = prefill["decode"]["bound_ms"]
    prefill["decode_routed"] = routed
    entries.append(prefill)

    # float32 at smaller shapes, no TF32 in the twins' products.
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    f32 = {}
    q = randn((1, 4, 256, dh), torch.float32)
    k, v = (randn((1, 2, 256, dh), torch.float32) for _ in range(2))  # 2 kv heads
    got, want = flash_attention(q, k, v, causal=True), flash_attention_ref(q, k, v, True)
    torch.testing.assert_close(got, want, rtol=F32_TOL, atol=F32_TOL)
    f32["flash_attention"] = {"shape": [1, 4, 256, dh], "kv_heads": 2,
                              "max_abs_err": (got - want).abs().max().item(),
                              "out_abs_max": got.abs().max().item()}
    x = randn((8, 64, d), torch.float32)
    w = [randn(shape, torch.float32, shape[1] ** -0.5)
         for shape in ((8, d, f), (8, d, f), (8, f, d))]
    got, want = moe_mlp(x, *w), moe_mlp_ref(x, *w)
    torch.testing.assert_close(got, want, rtol=F32_TOL, atol=F32_TOL)
    f32["moe_mlp"] = {"shape": [8, 64, d, f], "max_abs_err": (got - want).abs().max().item(),
                      "out_abs_max": got.abs().max().item()}
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    _emit({"phase": "lm_kernels", "tol": {"bf16": BF16_TOL, "bf16_rtol": BF16_RTOL,
                                          "bf16_row": BF16_ROW, "f32": F32_TOL},
           "f32": f32,
           "bf16": {en["name"]: [en["max_abs_err"], en["scaled_err"]] for en in entries},
           "flash_head_repeated_bf16": [flash["head_repeated"]["max_abs_err"],
                                        flash["head_repeated"]["scaled_err"]],
           "moe_decode_bf16": [prefill["decode"]["max_abs_err"],
                               prefill["decode"]["scaled_err"]],
           "moe_decode_routed_bf16": [routed["max_abs_err"], routed["scaled_err"]],
           "occupied_experts": occupied})
    return entries


def phase_lm_profile(cfg, state):
    """Where a warm prefill and a warm decode step spend their time.

    Wall time on the host clock (ending in a synchronize), and the device's
    busy time by kernel from torch.profiler, whose ratio to the wall time
    gives the device's idle share.  The warm prefill's logits are checked
    for shape and finiteness.
    """
    import time as _time

    import torch

    model, params, prompt = state["model"], state["compute"], state["prompt"]
    b, s, gen = LM_TRAFFIC
    out = {"phase": "lm_profile"}
    cache = None

    def prefill():
        nonlocal cache
        logits, cache = model.prefill(params, {"tokens": prompt}, s + gen)
        return logits

    def decode():
        tok = torch.zeros((b, 1), dtype=torch.long, device=prompt.device)
        return model.decode_step(params, cache, {"tokens": tok}, s)[0]

    for name, fn in (("prefill", prefill), ("decode_step", decode)):
        t0 = _time.perf_counter()
        logits = fn()
        torch.cuda.synchronize()
        wall_ms = (_time.perf_counter() - t0) * 1e3
        if tuple(logits.shape) != (b, cfg.vocab_size) or not torch.isfinite(logits).all():
            raise AssertionError(f"lm {name}: logits {tuple(logits.shape)} not finite")
        device = _device_ms(fn, 1)
        busy = sum(device.values())
        ours = {k: sum(v for key, v in device.items() if _is_kernel(k, key)) for k in LM_KERNELS}
        out[name] = {"wall_ms": wall_ms, "device_busy_ms": busy,
                     "idle_share": 1.0 - busy / wall_ms, "kernels_ms": ours,
                     "device_top": sorted(device.items(), key=lambda kv: -kv[1])[:10]}
    _emit(out)


def phase_lm_checks():
    """The model end to end, float32, against the twins and against itself.

    (1) Reduced qwen3-moe-30b-a3b and granite-3-8b: the same weights (drawn
    on the CPU) and prompt through prefill and three decode steps, fed the
    CPU's tokens, on the card (kernels) and on the CPU (twins).  (2) Teacher
    forcing at qwen3-moe-30b-a3b's full width, 2 layers, B = 2, S = 256,
    capacity factor 16 (nothing dropped): prefill(S) then decode of token S
    equals prefill(S + 1)'s last logits.
    """
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import Model

    dev = torch.device(DEVICE)
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    out = {"phase": "lm_checks", "tf32": False, "tol": {"card_vs_cpu": E2E_TOL,
                                                       "teacher_forcing": TF_TOL}}
    for arch in (LM_ARCH, "granite-3-8b"):
        cfg = get_config(arch, reduced=True)
        cpu, card = Model(cfg, device="cpu"), Model(cfg, device=dev)
        params = cpu.init(0)
        params_card = params.map(lambda _, w: w.to(dev))
        tokens = torch.from_numpy(np.random.default_rng(0).integers(2, cfg.vocab_size, (2, 24)))
        want, cache = cpu.prefill(params, {"tokens": tokens}, 27)
        got, cache_card = card.prefill(params_card, {"tokens": tokens.to(dev)}, 27)
        errs = [(got.cpu() - want).abs().max().item()]
        for i in range(3):
            tok = torch.argmax(want, -1)[:, None]
            want, cache = cpu.decode_step(params, cache, {"tokens": tok}, 24 + i)
            got, cache_card = card.decode_step(params_card, cache_card,
                                               {"tokens": tok.to(dev)}, 24 + i)
            errs.append((got.cpu() - want).abs().max().item())
        if max(errs) > E2E_TOL:
            raise AssertionError(f"{arch} reduced: card vs CPU logits differ by {errs}")
        out[f"{arch}_reduced_max_abs_err"] = errs

    full = get_config(LM_ARCH)
    cfg = dataclasses.replace(full, n_layers=2, compute_dtype="float32",
                              moe=dataclasses.replace(full.moe, capacity_factor=16.0))
    model = Model(cfg, device=dev)
    params = model.init(1)
    s = 256
    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(2, cfg.vocab_size, (2, s + 1))).to(dev)
    whole, _ = model.prefill(params, {"tokens": tokens}, s + 1)
    _, cache = model.prefill(params, {"tokens": tokens[:, :s]}, s + 1)
    step, _ = model.decode_step(params, cache, {"tokens": tokens[:, s:]}, s)
    err = (step - whole).abs().max().item()
    if not torch.isfinite(step).all() or err > TF_TOL:
        raise AssertionError(f"teacher forcing at full width: logits differ by {err}")
    out["teacher_forcing"] = {"layers": 2, "batch": 2, "prompt": s, "max_abs_err": err,
                              "logit_abs_max": whole.abs().max().item()}
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    _emit(out)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing was run",
              file=sys.stderr)
        return 1
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run from the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    import numpy as np

    from repro_torch.core import PartitionService
    from repro_torch.kernels import _build, launch_counts, reset_launch_counts

    t_start = time.perf_counter()
    smi = _nvidia_smi()
    _emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count(), "nvidia_smi": smi,
           "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    _build.build_all()
    ptxas = [ln.strip() for name in LIBRARIES
             for ln in _build.ptxas_report(name).splitlines()
             if "Used" in ln or "spill" in ln or "Compiling entry" in ln]
    sass = {name: sass_counts(name) for name in LIBRARIES}
    _emit({"phase": "build", "seconds": time.perf_counter() - t0, "ptxas": ptxas, "sass": sass})
    lacking = [(fn, op) for counts in sass.values() for fn, n in counts.items()
               for key, ops in SASS_NEEDS.items() if key in fn for op in ops if not n[op]]
    if lacking:
        raise AssertionError(f"kernels without the instructions of their design: {lacking}")

    rng = np.random.default_rng(0)
    reset_launch_counts()
    with PartitionService(max_entries=64) as svc:
        plan, *big = phase_dedicated(svc, rng)
        phase_graph_serving()
        batched_plans = phase_batched(svc)
        launches = launch_counts()
        missing = [name for name in SPMV_KERNELS if launches[name] == 0]
        if missing:
            raise AssertionError(f"kernels not launched on the SpMV path: {missing}")
        entries = phase_kernels(plan, big, batched_plans, launches)
        phase_profile(svc, big, batched_plans[0][1])

    cfg, state, launches = phase_lm_serving()
    entries += phase_lm_kernels(cfg, state, launches)
    phase_lm_profile(cfg, state)
    del state
    torch.cuda.empty_cache()
    phase_lm_checks()
    _emit({"kernels": entries})
    _emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    _emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
