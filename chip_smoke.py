#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's EP-SpMV serving path on one GPU and check it.

    python3 chip_smoke.py

Builds the kernels from ``src/repro_torch/kernels/csrc`` (nvcc, one process
per source), then drives the port's main path through the entry points a
user calls, with the kernels' launch counts set to 0 just before and read
just after:

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
Then each kernel is run at the main path's shapes, held against its plain
PyTorch twin on the same card tensors, and timed with CUDA events over
back-to-back launches (and alone, from the profiler's trace) beside its
bound (the bytes this run's data needs: valid tasks, the x entries they
read, the y runs and the output, over the card's memory rate), its twin
and one PyTorch library call that computes the same product.  Last, one
warm request in each lane is profiled: its wall time, the host's heaviest
functions (cProfile) and the device's busy time by kernel and copy
(torch.profiler), whose ratio to the wall time is the device's idle
share.  Any failure raises, so the exit code is not 0.  Without a CUDA
device, or without the repository beside it, the script prints no result and
exits 1.  The last line is the device record.
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
TOL = 1e-5
# (matrix side, clusters k[, batch]) of the three serving phases
DEDICATED = (262_144, 1024)
SERVING = (65_536, 256)
BATCHED = (16_384, 64, 8)
DEVICE = "cuda"
# The CUDA kernel each wrapper launches, as the profiler names it.
SYMBOLS = {"spmv_software_cache": "smem_kernel", "spmv_streaming": "stream_kernel",
           "spmv_streaming_batched": "stream_kernel", "ep_combine": "combine_kernel"}


def _emit(obj) -> None:
    print(json.dumps(obj, default=str), flush=True)


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


def _bound(nbytes, flops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
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
    """Each kernel at the main path's shapes against its twin, timed."""
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
        got, want = run(), plain()
        torch.cuda.synchronize()
        err = (got.double() - want.double()).abs().max().item()
        torch.testing.assert_close(got, want, rtol=TOL, atol=TOL, msg=lambda m: f"{name}: {m}")
        ms = _time_ms(run, 100)
        # The kernel alone, from the profiler's trace: back-to-back launches
        # timed by events cannot go below the wrapper's host cost per launch.
        symbol = SYMBOLS[name]
        device_ms = sum(v for key, v in _device_ms(run, 20).items() if symbol in key) or None
        bound_ms, bound_by = _bound(nbytes, flops)
        entries.append({
            "name": name, "route": "cuda", "source": cu, "replaces": replaces,
            "launches": launches[name], "max_abs_err": err, "ms": ms, "kernel_ms": ms,
            "device_ms": device_ms,
            "plain_ms": _time_ms(plain, 20), "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": _time_ms(library, 50), "bytes": nbytes, "shapes": shapes,
        })

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
    _emit({"kernels": entries})


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
    ptxas = [ln.strip() for ln in _build.ptxas_report("ep_spmv").splitlines()
             if "Function properties" in ln or "Used" in ln or "spill" in ln
             or "Compiling entry" in ln]
    _emit({"phase": "build", "seconds": time.perf_counter() - t0, "ptxas": ptxas})

    rng = np.random.default_rng(0)
    reset_launch_counts()
    with PartitionService(max_entries=64) as svc:
        plan, *big = phase_dedicated(svc, rng)
        phase_graph_serving()
        batched_plans = phase_batched(svc)
        launches = launch_counts()
        missing = [name for name, n in launches.items() if n == 0]
        if missing:
            raise AssertionError(f"kernels not launched on the main path: {missing}")
        phase_kernels(plan, big, batched_plans, launches)
        phase_profile(svc, big, batched_plans[0][1])
    _emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    _emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
