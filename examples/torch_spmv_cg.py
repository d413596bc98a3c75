"""Conjugate-gradient solver with EP-scheduled SpMV + adaptive overhead
control on the PyTorch/CUDA port — the paper's §5.2 pipeline end to end.

    PYTHONPATH=src python examples/torch_spmv_cg.py [--device cuda|cpu]

CG calls SpMV every iteration; the EP partitioner runs asynchronously on a
host thread (paper §4.2) while iterations proceed with the baseline SpMV
(a scatter-add over the raw COO).  Once the optimized schedule is ready the
solver switches over to the port's software-cache SpMV (the shared-memory
kernel and the combine on the card) — and the first optimized run is timed
against the baseline average with automatic fallback, so the solver can
never lose.  Both SpMV functions end in a device synchronize, so the
scheduler compares device work, not launch latencies.

The same solver as ``examples/spmv_cg.py``, on ``repro_torch``.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import (
    AdaptiveScheduler,
    affinity_graph_from_coo,
    build_pack_plan,
    edge_partition,
    synthetic_bipartite_graph,
)
from repro_torch.device import resolve_device, synchronize
from repro_torch.kernels import make_ep_spmv_fn
from repro_torch.kernels.ref import spmv_coo_ref


def make_spd_problem(n=1024, seed=0):
    """Sparse SPD system A = L L^T + n*I from a random sparse L."""
    edges, rows, cols = synthetic_bipartite_graph(n, n, nnz_per_row=6, seed=seed)
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal(rows.shape[0]).astype(np.float32) * 0.1
    # Symmetrize: A = (B + B^T)/2 + diag boost (diagonally dominant -> SPD).
    r2 = np.concatenate([rows, cols, np.arange(n)])
    c2 = np.concatenate([cols, rows, np.arange(n)])
    v2 = np.concatenate([vals / 2, vals / 2, np.full(n, 4.0, np.float32)])
    key = r2.astype(np.int64) * n + c2
    order = np.argsort(key)
    key, r2, c2, v2 = key[order], r2[order], c2[order], v2[order]
    uniq = np.concatenate([[True], key[1:] != key[:-1]])
    seg = np.cumsum(uniq) - 1
    v2 = np.bincount(seg, weights=v2).astype(np.float32)
    r2, c2 = r2[uniq], c2[uniq]
    return n, r2, c2, v2


def main(argv=None) -> dict:
    """Solves the system; returns the residual, the iterations, the seconds
    and the scheduler's summary."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    n, rows, cols, vals = make_spd_problem()
    b = torch.ones(n, device=dev)
    k = 16

    # Baseline SpMV: scatter-add over the raw COO (CUSP-like).
    rt, ct, vt = (torch.from_numpy(a).to(dev) for a in (rows, cols, vals))

    def baseline(x):
        y = spmv_coo_ref(n, rt, ct, vt, x)
        synchronize(dev)
        return y

    # Async optimization job: EP partition + pack plan.
    def optimize():
        edges = affinity_graph_from_coo(n, n, rows, cols)
        ep = edge_partition(edges, k, method="ep")
        return build_pack_plan(n, n, rows, cols, ep.labels, k, pad=128)

    def build_optimized(plan):
        spmv = make_ep_spmv_fn(plan, vals, mode="software", device=dev)

        def optimized(x):
            y = spmv(x)
            synchronize(dev)
            return y

        return optimized

    sched = AdaptiveScheduler(
        baseline_fn=baseline,
        optimize_fn=optimize,
        build_optimized_fn=build_optimized,
    )

    # CG iterations (spmv via the adaptive scheduler).
    x = torch.zeros(n, device=dev)
    r = b - sched(x)
    p = r
    rs = torch.dot(r, r)
    t0 = time.perf_counter()
    for it in range(60):
        ap_ = sched(p)
        alpha = rs / torch.dot(p, ap_)
        x = x + alpha * p
        r = r - alpha * ap_
        rs_new = torch.dot(r, r)
        if float(torch.sqrt(rs_new)) < 1e-5:
            break
        p = r + (rs_new / rs) * p
        rs = rs_new
    dt = time.perf_counter() - t0
    resid = float(torch.linalg.norm(b - baseline(x)))
    s = sched.summary()
    print(f"CG converged in {it + 1} iters, residual {resid:.2e}, {dt:.2f}s on {dev}")
    print(f"adaptive control: state={s['state']} "
          f"optimize_time={s['optimize_time_s'] and round(s['optimize_time_s'], 3)}s "
          f"baseline_calls={len(sched.baseline_times)} optimized_calls={s['optimized_calls']}")
    assert resid < 1e-3
    print("spmv_cg OK")
    return {"residual": resid, "iterations": it + 1, "seconds": dt, **s}


if __name__ == "__main__":
    main()
