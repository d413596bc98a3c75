"""Quickstart on the PyTorch/CUDA port: the paper's EP model in five steps.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cuda|cpu]

1. build a data-affinity graph (tasks = edges, data objects = vertices);
2. partition tasks into cache domains with the EP model (clone-and-connect
   + multilevel vertex partitioning);
3. compare the vertex-cut (= redundant off-chip loads) against baselines;
4. build the cpack layout (PackPlan) and run the EP-scheduled SpMV in
   software-cache mode (the shared-memory kernel and the combine on the
   card; their plain PyTorch versions with ``--device cpu``);
5. verify against the plain COO oracle.

The same steps as ``examples/quickstart.py``, on ``repro_torch``.
"""
import argparse

import numpy as np
import torch

from repro_torch.core import (
    affinity_graph_from_coo,
    build_pack_plan,
    edge_partition,
    synthetic_bipartite_graph,
)
from repro_torch.device import resolve_device
from repro_torch.kernels import make_ep_spmv_fn, spmv_hbm_traffic_model
from repro_torch.kernels.ref import spmv_coo_ref


def main(argv=None) -> float:
    """Runs the five steps; returns the max error against the oracle."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1. A sparse matrix's data-affinity graph: one task per non-zero,
    #    touching one input-vector and one output-vector element.
    n = 2048
    # Clustered structure + SCRAMBLED task order: the matrix has locality,
    # but it is invisible to the default contiguous schedule (the paper's
    # irregular-application setting).  EP rediscovers it from the graph.
    edges, rows, cols = synthetic_bipartite_graph(n, n, nnz_per_row=8, seed=0)
    perm = np.random.default_rng(1).permutation(edges.m)
    rows, cols = rows[perm], cols[perm]
    edges = affinity_graph_from_coo(n, n, rows, cols)
    print(f"affinity graph: {edges.n} data objects, {edges.m} tasks, "
          f"d_max={edges.max_degree()}")

    # 2/3. Partition into k cache domains; compare methods.
    k = 16
    for method in ("default", "random", "greedy", "ep"):
        r = edge_partition(edges, k, method=method)
        print(f"  {method:8s} vertex-cut={r.vertex_cut:7d} "
              f"balance={r.quality.balance:.3f} "
              f"redundant={r.quality.redundant_fraction:.1%} "
              f"({r.partition_time_s * 1e3:.0f} ms)")

    ep = edge_partition(edges, k, method="ep")

    # 4. cpack layout + kernel.
    plan = build_pack_plan(n, n, rows, cols, ep.labels, k, pad=128)
    print(f"pack plan: E_max={plan.e_max} X_max={plan.x_max} Y_max={plan.y_max} "
          f"tile bytes/cluster={plan.vmem_bytes() / 1024:.0f} KiB")
    print(f"modeled HBM loads: {plan.modeled_loads()} "
          f"({spmv_hbm_traffic_model(plan)})")

    rng = np.random.default_rng(0)
    vals = rng.standard_normal(edges.m).astype(np.float32)
    x = rng.standard_normal(n).astype(np.float32)
    spmv = make_ep_spmv_fn(plan, vals, mode="software", device=dev)
    y = spmv(x)

    # 5. Oracle check.
    ref = spmv_coo_ref(n, rows, cols, torch.from_numpy(vals).to(dev),
                       torch.from_numpy(x).to(dev))
    err = float((y - ref).abs().max())
    print(f"max |EP-SpMV - oracle| = {err:.2e} on {dev}")
    assert err < 1e-4
    print("quickstart OK")
    return err


if __name__ == "__main__":
    main()
