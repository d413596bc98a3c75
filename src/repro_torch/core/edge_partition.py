# Copied verbatim from src/repro/core/edge_partition.py; keep the two in step.
"""Balanced edge partitioning — the paper's core contribution (§3).

``edge_partition(edges, k)`` assigns every task (edge) to one of k clusters
(thread blocks on a GPU; Pallas grid cells / mesh shards on TPU), minimizing
the total vertex-cut cost under balance.

Methods:
  * ``"ep"``            — the paper's model: clone-and-connect + multilevel
                          vertex partitioning, via the contracted form
                          (exact, 2x smaller; see transform.py).
  * ``"ep-cloned"``     — literal Definition 3 on the 2m-clone graph with
                          huge weights on original edges (kept for fidelity
                          and for the theorem tests).
  * ``"default" | "random" | "greedy" | "hypergraph"`` — baselines (§3.3).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Literal

import numpy as np

from .baselines import (
    default_schedule,
    greedy_powergraph,
    hypergraph_partition,
    random_partition,
)
from .graph import EdgeList
from .metrics import PartitionQuality, evaluate_edge_partition
from .partition import MultilevelOptions, PartitionStats, partition_vertices
from .transform import (
    clone_and_connect,
    contracted_clone_graph,
    reconstruct_edge_partition,
)

__all__ = ["EdgePartitionResult", "edge_partition", "Method"]

Method = Literal["ep", "ep-cloned", "default", "random", "greedy", "hypergraph"]


@dataclasses.dataclass(frozen=True)
class EdgePartitionResult:
    labels: np.ndarray  # (m,) int32 cluster per task
    k: int
    method: str
    quality: PartitionQuality
    partition_time_s: float
    # Multilevel per-stage timings (coarsen/init/refine) when the method
    # ran the vertex partitioner; None for baselines.
    stats: PartitionStats | None = None

    @property
    def vertex_cut(self) -> int:
        return self.quality.vertex_cut


def edge_partition(
    edges: EdgeList,
    k: int,
    method: Method = "ep",
    opts: MultilevelOptions | None = None,
    seed: int = 0,
    service=None,
    tenant: str = "default",
    priority: int = 0,
) -> EdgePartitionResult:
    if k < 1:
        raise ValueError("k must be >= 1")
    if service is not None:
        # Serving path: consult the async partition service's fingerprint
        # cache (repeated graphs skip partitioning entirely, paper §4.2).
        # ``tenant`` charges the request to that tenant's cache budget;
        # ``priority`` orders it in the service's worker queue.
        return service.get(
            edges, k, method=method, opts=opts, seed=seed,
            tenant=tenant, priority=priority,
        ).result
    t0 = time.perf_counter()
    pstats: PartitionStats | None = None
    if method == "ep":
        g = contracted_clone_graph(edges)
        mo = opts or MultilevelOptions(seed=seed)
        labels, pstats = partition_vertices(g, k, mo)
    elif method == "ep-cloned":
        cg = clone_and_connect(edges)
        mo = opts or MultilevelOptions(seed=seed)
        clone_labels, pstats = partition_vertices(cg.graph, k, mo)
        labels = reconstruct_edge_partition(cg, clone_labels)
    elif method == "default":
        labels = default_schedule(edges, k)
    elif method == "random":
        labels = random_partition(edges, k, seed=seed)
    elif method == "greedy":
        labels = greedy_powergraph(edges, k, seed=seed)
    elif method == "hypergraph":
        labels = hypergraph_partition(edges, k, opts)
    else:
        raise ValueError(f"unknown method {method!r}")
    dt = time.perf_counter() - t0
    quality = evaluate_edge_partition(edges, labels, k)
    return EdgePartitionResult(
        labels=np.asarray(labels, dtype=np.int32),
        k=k,
        method=method,
        quality=quality,
        partition_time_s=dt,
        stats=pstats,
    )
