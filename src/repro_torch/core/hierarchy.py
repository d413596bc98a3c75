# Copied verbatim from src/repro/core/hierarchy.py; keep the two in step.
"""Two-level (hierarchical) edge partitioning — beyond-paper (DESIGN.md §3.4).

The TPU memory hierarchy has two cache-like levels the paper's single-level
model can exploit *recursively*:

  level 1  edges → devices      cut cost = inter-chip ICI traffic
  level 2  per-device edges → VMEM tiles   cut cost = per-chip HBM traffic

The objective function is identical at both levels (Definition 2); only the
"cache domain" changes.  Because vertex-cut is sub-additive under refinement,
solving level 1 first and then level 2 *within* each device is never worse
for ICI traffic than a flat k_outer·k_inner partition, and it is empirically
better for the combined cost because the outer partitioner spends its entire
budget on the expensive (slow-link) level.

``hierarchical_edge_partition`` returns labels at both levels plus the flat
composite label, and the per-level cut costs so benchmarks can compare
against the flat single-level schedule.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .edge_partition import EdgePartitionResult, edge_partition
from .graph import EdgeList
from .metrics import edge_balance_factor, vertex_cut_cost

__all__ = ["HierarchicalPartition", "hierarchical_edge_partition"]


@dataclasses.dataclass(frozen=True)
class HierarchicalPartition:
    k_outer: int
    k_inner: int
    outer_labels: np.ndarray  # (m,) device id per task
    inner_labels: np.ndarray  # (m,) LOCAL tile id per task (within its device)
    flat_labels: np.ndarray   # (m,) device * k_inner + tile
    outer_cut: int            # ICI-traffic objective (redundant inter-device loads)
    inner_cut: int            # HBM-traffic objective, summed over devices
    flat_cut: int             # vertex-cut of the composite k_outer*k_inner partition
    outer_balance: float
    flat_balance: float

    @property
    def total_k(self) -> int:
        return self.k_outer * self.k_inner


def hierarchical_edge_partition(
    edges: EdgeList,
    k_outer: int,
    k_inner: int,
    method: str = "ep",
    seed: int = 0,
) -> HierarchicalPartition:
    """Partition tasks devices-first, then VMEM-tiles within each device."""
    outer: EdgePartitionResult = edge_partition(edges, k_outer, method=method, seed=seed)
    outer_labels = outer.labels

    inner_labels = np.zeros(edges.m, dtype=np.int32)
    inner_cut = 0
    for d in range(k_outer):
        mask = outer_labels == d
        if not mask.any():
            continue
        # Re-index the device's sub-problem to its local vertex universe so
        # the inner partitioner sees only data the device actually touches.
        sub_u = edges.u[mask]
        sub_v = edges.v[mask]
        verts = np.unique(np.concatenate([sub_u, sub_v]))
        remap = np.empty(edges.n, dtype=np.int64)
        remap[verts] = np.arange(verts.shape[0])
        sub = EdgeList(n=verts.shape[0], u=remap[sub_u], v=remap[sub_v])
        res = edge_partition(sub, k_inner, method=method, seed=seed + 1 + d)
        inner_labels[mask] = res.labels
        inner_cut += res.vertex_cut

    flat_labels = (outer_labels.astype(np.int64) * k_inner + inner_labels).astype(np.int32)
    k_flat = k_outer * k_inner
    return HierarchicalPartition(
        k_outer=k_outer,
        k_inner=k_inner,
        outer_labels=outer_labels,
        inner_labels=inner_labels,
        flat_labels=flat_labels,
        outer_cut=outer.vertex_cut,
        inner_cut=inner_cut,
        flat_cut=vertex_cut_cost(edges, flat_labels, k_flat),
        outer_balance=outer.quality.balance,
        flat_balance=edge_balance_factor(flat_labels, k_flat),
    )
