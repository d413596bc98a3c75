# Copied verbatim from src/repro/core/metrics.py; keep the two in step.
"""Partition quality metrics (paper Definition 2 and §3.1).

The central quantity is the total vertex-cut cost

    C = sum_v (p_v - 1)

where p_v is the number of distinct edge clusters that vertex v's incident
edges fall into.  C equals the number of *redundant data accesses*: every
extra cluster a data object appears in is one extra fetch from off-chip
memory (HBM on TPU).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .graph import EdgeList

__all__ = [
    "vertex_cut_cost",
    "parts_per_vertex",
    "edge_balance_factor",
    "replication_factor",
    "redundant_load_fraction",
    "PartitionQuality",
    "evaluate_edge_partition",
]


def parts_per_vertex(edges: EdgeList, labels: np.ndarray, k: int) -> np.ndarray:
    """p_v = number of distinct clusters among v's incident edges (0 for
    isolated vertices)."""
    labels = np.asarray(labels, dtype=np.int64)
    v_ids = np.concatenate([edges.u, edges.v])
    l_ids = np.concatenate([labels, labels])
    key = v_ids.astype(np.int64) * k + l_ids
    uniq = np.unique(key)
    pv = np.bincount((uniq // k).astype(np.int64), minlength=edges.n)
    return pv


def vertex_cut_cost(edges: EdgeList, labels: np.ndarray, k: int) -> int:
    """C = sum_v (p_v - 1), the data-reuse cost / redundant access count."""
    pv = parts_per_vertex(edges, labels, k)
    touched = pv > 0
    return int((pv[touched] - 1).sum())


def edge_balance_factor(labels: np.ndarray, k: int) -> float:
    """max cluster size / average cluster size (paper: <1.03 in practice)."""
    counts = np.bincount(np.asarray(labels, dtype=np.int64), minlength=k)
    avg = labels.shape[0] / k
    return float(counts.max() / avg) if avg > 0 else 1.0


def replication_factor(edges: EdgeList, labels: np.ndarray, k: int) -> float:
    """Average number of clusters each touched data object appears in."""
    pv = parts_per_vertex(edges, labels, k)
    touched = pv > 0
    return float(pv[touched].mean()) if touched.any() else 0.0


def redundant_load_fraction(edges: EdgeList, labels: np.ndarray, k: int) -> float:
    """Fraction of loads that are redundant: C / (n_touched + C).

    Each touched object needs 1 compulsory load + (p_v - 1) redundant ones.
    The paper reports 73.4% redundancy for cfd under default scheduling.
    """
    pv = parts_per_vertex(edges, labels, k)
    touched = pv > 0
    total = int(pv[touched].sum())
    compulsory = int(touched.sum())
    return (total - compulsory) / total if total else 0.0


@dataclasses.dataclass(frozen=True)
class PartitionQuality:
    k: int
    vertex_cut: int
    balance: float
    replication: float
    redundant_fraction: float
    loads_total: int  # sum_v p_v = memory fetches under this schedule

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def evaluate_edge_partition(edges: EdgeList, labels: np.ndarray, k: int) -> PartitionQuality:
    pv = parts_per_vertex(edges, labels, k)
    touched = pv > 0
    total = int(pv[touched].sum())
    compulsory = int(touched.sum())
    return PartitionQuality(
        k=k,
        vertex_cut=total - compulsory,
        balance=edge_balance_factor(labels, k),
        replication=float(pv[touched].mean()) if compulsory else 0.0,
        redundant_fraction=(total - compulsory) / total if total else 0.0,
        loads_total=total,
    )
