# Copied verbatim from src/repro/core/baselines.py; keep the two in step.
"""Baseline task-partition methods the paper compares against (§3.3, Fig 6).

* ``default_schedule``      — the GPU default: tasks in input order, chunked
                              into equal-size blocks (CUSP-style layout).
* ``random_partition``      — PowerGraph's random edge placement.
* ``greedy_powergraph``     — PowerGraph's greedy heuristic: prefer a
                              partition already holding an endpoint, else
                              the least-loaded partition.
* ``hypergraph_partition``  — hMETIS/PaToH stand-in: tasks are hypergraph
                              vertices, data objects are nets; partitioned
                              via star expansion with the same multilevel
                              engine.  Measures the same (lambda - 1) net
                              cut as the paper's hypergraph model.
"""
from __future__ import annotations

import numpy as np

from .graph import EdgeList, csr_from_edges
from .partition import MultilevelOptions, partition_vertices

__all__ = [
    "default_schedule",
    "random_partition",
    "greedy_powergraph",
    "hypergraph_partition",
]


def default_schedule(edges: EdgeList, k: int) -> np.ndarray:
    """Tasks in input order, split into k equal contiguous chunks."""
    m = edges.m
    chunk = -(-m // k)
    return (np.arange(m, dtype=np.int64) // chunk).astype(np.int32)


def random_partition(edges: EdgeList, k: int, seed: int = 0) -> np.ndarray:
    """PowerGraph random placement (balanced by round-robin of a shuffle)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(edges.m)
    labels = np.empty(edges.m, dtype=np.int32)
    labels[perm] = np.arange(edges.m, dtype=np.int64) % k
    return labels


def greedy_powergraph(edges: EdgeList, k: int, seed: int = 0) -> np.ndarray:
    """PowerGraph greedy placement (sequential, endpoint-affinity).

    For each edge in order: if some partition already holds both endpoints,
    pick it; else if some partition holds one endpoint, pick the least
    loaded of those; else pick the globally least-loaded partition.  A
    capacity cap keeps the result balanced, matching PowerGraph's balance
    constraint.
    """
    m = edges.m
    cap = -(-m // k) * 1.05 + 1
    labels = np.empty(m, dtype=np.int32)
    load = np.zeros(k, dtype=np.int64)
    # partition sets per vertex, stored as python sets (host-side; the paper
    # notes these methods are fast but low quality).
    vparts: list[set[int]] = [set() for _ in range(edges.n)]
    u_arr = edges.u
    v_arr = edges.v
    for e in range(m):
        u, v = int(u_arr[e]), int(v_arr[e])
        pu, pv = vparts[u], vparts[v]
        both = pu & pv
        cand: set[int] | None = None
        if both:
            cand = both
        elif pu or pv:
            cand = pu | pv
        if cand:
            best, best_load = -1, None
            for p in cand:
                if load[p] >= cap:
                    continue
                if best_load is None or load[p] < best_load:
                    best, best_load = p, load[p]
            if best >= 0:
                labels[e] = best
                load[best] += 1
                pu.add(best)
                pv.add(best)
                continue
        p = int(np.argmin(load))
        labels[e] = p
        load[p] += 1
        pu.add(p)
        pv.add(p)
    return labels


def hypergraph_partition(
    edges: EdgeList, k: int, opts: MultilevelOptions | None = None
) -> np.ndarray:
    """Hypergraph model via star expansion (hMETIS/PaToH stand-in).

    Hypergraph: vertex per task (weight 1), net per data object covering the
    tasks that touch it.  Star expansion inserts one zero-weight hub node
    per net connected to each of its pins; partitioning the expanded graph
    with the multilevel engine approximates minimizing the (lambda - 1) net
    cut — the same objective the paper's hypergraph baseline optimizes.
    """
    opts = opts or MultilevelOptions()
    m, n = edges.m, edges.n
    # Task nodes: 0..m, hub nodes: m..m+n.
    pin_src = np.concatenate([np.arange(m, dtype=np.int64)] * 2)
    pin_dst = np.concatenate([m + edges.u, m + edges.v])
    vweights = np.concatenate(
        [np.ones(m, dtype=np.int64), np.zeros(n, dtype=np.int64)]
    )
    g = csr_from_edges(m + n, pin_src, pin_dst, None, vweights=vweights)
    labels, _ = partition_vertices(g, k, opts)
    return labels[:m].astype(np.int32)
