# Copied verbatim from src/repro/core/transform.py; keep the two in step.
"""Clone-and-connect transformation (paper §3.2, Definitions 3-4).

Balanced edge partitioning of the data-affinity graph D = (V, E) is reduced
to balanced vertex partitioning of a transformed graph D' = (V', E'):

  * every vertex v of degree d is replaced by d *cloned vertices*, one per
    incident edge;
  * every original edge (u, v) becomes an edge between the matching clones
    (weight ``original_weight``, chosen huge so the vertex partitioner never
    cuts it);
  * the d clones of each vertex are connected into a *path* with d - 1
    auxiliary edges of weight 1 (connected in index order, the paper's
    practical choice).

D' has exactly 2m vertices.  A balanced vertex partition of D' that cuts no
original edge maps back (Definition 4) to a balanced edge partition of D
whose vertex-cut cost is bounded by the number of cut auxiliary edges
(Theorem 1), giving the (d_max - 1)·O(sqrt(log m log k)) approximation
(Theorem 2).

Two constructions are provided:

``clone_and_connect``  — literal Definition 3 (used for the theorem tests
    and for fidelity).

``contracted_clone_graph`` — the same graph after contracting every
    original edge (each infinite-weight pair of clones becomes one node of
    weight 1).  This is *exactly* what a multilevel partitioner would do
    with the infinite-weight edges in its first coarsening step, so
    partitioning the contracted graph is equivalent — but ~2x smaller and
    guarantees no original edge is ever cut.  Nodes of the contracted graph
    are the original edges themselves; auxiliary path edges connect edges
    that are consecutive in some vertex's incidence list.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .graph import CSRGraph, EdgeList, csr_from_edges

__all__ = [
    "ClonedGraph",
    "clone_and_connect",
    "contracted_clone_graph",
    "reconstruct_edge_partition",
]

#: Weight given to original edges so the partitioner treats them as uncuttable.
ORIGINAL_EDGE_WEIGHT = 1e9


@dataclasses.dataclass(frozen=True)
class ClonedGraph:
    """D' = (V', E') plus the bookkeeping to map a partition of V' back.

    Clone ids: edge e of D contributes clones ``2e`` (for endpoint u) and
    ``2e + 1`` (for endpoint v); hence ``clone_owner[c] = e = c >> 1`` and
    the original vertex of clone c is recorded in ``clone_vertex``.
    """

    graph: CSRGraph  # 2m vertices
    clone_vertex: np.ndarray  # (2m,) original vertex id of each clone
    n_original_edges: int
    aux_src: np.ndarray  # auxiliary path edges (for analysis)
    aux_dst: np.ndarray


def _incidence_order(edges: EdgeList) -> tuple[np.ndarray, np.ndarray]:
    """Per-vertex incidence lists as (sorted clone ids, vertex indptr).

    Clone c belongs to vertex ``clone_vertex[c]``; sorting clones by vertex
    (stable, so clones keep edge-index order — the paper connects clones in
    index order) gives each vertex's incidence list contiguously.
    """
    m = edges.m
    clone_vertex = np.empty(2 * m, dtype=np.int64)
    clone_vertex[0::2] = edges.u
    clone_vertex[1::2] = edges.v
    order = np.argsort(clone_vertex, kind="stable")
    counts = np.bincount(clone_vertex, minlength=edges.n)
    indptr = np.zeros(edges.n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return order, indptr


def clone_and_connect(edges: EdgeList) -> ClonedGraph:
    """Literal Definition 3: build D' with 2m clones, original + aux edges."""
    m = edges.m
    clone_vertex = np.empty(2 * m, dtype=np.int64)
    clone_vertex[0::2] = edges.u
    clone_vertex[1::2] = edges.v

    # Original edges between the two clones of each task.
    orig_src = np.arange(0, 2 * m, 2, dtype=np.int64)
    orig_dst = orig_src + 1

    # Auxiliary path edges: consecutive clones in each vertex's incidence
    # list (index order).
    order, indptr = _incidence_order(edges)
    aux_src_list = []
    aux_dst_list = []
    starts = indptr[:-1]
    ends = indptr[1:]
    # Consecutive pairs within each vertex segment, vectorized: a pair
    # (order[i], order[i+1]) is an aux edge iff i and i+1 fall in the same
    # vertex segment.
    if order.size >= 2:
        same_seg = clone_vertex[order[:-1]] == clone_vertex[order[1:]]
        aux_src_list.append(order[:-1][same_seg])
        aux_dst_list.append(order[1:][same_seg])
    aux_src = (
        np.concatenate(aux_src_list) if aux_src_list else np.empty(0, dtype=np.int64)
    )
    aux_dst = (
        np.concatenate(aux_dst_list) if aux_dst_list else np.empty(0, dtype=np.int64)
    )

    src = np.concatenate([orig_src, aux_src])
    dst = np.concatenate([orig_dst, aux_dst])
    w = np.concatenate(
        [
            np.full(m, ORIGINAL_EDGE_WEIGHT, dtype=np.float64),
            np.ones(aux_src.shape[0], dtype=np.float64),
        ]
    )
    g = csr_from_edges(2 * m, src, dst, w)
    return ClonedGraph(
        graph=g,
        clone_vertex=clone_vertex,
        n_original_edges=m,
        aux_src=aux_src,
        aux_dst=aux_dst,
    )


def contracted_clone_graph(edges: EdgeList) -> CSRGraph:
    """D' with every original edge contracted: m nodes (= tasks), aux edges.

    Node i of the result IS task/edge i of D (vertex weight 1).  For every
    original vertex v of degree d, its d incident tasks are chained into a
    path (in index order) with d - 1 auxiliary edges of weight 1.  Parallel
    aux edges (two tasks sharing both endpoints) are merged with summed
    weight, which only helps the partitioner keep them together.
    """
    m = edges.m
    clone_vertex = np.empty(2 * m, dtype=np.int64)
    clone_vertex[0::2] = edges.u
    clone_vertex[1::2] = edges.v
    order, _ = _incidence_order(edges)
    if order.size >= 2:
        same_seg = clone_vertex[order[:-1]] == clone_vertex[order[1:]]
        a = order[:-1][same_seg] >> 1  # clone id -> task id
        b = order[1:][same_seg] >> 1
    else:
        a = np.empty(0, dtype=np.int64)
        b = np.empty(0, dtype=np.int64)
    return csr_from_edges(m, a, b, np.ones(a.shape[0], dtype=np.float64))


def reconstruct_edge_partition(
    cloned: ClonedGraph, clone_labels: np.ndarray
) -> np.ndarray:
    """Definition 4: map a vertex partition of D' to an edge partition of D.

    If the partitioner cut an original edge despite its huge weight (it
    should not), the edge is assigned to the partition of its first clone.
    """
    lab0 = clone_labels[0::2]
    return np.asarray(lab0, dtype=np.int32)
