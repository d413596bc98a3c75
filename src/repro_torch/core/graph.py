# Copied verbatim from src/repro/core/graph.py; keep the two in step.
"""Data-affinity graph model (paper §3.1, Definition 1).

A data-affinity graph D = (V, E): vertices are *data objects*, edges are
*computation tasks* touching exactly two data objects.  The graph is stored
two ways:

  * ``EdgeList`` — the canonical (m, 2) task list; the unit of partitioning.
  * ``CSRGraph`` — compressed adjacency used by the multilevel vertex
    partitioner and by the clone-and-connect transformation.

Everything here is NumPy (host-side): the partitioner runs on the host CPU
asynchronously with accelerator compute, exactly like the paper's separate
CPU optimization thread (§4.2).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np

__all__ = [
    "EdgeList",
    "CSRGraph",
    "csr_from_edges",
    "affinity_graph_from_coo",
    "synthetic_mesh_graph",
    "synthetic_powerlaw_graph",
    "synthetic_banded_graph",
    "synthetic_random_graph",
    "synthetic_bipartite_graph",
]


@dataclasses.dataclass(frozen=True)
class EdgeList:
    """Task list: edge i = (u[i], v[i]) is one computation task.

    ``n`` is the number of data objects (vertices).  Self-loops are allowed
    (a task that touches a single data object twice); parallel edges are
    allowed (two tasks over the same data-object pair).
    """

    n: int
    u: np.ndarray  # (m,) int32/int64 endpoint 0
    v: np.ndarray  # (m,) endpoint 1

    def __post_init__(self):
        if self.u.shape != self.v.shape:
            raise ValueError("endpoint arrays must have the same shape")
        if self.m and (int(self.u.max()) >= self.n or int(self.v.max()) >= self.n):
            raise ValueError("endpoint id out of range")
        if self.m and (int(self.u.min()) < 0 or int(self.v.min()) < 0):
            raise ValueError("negative endpoint id")

    @property
    def m(self) -> int:
        return int(self.u.shape[0])

    def degrees(self) -> np.ndarray:
        """Degree of every data object = number of incident tasks."""
        deg = np.bincount(self.u, minlength=self.n)
        deg += np.bincount(self.v, minlength=self.n)
        return deg

    def max_degree(self) -> int:
        return int(self.degrees().max(initial=0))

    def degree_histogram(self) -> dict[int, int]:
        deg = self.degrees()
        vals, counts = np.unique(deg, return_counts=True)
        return {int(d): int(c) for d, c in zip(vals, counts)}


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    """Undirected weighted graph in CSR form (both directions stored).

    ``vweights`` are vertex weights used for balance (coarse vertices carry
    the weight of everything they absorbed).
    """

    indptr: np.ndarray  # (n+1,) int64
    indices: np.ndarray  # (nnz,) int32 neighbour ids
    eweights: np.ndarray  # (nnz,) float64 edge weights
    vweights: np.ndarray  # (n,) int64 vertex weights

    @property
    def n(self) -> int:
        return int(self.indptr.shape[0] - 1)

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    def degree(self) -> np.ndarray:
        return np.diff(self.indptr)

    # Cached COO view.  The multilevel partitioner (coarsening, contraction,
    # connectivity tables, edgecut) repeatedly needs the row index of every
    # stored edge; materializing it once per graph instead of re-running
    # ``np.repeat(arange, diff(indptr))`` at every call site takes the
    # expansion off the hot path.  ``functools.cached_property`` writes to
    # the instance ``__dict__`` directly, so it composes with frozen.
    # Both arrays are frozen (``setflags(write=False)``): they are shared by
    # every stage of every partitioning run on this graph, so a call site
    # mutating them in place would silently corrupt all later coarsening /
    # contraction rounds — writing through the view fails loudly instead.

    @functools.cached_property
    def coo_src(self) -> np.ndarray:
        """(nnz,) int64 source vertex of every stored (directed) edge."""
        arr = np.repeat(np.arange(self.n, dtype=np.int64), np.diff(self.indptr))
        arr.setflags(write=False)
        return arr

    @functools.cached_property
    def coo_dst(self) -> np.ndarray:
        """(nnz,) int64 view of ``indices`` (widened once, reused everywhere)."""
        arr = self.indices.astype(np.int64)
        arr.setflags(write=False)
        return arr


def csr_from_edges(
    n: int,
    eu: np.ndarray,
    ev: np.ndarray,
    ew: Optional[np.ndarray] = None,
    vweights: Optional[np.ndarray] = None,
    dedupe: bool = True,
) -> CSRGraph:
    """Build an undirected CSR graph from an edge list, summing duplicates.

    Self loops are dropped (they contribute nothing to a cut objective).
    """
    eu = np.asarray(eu, dtype=np.int64)
    ev = np.asarray(ev, dtype=np.int64)
    if ew is None:
        ew = np.ones(eu.shape[0], dtype=np.float64)
    else:
        ew = np.asarray(ew, dtype=np.float64)
    keep = eu != ev
    eu, ev, ew = eu[keep], ev[keep], ew[keep]
    # Symmetrize.
    src = np.concatenate([eu, ev])
    dst = np.concatenate([ev, eu])
    w = np.concatenate([ew, ew])
    if dedupe and src.size:
        key = src * n + dst
        order = np.argsort(key, kind="stable")
        key, src, dst, w = key[order], src[order], dst[order], w[order]
        uniq_mask = np.empty(key.shape[0], dtype=bool)
        uniq_mask[0] = True
        np.not_equal(key[1:], key[:-1], out=uniq_mask[1:])
        seg_ids = np.cumsum(uniq_mask) - 1
        w = np.bincount(seg_ids, weights=w)
        src = src[uniq_mask]
        dst = dst[uniq_mask]
    else:
        order = np.argsort(src, kind="stable")
        src, dst, w = src[order], dst[order], w[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, src + 1, 1)
    np.cumsum(indptr, out=indptr)
    if vweights is None:
        vweights = np.ones(n, dtype=np.int64)
    return CSRGraph(
        indptr=indptr,
        indices=dst.astype(np.int32),
        eweights=w.astype(np.float64),
        vweights=np.asarray(vweights, dtype=np.int64),
    )


def affinity_graph_from_coo(
    n_rows: int, n_cols: int, rows: np.ndarray, cols: np.ndarray
) -> EdgeList:
    """Data-affinity graph of SpMV ``y = A @ x`` (paper §5.2).

    One vertex per input-vector element x_j (ids ``0..n_cols``) and per
    output element y_i (ids ``n_cols..n_cols+n_rows``); one edge (task) per
    non-zero A[i, j] connecting x_j with y_i.  Naturally bipartite.
    """
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    return EdgeList(n=n_cols + n_rows, u=cols.copy(), v=n_cols + rows)


# ---------------------------------------------------------------------------
# Synthetic graph generators matching the degree-distribution families of the
# paper's evaluation matrices (Figure 4/5): mesh-like (mc2depi), banded FEM
# (cant), power-law (in-2004, scircuit), random (circuit5M).
# ---------------------------------------------------------------------------


def synthetic_mesh_graph(side: int, seed: int = 0) -> EdgeList:
    """2D grid mesh: nearly all vertices have degree 4 (mc2depi analogue)."""
    n = side * side
    ids = np.arange(n).reshape(side, side)
    right = np.stack([ids[:, :-1].ravel(), ids[:, 1:].ravel()], axis=1)
    down = np.stack([ids[:-1, :].ravel(), ids[1:, :].ravel()], axis=1)
    e = np.concatenate([right, down], axis=0)
    return EdgeList(n=n, u=e[:, 0].copy(), v=e[:, 1].copy())


def _fix_self_loops(u: np.ndarray, v: np.ndarray, n: int) -> np.ndarray:
    """Return ``v`` with self-loops redirected to the next vertex, loop-free.

    Wherever ``u == v``, the new endpoint is ``(v + 1) % n`` — distinct from
    ``u`` for every ``n >= 2`` in a single vectorized shot (no retry loop
    needed: the collision ``u == (v + 1) % n`` would require ``u == v`` and
    ``n == 1`` simultaneously).  ``n < 2`` cannot host a loop-free edge at
    all, so it is rejected up front rather than silently returning loops.
    """
    fix = u == v
    if not fix.any():
        return v
    if n < 2:
        raise ValueError("need n >= 2 to redirect self-loops")
    v = v.copy()
    v[fix] = (v[fix] + 1) % n
    assert not (u == v).any()
    return v


def synthetic_powerlaw_graph(n: int, m: int, alpha: float = 2.2, seed: int = 0) -> EdgeList:
    """Power-law degree graph via weighted endpoint sampling (in-2004-like)."""
    rng = np.random.default_rng(seed)
    w = (np.arange(1, n + 1, dtype=np.float64)) ** (-1.0 / (alpha - 1.0))
    w /= w.sum()
    u = rng.choice(n, size=m, p=w)
    v = _fix_self_loops(u, rng.choice(n, size=m, p=w), n)
    perm = rng.permutation(n)  # decorrelate id from degree
    return EdgeList(n=n, u=perm[u], v=perm[v])


def synthetic_banded_graph(n: int, band: int = 12, seed: int = 0) -> EdgeList:
    """Banded FEM-style matrix graph (cant analogue): degree ~ 2*band."""
    rng = np.random.default_rng(seed)
    offs = np.arange(1, band + 1)
    u = np.repeat(np.arange(n), band)
    v = u + np.tile(offs, n)
    keep = v < n
    u, v = u[keep], v[keep]
    drop = rng.random(u.shape[0]) < 0.15  # irregular holes in the band
    return EdgeList(n=n, u=u[~drop], v=v[~drop])


def synthetic_random_graph(n: int, m: int, seed: int = 0) -> EdgeList:
    """Uniform random graph (circuit5M analogue)."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n, size=m)
    v = _fix_self_loops(u, rng.integers(0, n, size=m), n)
    return EdgeList(n=n, u=u, v=v)


def synthetic_bipartite_graph(
    n_rows: int, n_cols: int, nnz_per_row: int, seed: int = 0, clustered: bool = True
) -> tuple[EdgeList, np.ndarray, np.ndarray]:
    """Sparse-matrix bipartite affinity graph + its COO (rows, cols).

    ``clustered=True`` draws column indices near the diagonal so that real
    locality exists for the partitioner to find (like FEM/circuit matrices).
    """
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n_rows), nnz_per_row)
    if clustered:
        center = (np.repeat(np.arange(n_rows), nnz_per_row) * n_cols) // max(n_rows, 1)
        jitter = rng.integers(-max(4, n_cols // 64), max(4, n_cols // 64) + 1, size=rows.shape[0])
        cols = np.clip(center + jitter, 0, n_cols - 1)
    else:
        cols = rng.integers(0, n_cols, size=rows.shape[0])
    # Dedupe (row, col) pairs.
    key = rows * n_cols + cols
    _, uniq_idx = np.unique(key, return_index=True)
    rows, cols = rows[uniq_idx], cols[uniq_idx]
    return affinity_graph_from_coo(n_rows, n_cols, rows, cols), rows, cols
