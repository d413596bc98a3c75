# Copied verbatim from src/repro/core/coarsen.py; keep the two in step.
"""Size-constrained cluster-coarsening engine for the multilevel V-cycle.

Pairwise heavy-edge matching halves the graph *at best* per level (and far
less on power-law degree distributions, where hubs exhaust their neighbours
after one match), so the V-cycle needs 10+ levels on banded graphs and
stalls thousands of vertices above the target on random/power-law ones.
Modern multilevel partitioners replaced matching with *cluster* coarsening:
every vertex proposes to join a neighbouring cluster, whole stars and chains
collapse at once, and one level contracts 3-8x.

This module is that engine, fully array-native:

  * :meth:`ClusterCoarsener.cluster_level` — one level of size-constrained
    clustering.  Each round, every still-singleton vertex proposes to join
    the cluster of its heaviest-affinity neighbour (jittered heavy-edge
    affinity; see the in-line note on why cluster-weight normalization was
    measured and rejected);
    a random-rank direction rule makes the proposal pointer graph acyclic,
    **pointer-jumping** flattens chains to cluster roots in O(log n) array
    steps, and admission into each cluster is a score-ordered prefix-sum of
    joiner weights against the cluster-size cap (derived from the balance
    slack, so refinement can still rebalance the projected partition).
  * :meth:`ClusterCoarsener.contract_clusters` — contraction by an
    *arbitrary* fine->coarse root map (the generalization of the old
    matched-pair ``_contract``): dense-scatter renumbering, parallel-edge
    dedupe via a packed-key bincount histogram when the coarse graph is
    small (skipping the per-level full-nnz ``argsort``), stable-argsort
    grouping otherwise — both paths produce byte-identical coarse graphs.

The engine owns its scratch buffers (:meth:`_buf`), so the n- and nnz-sized
work arrays are allocated once at the finest level and reused as the levels
shrink.  Pairwise matching survives in ``partition._heavy_edge_matching`` as
the property-test reference, selectable via
``MultilevelOptions(coarsen_mode="matching")``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .graph import CSRGraph
from .refine import run_first_mask, segmented_cumsum, segmented_max

__all__ = ["ClusterCoarsener", "LevelStats", "contract_clusters"]


@dataclasses.dataclass
class LevelStats:
    """Per-level coarsening record (one entry per V-cycle contraction)."""

    n: int  # fine vertex count entering the level
    nnz: int  # fine stored (directed) edge count
    coarse_n: int  # vertex count after contraction
    ratio: float  # n / coarse_n — the level's contraction factor
    time_s: float  # wall time of clustering + contraction


#: Max nc*nc for the dense packed-key dedupe histograms (at the limit: a 4M
#: int64 count histogram + a 4M float64 weight histogram = 64 MB transient).
_DENSE_DEDUPE_LIMIT = 1 << 22


def _use_dense_dedupe(nc: int, nnz: int) -> bool:
    """Whether contraction dedupes via the dense packed-key histogram.

    The histogram costs O(nc^2) regardless of nnz, so it only beats the
    O(nnz log nnz) stable argsort when the key space is dense relative to
    the edge count.  Measured crossover (numpy 2.x, one core): dense wins
    2-15x at ``nc^2/nnz <= ~3`` and loses from ~10 up — ``4 * nnz`` sits on
    the boundary.  Default V-cycle levels stop at 500+ vertices with sparse
    coarse graphs (ratio 10-700: always argsort); the dense path engages
    when callers coarsen far down (small ``coarsen_until`` / small k), where
    tiny-nc contractions dominate the level count.  Both paths group
    identically (keys ascending, weights summed in original edge order), so
    switching between them is invisible to the result — property- and
    unit-tested byte-identical.
    """
    return nc * nc <= min(_DENSE_DEDUPE_LIMIT, 4 * nnz)


class ClusterCoarsener:
    """Reusable cluster-coarsening engine with level-spanning scratch buffers."""

    def __init__(self) -> None:
        self._scratch: dict[str, np.ndarray] = {}

    def _buf(self, name: str, size: int, dtype) -> np.ndarray:
        """Uninitialized scratch array of at least ``size``, reused across
        levels (the finest level allocates the high-water mark)."""
        arr = self._scratch.get(name)
        if arr is None or arr.shape[0] < size or arr.dtype != np.dtype(dtype):
            arr = np.empty(size, dtype=dtype)
            self._scratch[name] = arr
        return arr[:size]

    # -- clustering --------------------------------------------------------

    def cluster_level(
        self,
        g: CSRGraph,
        rng: np.random.Generator,
        cluster_cap: float,
        rounds: int = 2,
        pinned: np.ndarray | None = None,
    ) -> np.ndarray:
        """One level of size-constrained clustering; returns root[v].

        ``root[v]`` is the vertex id of v's cluster root (``root[r] == r``
        for roots), ready for :meth:`contract_clusters`.  No cluster's total
        vertex weight exceeds ``cluster_cap`` beyond what a single fine
        vertex already weighs.

        ``pinned`` marks vertices that must survive contraction untouched
        (the local V-cycle's frozen-label anchor super-vertices): a pinned
        vertex never proposes and never accepts joiners, so it stays a
        singleton cluster rooted at itself through every round.
        """
        n = g.n
        if n == 0 or g.nnz == 0:
            return np.arange(n, dtype=np.int64)
        src, dst = g.coo_src, g.coo_dst
        row_first = run_first_mask(src)  # src nonempty: nnz == 0 returned above
        root = self._buf("root", n, np.int64)
        root[:] = np.arange(n, dtype=np.int64)
        cw = self._buf("cw", n, np.float64)
        cw[:] = g.vweights
        # Random rank: proposals only point to lower-rank targets, so the
        # pointer graph is a forest and pointer jumping terminates.
        rank = rng.permutation(n)
        # Multiplicative jitter decorrelates ties at any weight magnitude
        # (the ep-cloned path carries 1e9 original-edge weights).
        score_w = g.eweights * (1.0 + 1e-9 * rng.random(g.nnz))
        neg_inf = -np.inf
        for _ in range(max(1, rounds)):
            csize = np.bincount(root, minlength=n)
            singleton = csize == 1  # indexed by root id == the vertex itself
            tgt = root[dst]
            # Eligible proposal edges: singleton source, foreign target
            # cluster, joined weight under the cap.
            eligible = (
                singleton[src]
                & (tgt != src)
                & (cw[src] + cw[tgt] <= cluster_cap)
            )
            if pinned is not None:
                # Pinned vertices are always their own root, so pinned[tgt]
                # exactly marks proposals into a pinned cluster.
                eligible &= ~pinned[src] & ~pinned[tgt]
            if not eligible.any():
                break
            # Affinity: the jittered edge weight (classic heavy-edge).
            # Normalizing by target cluster weight (w / cw[tgt], KaMinPar
            # style) was measured and rejected: it buys ~2% cut on the mesh
            # family but costs 3-5% on banded/random/power-law graphs and
            # 20%+ on path-structured routing-affinity graphs, where it
            # pulls vertices off their natural cluster toward whatever is
            # lightest.  The size cap alone keeps growth spread out.
            score = np.where(eligible, score_w, neg_inf)
            row_best = segmented_max(score, row_first)
            is_best = eligible & (score == row_best)
            prop = self._buf("prop", n, np.int64)
            prop[:] = np.arange(n, dtype=np.int64)
            prop[src[is_best]] = tgt[is_best]  # one winner per row (last write)
            sc = self._buf("sc", n, np.float64)
            sc[:] = 0.0
            sc[src[is_best]] = score[is_best]
            # Direction rule: a proposal may target a non-proposing root
            # (stable cluster) freely, but a proposer->proposer pointer must
            # descend in rank — that breaks every potential cycle.
            proposing = prop != np.arange(n, dtype=np.int64)
            bad = proposing & proposing[prop] & (rank[prop] >= rank)
            prop[bad] = np.flatnonzero(bad)
            # Pointer-jump chains flat: root-assignment in O(log n) rounds
            # of whole-array gathers, no Python-scale loops.
            while True:
                nxt = prop[prop]
                if np.array_equal(nxt, prop):
                    break
                prop = nxt
            joiner = np.flatnonzero(prop != np.arange(n, dtype=np.int64))
            if joiner.size == 0:
                break
            jt = prop[joiner]
            # Cap admission: strongest joiners first per target cluster,
            # cumulative joiner weight against the round-start base weight.
            order = np.lexsort((-sc[joiner], jt))
            joiner, jt = joiner[order], jt[order]
            local = segmented_cumsum(cw[joiner], run_first_mask(jt))
            admit = cw[jt] + local <= cluster_cap
            joiner, jt = joiner[admit], jt[admit]
            if joiner.size == 0:
                break
            root[joiner] = jt
            np.add.at(cw, jt, cw[joiner])
        return root.copy()

    # -- contraction -------------------------------------------------------

    def contract_clusters(self, g: CSRGraph, root: np.ndarray) -> tuple[CSRGraph, np.ndarray]:
        """Contract an arbitrary fine->coarse root map; returns (coarse, cmap).

        ``root[v]`` may be any idempotent representative map
        (``root[root[v]] == root[v]``): matched pairs, multi-vertex clusters,
        or identity.  Coarse ids are the dense renumbering of the
        representatives in ascending order; ``cmap[v]`` is v's coarse id.
        Parallel coarse edges are deduped with summed weights; self-edges
        (intra-cluster) are dropped.
        """
        n = g.n
        present = self._buf("present", n, bool)
        present.fill(False)
        present[root] = True
        uniq = np.flatnonzero(present)
        nc = uniq.shape[0]
        lookup = self._buf("lookup", n, np.int64)
        lookup[uniq] = np.arange(nc, dtype=np.int64)
        cmap = lookup[root]
        src = cmap[g.coo_src]
        dst = cmap[g.coo_dst]
        w = g.eweights
        keep = src != dst
        src, dst, w = src[keep], dst[keep], w[keep]
        if src.size:
            key = src * nc + dst
            if _use_dense_dedupe(nc, src.size):
                # Dense histogram dedupe: one bincount over packed keys
                # replaces the full-nnz argsort.  Nonzero bins come out in
                # ascending key order with weights summed in original edge
                # order — byte-identical to the argsort path below.
                cnt = np.bincount(key, minlength=nc * nc)
                key_u = np.flatnonzero(cnt)  # presence by count, so a
                # zero-weight edge group survives exactly like it does below
                w = np.bincount(key, weights=w, minlength=nc * nc)[key_u]
                src = key_u // nc
                dst = key_u % nc
            else:
                order = np.argsort(key, kind="stable")
                key, src, dst, w = key[order], src[order], dst[order], w[order]
                uniq_mask = run_first_mask(key)
                seg = np.cumsum(uniq_mask) - 1
                w = np.bincount(seg, weights=w)
                src, dst = src[uniq_mask], dst[uniq_mask]
        indptr = np.zeros(nc + 1, dtype=np.int64)
        np.add.at(indptr, src + 1, 1)
        np.cumsum(indptr, out=indptr)
        vw = np.bincount(cmap, weights=g.vweights.astype(np.float64), minlength=nc)
        coarse = CSRGraph(
            indptr=indptr,
            indices=dst.astype(np.int32),
            eweights=w.astype(np.float64),
            vweights=vw.astype(np.int64),
        )
        return coarse, cmap


def contract_clusters(g: CSRGraph, root: np.ndarray) -> tuple[CSRGraph, np.ndarray]:
    """One-shot :meth:`ClusterCoarsener.contract_clusters` (no buffer reuse)."""
    return ClusterCoarsener().contract_clusters(g, root)
