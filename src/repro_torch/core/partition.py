# Copied verbatim from src/repro/core/partition.py; keep the two in step.
"""Multilevel balanced k-way vertex partitioning — fully array-native.

The paper solves balanced *edge* partitioning by converting it into balanced
*vertex* partitioning (§3.2) and handing the converted graph to a multilevel
vertex partitioner (METIS).  METIS is not available offline, so this module
implements the same multilevel scheme from scratch, with every stage of the
hot path expressed as NumPy array programs (no Python-scale per-vertex or
per-edge loops — the cold-path cost the paper's §4.2 overlap has to hide is
exactly this code):

  1. **Coarsening** — size-constrained *cluster* coarsening (the
     ``coarsen.ClusterCoarsener`` engine): every still-singleton vertex
     proposes to join its heaviest-affinity neighbour's cluster (jittered
     heavy-edge affinity, capped by a cluster-size bound derived from the
     balance slack), proposals resolve by pointer-jumping
     to cluster roots, and admission is a score-ordered prefix sum per
     cluster — so one level contracts 3-8x instead of the <=2x a pairwise
     matching can, and the V-cycle reaches the coarsening target in ~4
     levels instead of 10+.  Contraction handles arbitrary fine->coarse
     maps, deduping parallel edges via a packed-key bincount when the
     coarse graph is small (no per-level full-nnz argsort).  Randomized
     heavy-edge matching (mutual-proposal rounds, segmented
     ``maximum.reduceat`` over the CSR-grouped edge list) survives as
     ``MultilevelOptions(coarsen_mode="matching")`` — the property-test
     reference the cluster engine is checked against.
  2. **Initial partitioning** — vectorized multi-source region growing on
     the coarsest graph: all k regions grow *simultaneously*, one vertex per
     part per round, chosen by a masked per-part argmax over a dense
     (k, n) connectivity table.  Conflicts (two parts claiming the same
     vertex) are resolved by a segment-max (lexsort + run-first mask) in
     favour of the strongest connection; empty parts are seeded from the
     highest-degree unassigned vertices, and grown parts whose frontier
     goes cold retire (stragglers are rank-packed into remaining room).
  3. **Uncoarsening + refinement** — project labels level by level and run
     *batched* boundary refinement (Jostle/parallel-FM style): per-vertex
     gains to the best external partition come from grouped connectivity
     tables; all candidate moves of a pass are admitted together, sorted by
     gain, with per-destination cumulative-weight prefix sums enforcing the
     balance cap, and applied as one fancy-index write.  The connectivity
     tables are **incremental across passes**: after a batch of moves, only
     the rows of moved vertices and their neighbours are recomputed (their
     tables are the only ones whose inputs changed, so this is exact, not
     approximate).

All stages read the graph's cached COO view (``CSRGraph.coo_src``) instead
of re-expanding ``indptr`` at every call site, and ``partition_vertices``
reports per-stage wall times (coarsen / init / refine) in
:class:`PartitionStats`.

The output satisfies the paper's balance requirement: max part weight is at
most ``(1 + eps) * ceil(total / k)`` (the paper observes balance factors
below 1.03 in practice; the refiner enforces the cap with dedicated batched
repair passes that drain overweight parts into the remaining room, and a
repair stage fixes any overflow introduced by projection).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from .coarsen import ClusterCoarsener, LevelStats
from .graph import CSRGraph
from .refine import (
    admit_batched_moves,
    project_majority_labels,
    run_first_mask,
    run_last_mask,
    segmented_cumsum,
    segmented_max,
)

__all__ = [
    "partition_vertices",
    "local_partition_vertices",
    "PartitionStats",
    "LocalVcycleStats",
    "MultilevelOptions",
]


@dataclasses.dataclass
class MultilevelOptions:
    """Knobs of the multilevel V-cycle.

    Coarsening knobs:

    * ``coarsen_mode`` — ``"cluster"`` (default) runs the size-constrained
      cluster-coarsening engine (3-8x contraction per level);
      ``"matching"`` runs pairwise randomized heavy-edge matching (<=2x per
      level), kept as the property-test reference.
    * ``cluster_rounds`` — proposal/admission rounds per cluster level; the
      first round grows clusters from singletons, later rounds let leftover
      singletons join the clusters formed before them.
    * ``cluster_cap_frac`` — cluster-size cap as a fraction of the part-
      weight cap ``(1+eps)*ceil(total/k)``.  Small enough that refinement
      can still rebalance the projected partition (a coarse vertex is an
      unsplittable move unit), large enough that coarsening reaches
      ``coarsen_until`` before stalling.
    * ``match_rounds`` — mutual-proposal rounds per matching level
      (``coarsen_mode="matching"`` only).
    """

    eps: float = 0.03  # balance slack
    # Stop coarsening below max(coarsen_until, coarsen_k_factor*k).  768
    # rather than the matching-era 512: cluster levels contract ~3x, so the
    # last level overshoots the threshold by that factor — stopping earlier
    # leaves the V-cycle a finer coarsest graph (richer refinement move
    # units) at the cost of one cheap extra init round.
    coarsen_until: int = 768
    coarsen_k_factor: int = 4
    match_rounds: int = 4
    refine_passes: int = 6
    coarsest_refine_passes: int = 10
    seed: int = 0
    max_levels: int = 40
    coarsen_mode: str = "cluster"  # "cluster" | "matching"
    cluster_rounds: int = 2
    cluster_cap_frac: float = 0.25

    def __post_init__(self) -> None:
        # Fail at construction, not three levels into the V-cycle: a
        # non-positive stop threshold loops forever, a cap fraction outside
        # (0, 1] makes every cluster ineligible (or unboundedly greedy), and
        # a negative k-factor silently disables the k-aware stop.
        if self.eps < 0:
            raise ValueError(f"eps must be >= 0, got {self.eps}")
        if self.coarsen_until <= 0:
            raise ValueError(
                f"coarsen_until must be > 0, got {self.coarsen_until}"
            )
        if not 0.0 < self.cluster_cap_frac <= 1.0:
            raise ValueError(
                f"cluster_cap_frac must be in (0, 1], got {self.cluster_cap_frac}"
            )
        if self.coarsen_k_factor < 0:
            raise ValueError(
                f"coarsen_k_factor must be >= 0, got {self.coarsen_k_factor}"
            )
        if self.coarsen_mode not in ("cluster", "matching"):
            raise ValueError(f"unknown coarsen_mode {self.coarsen_mode!r}")


@dataclasses.dataclass
class PartitionStats:
    levels: int
    coarsest_n: int
    edgecut: float
    balance: float
    # Per-stage wall times (seconds) of the cold path, for ServicePlan /
    # benchmark reporting.
    coarsen_s: float = 0.0
    init_s: float = 0.0
    refine_s: float = 0.0
    coarsen_mode: str = "cluster"
    # One LevelStats per V-cycle contraction (n, nnz, contraction ratio,
    # wall time) — the per-level breakdown behind coarsen_s.
    level_stats: list[LevelStats] = dataclasses.field(default_factory=list)


# ---------------------------------------------------------------------------
# Shared helpers
# ---------------------------------------------------------------------------


def _gather_adjacency(g: CSRGraph, vertices: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Flat CSR positions of the adjacency of ``vertices``.

    Returns ``(srcrep, flat)`` where ``flat`` indexes ``g.indices`` /
    ``g.eweights`` and ``srcrep[i]`` is the vertex owning slot ``flat[i]``.
    """
    counts = g.indptr[vertices + 1] - g.indptr[vertices]
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64)
    seg_ends = np.cumsum(counts)
    seg_starts = seg_ends - counts
    flat = (
        np.arange(total, dtype=np.int64)
        - np.repeat(seg_starts, counts)
        + np.repeat(g.indptr[vertices], counts)
    )
    srcrep = np.repeat(vertices, counts)
    return srcrep, flat


# Run-boundary masks and segmented prefix sums live in the shared batched-
# refinement engine (refine.py) now; the old underscore names stay bound for
# the historical call sites below.
_run_last_mask = run_last_mask
_run_first_mask = run_first_mask
_segmented_cumsum = segmented_cumsum


# ---------------------------------------------------------------------------
# Coarsening
# ---------------------------------------------------------------------------


def _heavy_edge_matching(g: CSRGraph, rng: np.random.Generator, rounds: int) -> np.ndarray:
    """Return match[v] = partner vertex (or v itself for singletons).

    No sorting at all: the CSR edge list is already grouped by source, and
    round-robin filtering preserves that grouping, so each mutual-proposal
    round reads the heaviest remaining neighbour with a segmented
    ``maximum.reduceat`` over the (jittered) weights.
    """
    n = g.n
    cur_src = g.coo_src
    cur_dst = g.coo_dst
    # Random tiebreak so repeated weights don't bias matching.
    cur_w = g.eweights + rng.random(g.nnz) * 1e-9
    match = np.arange(n, dtype=np.int64)
    unmatched = np.ones(n, dtype=bool)
    for _ in range(rounds):
        if cur_src.size == 0:
            break
        is_max = cur_w == segmented_max(cur_w, _run_first_mask(cur_src))
        prop = np.full(n, -1, dtype=np.int64)
        prop[cur_src[is_max]] = cur_dst[is_max]
        cand = np.flatnonzero(prop >= 0)
        mutual_cand = cand[(prop[prop[cand]] == cand) & (cand < prop[cand])]
        # (v, prop[v]) with v < prop[v] are accepted pairs.
        v = mutual_cand
        u = prop[mutual_cand]
        match[v] = u
        match[u] = v
        unmatched[v] = False
        unmatched[u] = False
        keep = unmatched[cur_src] & unmatched[cur_dst]
        cur_src, cur_dst, cur_w = cur_src[keep], cur_dst[keep], cur_w[keep]
    return match


def _contract(
    g: CSRGraph, match: np.ndarray, engine: ClusterCoarsener | None = None
) -> tuple[CSRGraph, np.ndarray]:
    """Contract matched pairs; return coarse graph and fine->coarse map.

    A matching is the two-vertex special case of a cluster map (root = the
    smaller endpoint), so this delegates to the engine's generalized
    ``contract_clusters`` — the packed-key dedupe there groups edges in the
    same ascending-key order with weights summed in original edge order, so
    the coarse graph is byte-identical to the historical pairwise version.
    """
    rep = np.minimum(np.arange(g.n, dtype=np.int64), match)
    return (engine or ClusterCoarsener()).contract_clusters(g, rep)


# ---------------------------------------------------------------------------
# Initial partitioning (coarsest level): vectorized multi-source growing
# ---------------------------------------------------------------------------


def _pack_stragglers(
    labels: np.ndarray, part_weight: np.ndarray, vw: np.ndarray, cap: float, k: int
) -> None:
    """Rank-pack unassigned vertices into the lightest parts, in place.

    Heaviest stragglers first, parts filled lightest-first by cumulative
    weight against the cap; anything beyond all remaining room round-robins
    over the lightest parts (the scalar fallback ignored the cap here too).
    """
    rest = np.flatnonzero(labels < 0)
    if rest.size == 0:
        return
    rest = rest[np.argsort(-vw[rest], kind="stable")]
    porder = np.argsort(part_weight, kind="stable")
    room = np.maximum(cap - part_weight[porder], 0.0)
    bounds = np.cumsum(room)
    pos = np.cumsum(vw[rest])
    rank = np.searchsorted(bounds, pos, side="left")
    fits = rank < k
    cand = rest[fits]
    dst = porder[rank[fits]]
    if cand.size:
        # Exact per-part re-check: a vertex straddling a room boundary
        # would overflow its slot — demote it to the spill instead.
        lcum = _segmented_cumsum(vw[cand], _run_first_mask(dst))
        ok = part_weight[dst] + lcum <= cap
        labels[cand[ok]] = dst[ok]
        spill = np.concatenate([cand[~ok], rest[~fits]])
    else:
        spill = rest[~fits]
    if spill.size:
        labels[spill] = porder[np.arange(spill.size) % k]
    np.add.at(part_weight, labels[rest], vw[rest])


#: Coarsest-graph size above which initial partitioning switches from the
#: dense one-vertex-per-part-per-round growth (O(n) rounds over a (k, n)
#: table — quadratic) to whole-frontier wave growth (O(diameter) rounds).
#: Only stalled coarsenings (random/power-law graphs) ever exceed this.
_WAVE_INIT_THRESHOLD = 16384


def _initial_partition_wave(
    g: CSRGraph, k: int, cap: float, rng: np.random.Generator
) -> np.ndarray:
    """Whole-frontier multi-source wave growth for large coarsest graphs.

    Every round, every unassigned vertex adjacent to a region joins the
    (non-full) region it connects to most strongly, admission bounded per
    part by a cumulative-weight prefix sum against the balance cap — so
    regions advance a full frontier ring per round and the round count is
    the graph diameter, not n.  Coarser-grained than the dense growth (used
    below ``_WAVE_INIT_THRESHOLD``) but memory is O(nnz) and runtime is
    rounds*O(boundary log boundary); refinement cleans the boundary after.
    """
    n = g.n
    labels = np.full(n, -1, dtype=np.int64)
    vw = g.vweights.astype(np.float64)
    target = float(vw.sum()) / k
    # Seeds: stride across the degree order spreads the sources.
    order = np.argsort(-g.degree(), kind="stable")
    seeds = order[:: max(1, n // k)][:k]
    labels[seeds] = np.arange(seeds.shape[0], dtype=np.int64)
    part_weight = np.zeros(k, dtype=np.float64)
    np.add.at(part_weight, labels[seeds], vw[seeds])
    while True:
        unas = np.flatnonzero(labels < 0)
        if unas.size == 0:
            break
        srcrep, flat = _gather_adjacency(g, unas)
        if flat.size == 0:
            break
        nb_part = labels[g.indices[flat].astype(np.int64)]
        ok = (nb_part >= 0) & (part_weight[np.maximum(nb_part, 0)] < target)
        if not ok.any():
            break
        s2, p2, w2 = srcrep[ok], nb_part[ok], g.eweights[flat][ok]
        # Strongest part per boundary vertex: group (vertex, part) sums,
        # then a per-vertex segment max.
        key = s2 * k + p2
        o = np.argsort(key, kind="stable")
        key_s = key[o]
        fm = _run_first_mask(key_s)
        conn_w = np.bincount(np.cumsum(fm) - 1, weights=w2[o])
        g_v = s2[o][fm]
        g_p = key_s[fm] % k
        o2 = np.lexsort((conn_w, g_v))
        last = _run_last_mask(g_v[o2])
        best_v = g_v[o2][last]
        best_p = g_p[o2][last]
        best_w = conn_w[o2][last]
        # Admit per part, strongest connections first, prefix-summed
        # against the growth target.
        adm_order = np.lexsort((-best_w, best_p))
        v3, p3 = best_v[adm_order], best_p[adm_order]
        local = _segmented_cumsum(vw[v3], _run_first_mask(p3))
        admit = part_weight[p3] + local <= cap  # cap >= target by construction
        v_ok, p_ok = v3[admit], p3[admit]
        if v_ok.size == 0:
            break
        labels[v_ok] = p_ok
        np.add.at(part_weight, p_ok, vw[v_ok])
    _pack_stragglers(labels, part_weight, vw, cap, k)
    return labels


def _initial_partition(g: CSRGraph, k: int, cap: float, rng: np.random.Generator) -> np.ndarray:
    """Grow all k regions simultaneously, one vertex per part per round.

    A dense (k, n) connectivity table scores every unassigned vertex against
    every growing region; each round every still-hungry part claims its
    argmax.  Conflicting claims go to the strongest connection (segment-max
    via lexsort).  Claims that would overflow the cap are permanently struck
    for that part (mirroring the scalar BFS's pop-without-assign); empty
    parts draw a fresh high-degree seed, and grown parts whose frontier
    went cold retire (the scalar BFS stopped there too).  Stragglers are
    rank-packed into the remaining room by cumulative weight.

    One vertex per part per round makes this quadratic in n, and the dense
    table is k*n floats — fine for a properly coarsened graph, ruinous when
    coarsening stalled early, so large graphs take the wave-growth path.
    """
    n = g.n
    if n > _WAVE_INIT_THRESHOLD or n * k > _DENSE_TABLE_LIMIT:
        return _initial_partition_wave(g, k, cap, rng)
    labels = np.full(n, -1, dtype=np.int64)
    vw = g.vweights.astype(np.float64)
    total = float(vw.sum())
    target = total / k
    part_weight = np.zeros(k, dtype=np.float64)
    # conn[p, v]: connectivity of unassigned v to region p; -inf marks
    # assigned vertices (whole column), cap-struck (p, v) pairs, and
    # finished parts (whole row) — so the per-round claim is one argmax
    # over the full table, no sub-copies.
    conn = np.zeros((k, n), dtype=np.float64)
    active = np.ones(k, dtype=bool)
    seed_order = np.argsort(-g.degree(), kind="stable")
    unassigned = n
    while unassigned > 0 and active.any():
        picks = np.argmax(conn, axis=1)
        vals = conn[np.arange(k), picks]
        vals[~active] = -np.inf
        # Parts with no positive connectivity: empty parts get a fresh
        # distinct high-degree seed; grown parts whose frontier went cold
        # are done (the scalar BFS stopped there too — stragglers are
        # packed at the end).
        cold = active & (vals <= 0.0)
        deactivated = False
        if cold.any():
            seedable = cold & (part_weight == 0.0)
            done = cold & ~seedable
            n_seed = int(seedable.sum())
            if n_seed:
                unas = seed_order[labels[seed_order] < 0]
                take = min(n_seed, unas.size)
                seed_rows = np.flatnonzero(seedable)
                picks[seed_rows[:take]] = unas[:take]
                vals[seed_rows[:take]] = np.inf  # a fresh seed wins its claim
                if take < n_seed:  # no vertices left to seed with
                    done[seed_rows[take:]] = True
            if done.any():
                active &= ~done
                conn[done] = -np.inf
                vals[done] = -np.inf
                deactivated = True
                if not active.any():
                    break
        claimants = np.flatnonzero(vals > 0.0)
        if claimants.size == 0:
            if not deactivated:
                break
            continue
        # Conflict resolution: one winner per claimed vertex, by strength.
        c_vals, c_picks = vals[claimants], picks[claimants]
        order = np.lexsort((-c_vals, c_picks))
        first = _run_first_mask(c_picks[order])
        win = order[first]
        p_win, v_win = claimants[win], c_picks[win]
        # Cap check: a claim that would overflow its part is struck for good.
        wv = vw[v_win]
        rej = (part_weight[p_win] + wv > cap) & (part_weight[p_win] > 0)
        if rej.any():
            conn[p_win[rej], v_win[rej]] = -np.inf
        p_ok, v_ok = p_win[~rej], v_win[~rej]
        if v_ok.size == 0:
            if not rej.any() and not deactivated:
                break  # no claims, no strikes: nothing can make progress
            continue
        labels[v_ok] = p_ok
        part_weight[p_ok] += vw[v_ok]
        unassigned -= int(v_ok.size)
        conn[:, v_ok] = -np.inf
        # Frontier update: credit each winner's adjacency to its region
        # (adding to -inf keeps assigned/struck entries excluded).
        _, flat = _gather_adjacency(g, v_ok)
        if flat.size:
            counts = g.indptr[v_ok + 1] - g.indptr[v_ok]
            prep = np.repeat(p_ok, counts)
            np.add.at(conn, (prep, g.indices[flat]), g.eweights[flat])
        active[part_weight >= target] = False
    _pack_stragglers(labels, part_weight, vw, cap, k)
    return labels


# ---------------------------------------------------------------------------
# Refinement: batched gain moves under a balance cap, incremental tables
# ---------------------------------------------------------------------------

#: Max n*k for the dense-bincount connectivity build (8M float64 = 64 MB).
_DENSE_TABLE_LIMIT = 1 << 23


def _update_connectivity_rows(
    g: CSRGraph,
    labels: np.ndarray,
    k: int,
    vertices: np.ndarray | None,
    own: np.ndarray,
    best_ext: np.ndarray,
    best_part: np.ndarray,
) -> None:
    """(Re)compute connectivity rows for ``vertices`` in place.

    ``own[v]`` = edge weight from v into its own part, ``best_ext[v]`` /
    ``best_part[v]`` = the strongest external part.  ``vertices=None`` means
    all rows (initial build, reading the cached COO view); otherwise only
    the given rows are touched — after a batch of moves only moved vertices
    and their neighbours have stale rows, so the per-pass cost is
    O(deg(dirty) log) instead of a full O(m log m) lexsort.
    """
    if vertices is None:
        n = g.n
        if n * k <= _DENSE_TABLE_LIMIT:
            # Dense path: one bincount over (vertex, part) keys replaces the
            # O(m log m) lexsort entirely; own/best-external fall out of a
            # row gather + row argmax.
            dense = np.bincount(
                g.coo_src * k + labels[g.coo_dst],
                weights=g.eweights,
                minlength=n * k,
            ).reshape(n, k)
            rows = np.arange(n)
            own[:] = dense[rows, labels]
            dense[rows, labels] = -1.0  # exclude own part from the argmax
            bp = np.argmax(dense, axis=1)
            best_part[:] = bp
            best_ext[:] = np.maximum(dense[rows, bp], 0.0)
            return
        srcrep, dst, w = g.coo_src, g.coo_dst, g.eweights
        own[:] = 0.0
        best_ext[:] = 0.0
        best_part[:] = labels
    else:
        srcrep, flat = _gather_adjacency(g, vertices)
        dst = g.indices[flat].astype(np.int64)
        w = g.eweights[flat]
        own[vertices] = 0.0
        best_ext[vertices] = 0.0
        best_part[vertices] = labels[vertices]
    if srcrep.size == 0:
        return
    key = srcrep * k + labels[dst]
    order = np.argsort(key, kind="stable")
    key_s, src_s, w_s = key[order], srcrep[order], w[order]
    uniq_mask = _run_first_mask(key_s)
    seg = np.cumsum(uniq_mask) - 1
    conn_w = np.bincount(seg, weights=w_s)  # (#groups,)
    g_src = src_s[uniq_mask]
    g_part = key_s[uniq_mask] % k
    is_own = g_part == labels[g_src]
    own[g_src[is_own]] = conn_w[is_own]
    ext = ~is_own
    if ext.any():
        es, ew_, ep = g_src[ext], conn_w[ext], g_part[ext]
        order2 = np.lexsort((ew_, es))
        es2 = es[order2]
        last = _run_last_mask(es2)
        best_ext[es2[last]] = ew_[order2][last]
        best_part[es2[last]] = ep[order2][last]


def _refine(
    g: CSRGraph,
    labels: np.ndarray,
    k: int,
    cap: float,
    passes: int,
    movable: np.ndarray | None = None,
) -> np.ndarray:
    """Batched boundary refinement with incremental connectivity tables.

    Each pass collects every candidate (positive gain, or any vertex inside
    an overweight part), orders them overweight-escapes-first then by gain,
    and admits moves per destination part with a cumulative-weight prefix
    sum against the cap — the whole batch lands in one fancy-index write.
    Overweight candidates whose best part has no room are rank-packed into
    whatever room remains across parts.  After ``passes`` gain passes, extra
    repair-only passes run until no part exceeds the cap (or no move can
    help), preserving the ``max <= (1+eps)*ceil(total/k)`` invariant.

    ``movable`` restricts candidacy to the marked vertices (the local
    V-cycle's dirty region: frozen-label anchor super-vertices still anchor
    every gain/connectivity computation but can never themselves move).
    """
    n = g.n
    vw = g.vweights.astype(np.float64)
    labels = labels.astype(np.int64).copy()
    part_weight = np.bincount(labels, weights=vw, minlength=k)
    own = np.zeros(n, dtype=np.float64)
    best_ext = np.zeros(n, dtype=np.float64)
    best_part = labels.copy()
    _update_connectivity_rows(g, labels, k, None, own, best_ext, best_part)
    tol = 1e-12
    max_repair = 2 * k + 8
    pass_i = 0
    while pass_i < passes + max_repair:
        pass_i += 1
        repair_only = pass_i > passes
        over = part_weight > cap
        if repair_only and not over.any():
            break
        gain = best_ext - own
        over_src = over[labels]
        cand_mask = over_src if repair_only else ((gain > tol) | over_src)
        if movable is not None:
            cand_mask = cand_mask & movable
        cand = np.flatnonzero(cand_mask)
        if cand.size == 0:
            break
        # Overweight escapes first (most negative pressure), then best gains;
        # the shared engine admits the pass (per-destination prefix-sum cap,
        # then rank-packed repair of overweight leftovers).
        cand = cand[np.lexsort((-gain[cand], ~over[labels[cand]]))]
        mv, dst_p = admit_batched_moves(
            cand,
            gain[cand],
            best_part[cand],
            labels[cand],
            vw[cand],
            part_weight,
            cap,
            over[labels[cand]],
        )

        if mv.size == 0:
            if repair_only:
                break
            pass_i = passes  # no gain moves left: skip straight to repair
            continue
        old = labels[mv]
        labels[mv] = dst_p
        part_weight += np.bincount(dst_p, weights=vw[mv], minlength=k)
        part_weight -= np.bincount(old, weights=vw[mv], minlength=k)
        # Incremental table update: only moved vertices and their
        # neighbours have stale rows.
        _, flat = _gather_adjacency(g, mv)
        dirty_mask = np.zeros(n, dtype=bool)
        dirty_mask[mv] = True
        dirty_mask[g.indices[flat]] = True
        dirty = np.flatnonzero(dirty_mask)
        _update_connectivity_rows(g, labels, k, dirty, own, best_ext, best_part)
    return labels


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------


def partition_vertices(
    g: CSRGraph, k: int, opts: MultilevelOptions | None = None
) -> tuple[np.ndarray, PartitionStats]:
    """Balanced k-way vertex partition of ``g``; returns (labels, stats)."""
    opts = opts or MultilevelOptions()
    if opts.coarsen_mode not in ("cluster", "matching"):
        raise ValueError(f"unknown coarsen_mode {opts.coarsen_mode!r}")
    rng = np.random.default_rng(opts.seed)
    n = g.n
    if k <= 1:
        return np.zeros(n, dtype=np.int32), PartitionStats(0, n, 0.0, 1.0)
    total = float(g.vweights.sum())
    cap = (1.0 + opts.eps) * np.ceil(total / k)

    # --- coarsen ---
    t0 = time.perf_counter()
    graphs = [g]
    maps: list[np.ndarray] = []
    level_stats: list[LevelStats] = []
    stop_n = max(opts.coarsen_until, opts.coarsen_k_factor * k)
    engine = ClusterCoarsener()
    # Cluster-size cap: a coarse vertex is an unsplittable refinement move,
    # so bound it by a fraction of the part-weight cap (the balance slack
    # refinement has to work with).
    cluster_cap = max(1.0, opts.cluster_cap_frac * cap)
    while graphs[-1].n > stop_n and len(graphs) <= opts.max_levels:
        cur = graphs[-1]
        lt0 = time.perf_counter()
        if opts.coarsen_mode == "cluster":
            root = engine.cluster_level(cur, rng, cluster_cap, opts.cluster_rounds)
            coarse, cmap = engine.contract_clusters(cur, root)
        else:
            match = _heavy_edge_matching(cur, rng, opts.match_rounds)
            coarse, cmap = _contract(cur, match, engine)
        if coarse.n > 0.9 * cur.n:  # stalled
            break
        level_stats.append(
            LevelStats(
                n=cur.n,
                nnz=cur.nnz,
                coarse_n=coarse.n,
                ratio=cur.n / max(coarse.n, 1),
                time_s=time.perf_counter() - lt0,
            )
        )
        graphs.append(coarse)
        maps.append(cmap)
    t1 = time.perf_counter()

    # --- initial partition on the coarsest graph ---
    coarsest = graphs[-1]
    labels = _initial_partition(coarsest, k, cap, rng)
    t2 = time.perf_counter()

    # --- refine coarsest, then uncoarsen + refine ---
    labels = _refine(coarsest, labels, k, cap, opts.coarsest_refine_passes)
    for level in range(len(maps) - 1, -1, -1):
        labels = labels[maps[level]]
        labels = _refine(graphs[level], labels, k, cap, opts.refine_passes)
    t3 = time.perf_counter()

    labels = labels.astype(np.int32)
    stats = PartitionStats(
        levels=len(graphs),
        coarsest_n=coarsest.n,
        edgecut=edgecut(g, labels),
        balance=balance_factor(g, labels, k),
        coarsen_s=t1 - t0,
        init_s=t2 - t1,
        refine_s=t3 - t2,
        coarsen_mode=opts.coarsen_mode,
        level_stats=level_stats,
    )
    return labels, stats


# ---------------------------------------------------------------------------
# Local V-cycle: re-coarsen only a dirty region, frozen labels pinned
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LocalVcycleStats:
    """Shape and wall times of one local V-cycle run."""

    n_dirty: int  # movable fine vertices (the dirty region)
    n_anchor: int  # frozen-label anchor super-vertices
    n_local: int  # local graph size: dirty + anchors
    levels: int  # graphs in the local V-cycle (including the local finest)
    moved: int  # dirty vertices whose label changed
    edgecut: float  # full-graph edge cut of the projected labels
    balance: float
    balance_ok: bool
    build_s: float = 0.0  # frozen-region contraction + seeding
    coarsen_s: float = 0.0
    refine_s: float = 0.0
    level_stats: list[LevelStats] = dataclasses.field(default_factory=list)


def _local_vcycle(
    local_g: CSRGraph,
    lab_local: np.ndarray,
    pinned: np.ndarray,
    k: int,
    cap: float,
    opts: MultilevelOptions,
    rng: np.random.Generator,
    engine: ClusterCoarsener | None = None,
) -> tuple[np.ndarray, int, list[LevelStats], float, float]:
    """Coarsen/seed/refine a prebuilt local graph; the V-cycle proper.

    ``local_g`` is the dirty subgraph plus frozen-label anchor vertices
    (``pinned``); ``lab_local`` seeds every vertex with its current part.
    Returns ``(labels, levels, level_stats, coarsen_s, refine_s)`` —
    ``labels`` at ``local_g``'s granularity, anchors unchanged.  Both
    :func:`local_partition_vertices` (which contracts the frozen region of
    a full graph first) and the service's ``local_repartition`` (which
    assembles the local graph directly from the churn batch) call this.
    """
    engine = engine or ClusterCoarsener()
    t0 = time.perf_counter()
    graphs = [local_g]
    maps: list[np.ndarray] = []
    pinneds = [pinned]
    level_stats: list[LevelStats] = []
    stop_n = max(opts.coarsen_until, opts.coarsen_k_factor * k)
    # Cluster cap scaled to the *movable* mass, not the global part cap: a
    # coarse vertex is an unsplittable move unit, and refinement here only
    # redistributes the dirty weight — clusters sized against the global cap
    # would be a large fraction of each part's movable share.
    movable_w = float(local_g.vweights[~pinned].sum())
    cluster_cap = max(
        1.0, opts.cluster_cap_frac * (1.0 + opts.eps) * np.ceil(movable_w / k)
    )
    while graphs[-1].n > stop_n and len(graphs) <= opts.max_levels:
        cur = graphs[-1]
        lt0 = time.perf_counter()
        root_l = engine.cluster_level(
            cur, rng, cluster_cap, opts.cluster_rounds, pinned=pinneds[-1]
        )
        coarse, cmap = engine.contract_clusters(cur, root_l)
        if coarse.n > 0.9 * cur.n:  # stalled
            break
        pc = np.zeros(coarse.n, dtype=bool)
        pc[cmap[np.flatnonzero(pinneds[-1])]] = True
        level_stats.append(
            LevelStats(
                n=cur.n,
                nnz=cur.nnz,
                coarse_n=coarse.n,
                ratio=cur.n / max(coarse.n, 1),
                time_s=time.perf_counter() - lt0,
            )
        )
        graphs.append(coarse)
        maps.append(cmap)
        pinneds.append(pc)
    t1 = time.perf_counter()

    # Seeded re-init at the coarsest, then refine every level up.
    lab = lab_local
    for i, cmap in enumerate(maps):
        lab = project_majority_labels(
            cmap, lab, graphs[i].vweights.astype(np.float64), k, graphs[i + 1].n
        )
    lab = _refine(
        graphs[-1], lab, k, cap, opts.coarsest_refine_passes, movable=~pinneds[-1]
    )
    for level in range(len(maps) - 1, -1, -1):
        lab = lab[maps[level]]
        lab = _refine(
            graphs[level], lab, k, cap, opts.refine_passes, movable=~pinneds[level]
        )
    t2 = time.perf_counter()
    return lab, len(graphs), level_stats, t1 - t0, t2 - t1


def local_partition_vertices(
    g: CSRGraph,
    labels: np.ndarray,
    dirty: np.ndarray,
    k: int,
    opts: MultilevelOptions | None = None,
) -> tuple[np.ndarray, LocalVcycleStats]:
    """Repartition only the ``dirty`` vertices of an already-labeled graph.

    The mid-churn gear between single-level incremental refinement and a
    full rebuild: labels outside the dirty region are *frozen* — the whole
    frozen region is contracted into one anchor super-vertex per part
    (carrying the part's frozen weight, so the global balance cap
    ``(1+eps)*ceil(total/k)`` applies unchanged to the local problem), and
    the dirty subgraph plus anchors runs a normal V-cycle: size-constrained
    cluster coarsening with the anchors pinned (they never merge), a seeded
    re-initialization (weight-majority label per cluster instead of region
    growing), and batched refinement at every level with moves restricted
    to non-anchor vertices.  The refined labels are projected back onto the
    dirty vertices; frozen labels are returned bit-for-bit unchanged.

    ``dirty`` with no set bit is a no-op returning the input labels; dirty
    everywhere degenerates to a full (seeded) V-cycle.  ``balance_ok`` is
    False when the frozen weight alone exceeds the cap somewhere — local
    moves cannot fix that, callers should escalate to a full rebuild.
    """
    opts = opts or MultilevelOptions()
    labels = np.asarray(labels, dtype=np.int64)
    dirty = np.asarray(dirty, dtype=bool)
    n = g.n
    if labels.shape[0] != n or dirty.shape[0] != n:
        raise ValueError("labels and dirty must have one entry per vertex")
    if k <= 1:
        return np.zeros(n, dtype=np.int32), LocalVcycleStats(
            0, 0, 0, 0, 0, 0.0, 1.0, True
        )
    if labels.size and (labels.min() < 0 or labels.max() >= k):
        raise ValueError(f"labels must be part ids in [0, {k})")
    total = float(g.vweights.sum())
    cap = (1.0 + opts.eps) * np.ceil(total / k)
    if not dirty.any():
        pw = np.bincount(labels, weights=g.vweights.astype(np.float64), minlength=k)
        return labels.astype(np.int32), LocalVcycleStats(
            n_dirty=0,
            n_anchor=0,
            n_local=0,
            levels=0,
            moved=0,
            edgecut=edgecut(g, labels),
            balance=balance_factor(g, labels, k),
            balance_ok=bool(pw.max() <= cap),
        )

    # --- build: contract the frozen region to per-part anchors ---
    t0 = time.perf_counter()
    rng = np.random.default_rng(opts.seed)
    engine = ClusterCoarsener()
    frozen_ids = np.flatnonzero(~dirty)
    # rep[p] = one frozen representative of part p (idempotent root: each
    # representative is itself frozen with label p, so root[rep[p]] == rep[p]).
    rep = np.full(k, -1, dtype=np.int64)
    rep[labels[frozen_ids]] = frozen_ids
    root = np.arange(n, dtype=np.int64)
    root[frozen_ids] = rep[labels[frozen_ids]]
    local_g, fmap = engine.contract_clusters(g, root)
    anchor_parts = np.flatnonzero(rep >= 0)
    n_anchor = int(anchor_parts.size)
    pinned = np.zeros(local_g.n, dtype=bool)
    pinned[fmap[rep[anchor_parts]]] = True
    # Every member of a cluster shares its part (frozen clusters are per-part
    # by construction, dirty vertices are singletons): a scatter is exact.
    lab_local = np.empty(local_g.n, dtype=np.int64)
    lab_local[fmap] = labels
    t1 = time.perf_counter()

    lab, levels, level_stats, coarsen_s, refine_s = _local_vcycle(
        local_g, lab_local, pinned, k, cap, opts, rng, engine
    )

    # --- project back; frozen labels stay bit-for-bit unchanged ---
    dirty_ids = np.flatnonzero(dirty)
    out = labels.copy()
    out[dirty_ids] = lab[fmap[dirty_ids]]
    out32 = out.astype(np.int32)
    pw = np.bincount(out, weights=g.vweights.astype(np.float64), minlength=k)
    stats = LocalVcycleStats(
        n_dirty=int(dirty_ids.size),
        n_anchor=n_anchor,
        n_local=int(local_g.n),
        levels=levels,
        moved=int((out[dirty_ids] != labels[dirty_ids]).sum()),
        edgecut=edgecut(g, out32),
        balance=balance_factor(g, out32, k),
        balance_ok=bool(pw.max() <= cap),
        build_s=t1 - t0,
        coarsen_s=coarsen_s,
        refine_s=refine_s,
        level_stats=level_stats,
    )
    return out32, stats


def edgecut(g: CSRGraph, labels: np.ndarray) -> float:
    cut = labels[g.coo_src] != labels[g.coo_dst]
    return float(g.eweights[cut].sum() / 2.0)  # both directions stored


def balance_factor(g: CSRGraph, labels: np.ndarray, k: int) -> float:
    pw = np.bincount(labels, weights=g.vweights.astype(np.float64), minlength=k)
    avg = g.vweights.sum() / k
    return float(pw.max() / avg) if avg > 0 else 1.0
