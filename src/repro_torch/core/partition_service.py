# Copied verbatim from src/repro/core/partition_service.py; keep the two in step.
"""Async partition service — the paper's CPU optimization thread (§4.2),
grown into a multi-tenant scheduling subsystem.

The paper's key systems design is that graph partitioning and data relayout
never block GPU compute: they run on *separate CPU optimization threads*,
and the kernel keeps executing under the old schedule until the new one is
ready, at which point the runtime atomically swaps it in.  This module is
the thin facade over that subsystem; the two halves live in their own
modules and are independently testable:

  * **Scheduling** (`plan_scheduler.PlanScheduler`) — an N-worker pool
    (thread or spawned-process executors) draining one priority queue, with
    request coalescing, cancellation, and a `ServiceMetrics` snapshot
    (queue depth, worker utilization, latency histograms).  Results are
    published with an atomic front/back `DoubleBuffer` swap so readers
    never observe a half-built plan — §4.2's async optimization thread.
  * **Caching** (`plan_cache.PlanCache` keyed by `graph_fingerprint`) —
    §4.2 amortizes one partitioning over many kernel launches on the same
    graph; in a serving system the same graph arrives from many requests
    *and tenants*, so plans are memoized under a cheap content hash with
    per-tenant byte budgets, cost-aware eviction
    (`compute_time_s / nbytes`: cheap-to-recompute plans go first),
    incremental-lineage pinning, and save/load persistence.
  * **Incremental repartition** (`incremental_repartition`) — §4.2's
    overhead-control argument only holds if re-optimization is cheap when
    the graph drifts.  For a small batch of edge insertions/deletions we
    keep the cached labeling, place new tasks in batched rounds by
    vertex-cut delta, and run *batched* boundary refinement over the dirty
    region only — driving the same shared engine (`refine.py`: gain-sorted
    candidates, per-destination prefix-sum admission, rank-packed repair)
    as the full multilevel refiner (`partition._refine`), over a dense
    ``(n_relevant, k)`` incidence table instead of the whole graph.  The
    pre-vectorization dict/set implementation survives as
    `incremental_repartition_reference`, the property-test oracle.  Between
    this single-level gear and a full rebuild sits `local_repartition`: a
    **local V-cycle** that freezes labels outside the churn-dirty region
    (plus a bounded halo), contracts the frozen region to per-part anchor
    super-vertices, and re-coarsens/refines only the dirty subgraph.  A
    drift-gated `GearPolicy` picks among the three gears per update from
    the accumulated churn fraction and each gear's own quality signal (the
    paper's adaptive overhead control, cf. `overhead.AdaptiveScheduler`).

Every plan carries the full `EdgePartitionResult` (labels + quality) and,
for SpMV-shaped requests, the `PackPlan` (§4.1 cpack layout), so kernels
can bind a service-supplied plan directly (`kernels.ops.make_ep_spmv_fn`).
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import os
import threading
import time
from typing import Optional

import numpy as np

from .edge_partition import EdgePartitionResult, edge_partition
from .graph import EdgeList, affinity_graph_from_coo, csr_from_edges
from .metrics import evaluate_edge_partition
from .partition import MultilevelOptions, _local_vcycle
from .plan_cache import PlanCache, TenantCacheStats
from .plan_scheduler import (
    AdmissionRejectedError,
    DeadlineShedError,
    PlanCancelledError,
    PlanScheduler,
    PlanTicket,
    ServiceClosedError,
    ServiceMetrics,
)
from .refine import (
    admit_batched_moves,
    apply_task_moves,
    build_task_connectivity,
    run_first_mask,
    segmented_cumsum,
)
from .reorder import PackPlan, build_pack_plan

__all__ = [
    "AdmissionRejectedError",
    "DeadlineShedError",
    "DoubleBuffer",
    "GearPolicy",
    "IncrementalStats",
    "PartitionService",
    "PlanCache",
    "PlanCancelledError",
    "PlanPadding",
    "PlanScheduler",
    "PlanTicket",
    "ServiceClosedError",
    "ServiceMetrics",
    "ServicePlan",
    "ServiceStats",
    "TenantCacheStats",
    "graph_fingerprint",
    "incremental_repartition",
    "incremental_repartition_reference",
    "local_repartition",
]


# ---------------------------------------------------------------------------
# Fingerprinting
# ---------------------------------------------------------------------------


def graph_fingerprint(
    edges: EdgeList,
    k: int,
    pad: int = 0,
    opts: MultilevelOptions | None = None,
    method: str = "ep",
    seed: int = 0,
    extra: tuple = (),
) -> str:
    """Cheap content hash identifying a partition request.

    Hashes (n, m, k, pad, method, seed, option fields, endpoint arrays) —
    O(m) bytes through blake2b, microseconds to milliseconds even for
    million-edge graphs, versus seconds for a multilevel run.  ``extra``
    lets SpMV requests mix in (n_rows, n_cols) so a bipartite affinity
    graph and a plain graph with identical arrays never collide.
    """
    h = hashlib.blake2b(digest_size=16)
    meta = (edges.n, edges.m, k, pad, method, seed) + tuple(extra)
    if opts is not None:
        meta = meta + dataclasses.astuple(opts)
    h.update(repr(meta).encode())
    h.update(np.ascontiguousarray(edges.u, dtype=np.int64).tobytes())
    h.update(np.ascontiguousarray(edges.v, dtype=np.int64).tobytes())
    return h.hexdigest()


def _multilevel_stage_times(stats) -> dict:
    """Flat ``{stage: seconds}`` entries derived from a PartitionStats.

    Strictly wall times — the V-cycle *shape* (level count, per-level
    records) travels separately via :func:`_vcycle_shape` into
    ``ServicePlan.vcycle``, so consumers summing or formatting
    ``stage_times_s`` values never meet a count or a list.
    """
    return {
        "coarsen": stats.coarsen_s,
        "init": stats.init_s,
        "refine": stats.refine_s,
    }


def _vcycle_shape(stats) -> dict:
    """ServicePlan.vcycle payload: the multilevel V-cycle's shape — level
    count, coarsest size, coarsen mode, and the per-level (n, nnz,
    contraction ratio, wall time) records — so serving dashboards see where
    the dominant cold stage spends its time without re-running anything."""
    return {
        "levels": stats.levels,
        "coarsest_n": stats.coarsest_n,
        "coarsen_mode": stats.coarsen_mode,
        "coarsen_levels": [dataclasses.asdict(ls) for ls in stats.level_stats],
    }


# ---------------------------------------------------------------------------
# Incremental repartition
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class IncrementalStats:
    m_old: int
    m_new: int
    n_inserted: int
    n_deleted: int
    n_dirty: int
    moves: int
    passes_run: int
    dirty_fraction: float
    balance: float
    balance_ok: bool
    time_s: float = 0.0
    # Per-stage wall times: dirty-region + table build / insertion placement
    # / dirty-region refinement (the pack stage is timed by the service).
    dirty_s: float = 0.0
    place_s: float = 0.0
    refine_s: float = 0.0
    # Which update gear produced this record ("incremental" | "local" —
    # the service overwrites it with the final policy decision, so an
    # escalated attempt reads as the gear that actually shipped), and the
    # drift estimate the policy gated on (base plan drift + churn fraction).
    gear: str = "incremental"
    drift: float = 0.0
    # Local V-cycle extras: frozen-region contraction + re-coarsening time
    # and the number of local levels (both 0 for the incremental gear).
    coarsen_s: float = 0.0
    levels: int = 0


def _count_key(v: int, p: int, k: int) -> int:
    return v * k + p


@dataclasses.dataclass
class _ChurnSetup:
    """Shared front half of both incremental implementations.

    The churned task list (kept order + insertions appended), the dirty task
    set, and the relevant-vertex mask — computed once, identically, so the
    batched pipeline and the scalar reference agree on every input.
    """

    m_old: int
    m_new: int
    n: int
    n_kept: int
    n_ins: int
    n_deleted: int
    u_all: np.ndarray
    v_all: np.ndarray
    lab_kept: np.ndarray
    insert_u: np.ndarray
    insert_v: np.ndarray
    dirty_idx: np.ndarray
    relevant: np.ndarray


def _churn_setup(
    edges: EdgeList,
    labels: np.ndarray,
    insert_u: np.ndarray | None,
    insert_v: np.ndarray | None,
    delete_ids: np.ndarray | None,
    dirty_degree_cap: int | None,
    need_relevant: bool = True,
) -> _ChurnSetup:
    insert_u = (
        np.asarray(insert_u, dtype=np.int64)
        if insert_u is not None
        else np.empty(0, dtype=np.int64)
    )
    insert_v = (
        np.asarray(insert_v, dtype=np.int64)
        if insert_v is not None
        else np.empty(0, dtype=np.int64)
    )
    if insert_u.shape != insert_v.shape:
        raise ValueError("insert_u/insert_v must have the same shape")
    n_ins = int(insert_u.shape[0])
    if n_ins and (int(insert_u.min()) < 0 or int(insert_v.min()) < 0):
        raise ValueError("insert endpoints must be non-negative vertex ids")
    labels = np.asarray(labels, dtype=np.int64)
    m_old = edges.m
    keep = np.ones(m_old, dtype=bool)
    n_deleted = 0
    touched = [insert_u, insert_v]
    if delete_ids is not None and len(delete_ids) > 0:
        delete_ids = np.asarray(delete_ids, dtype=np.int64)
        bad = (delete_ids < 0) | (delete_ids >= m_old)
        if bad.any():
            raise ValueError(
                f"delete_ids must be task indices in [0, {m_old}); got "
                f"{np.unique(delete_ids[bad])[:8].tolist()} — negative ids "
                "would silently wrap around, past-the-end ids are not tasks"
            )
        delete_ids = np.unique(delete_ids)
        keep[delete_ids] = False
        n_deleted = int(delete_ids.shape[0])
        touched += [
            edges.u[delete_ids].astype(np.int64),
            edges.v[delete_ids].astype(np.int64),
        ]
    u_all = np.concatenate([edges.u[keep].astype(np.int64), insert_u])
    v_all = np.concatenate([edges.v[keep].astype(np.int64), insert_v])
    n_kept = int(keep.sum())
    m_new = n_kept + n_ins
    n = max(edges.n, int(u_all.max(initial=-1)) + 1, int(v_all.max(initial=-1)) + 1)

    # Dirty region — it defines which vertices ever get queried, so the
    # incidence tables can be restricted to them (keeps the update cost
    # O(dirty-neighbourhood), not O(m)).  A churned *hub* vertex would mark
    # all of its (possibly thousands of) incident tasks dirty, making
    # "localized" refinement cost like a full pass — yet hubs are replicated
    # across most parts, so local moves around them almost never pay; tasks
    # are only marked dirty through touched vertices of degree <= cap.
    if not need_relevant:
        # The local gear derives its own (ring-based) dirty region and
        # incidence tables; skip the vertex-incident machinery entirely.
        return _ChurnSetup(
            m_old=m_old,
            m_new=m_new,
            n=n,
            n_kept=n_kept,
            n_ins=n_ins,
            n_deleted=n_deleted,
            u_all=u_all,
            v_all=v_all,
            lab_kept=labels[keep],
            insert_u=insert_u,
            insert_v=insert_v,
            dirty_idx=np.empty(0, dtype=np.int64),
            relevant=np.zeros(0, dtype=bool),
        )
    if dirty_degree_cap is None:
        avg_deg = 2.0 * m_new / max(n, 1)
        dirty_degree_cap = max(16, int(4 * avg_deg))
    t_arr = np.unique(np.concatenate(touched))
    if t_arr.size:
        deg = np.bincount(np.concatenate([u_all, v_all]), minlength=max(n, 1))
        t_capped = t_arr[deg[t_arr] <= dirty_degree_cap]
        is_touched = np.zeros(max(n, 1), dtype=bool)
        is_touched[t_capped] = True
        dirty_mask = is_touched[u_all] | is_touched[v_all]
    else:
        dirty_mask = np.zeros(m_new, dtype=bool)
    dirty_mask[n_kept:] = True  # inserted tasks always refine
    dirty_idx = np.flatnonzero(dirty_mask)

    relevant = np.zeros(max(n, 1), dtype=bool)
    relevant[u_all[dirty_mask]] = True
    relevant[v_all[dirty_mask]] = True
    relevant[t_arr] = True

    return _ChurnSetup(
        m_old=m_old,
        m_new=m_new,
        n=n,
        n_kept=n_kept,
        n_ins=n_ins,
        n_deleted=n_deleted,
        u_all=u_all,
        v_all=v_all,
        lab_kept=labels[keep],
        insert_u=insert_u,
        insert_v=insert_v,
        dirty_idx=dirty_idx,
        relevant=relevant,
    )


def _incremental_stats(
    cs: _ChurnSetup,
    k: int,
    sizes: np.ndarray,
    cap: float,
    moves: int,
    passes_run: int,
    t0: float,
    t1: float,
    t2: float,
    t3: float,
) -> IncrementalStats:
    avg = cs.m_new / k if k else 1.0
    return IncrementalStats(
        m_old=cs.m_old,
        m_new=cs.m_new,
        n_inserted=cs.n_ins,
        n_deleted=cs.n_deleted,
        n_dirty=int(cs.dirty_idx.shape[0]),
        moves=moves,
        passes_run=passes_run,
        dirty_fraction=(cs.n_ins + cs.n_deleted) / max(cs.m_new, 1),
        balance=float(sizes.max() / avg) if avg > 0 else 1.0,
        balance_ok=bool(sizes.max() <= cap),
        time_s=t3 - t0,
        dirty_s=t1 - t0,
        place_s=t2 - t1,
        refine_s=t3 - t2,
    )


def _place_insertions_batched(
    insert_u: np.ndarray,
    insert_v: np.ndarray,
    rel_of: np.ndarray,
    table: np.ndarray,
    sizes: np.ndarray,
    cap: float,
    k: int,
    m_new: int,
) -> np.ndarray:
    """Place all pending insertions in batched rounds; returns their labels.

    Each round scores every still-pending task against every part at once
    from the round-start snapshot of (table, sizes): vertex-cut delta via the
    dense incidence table, ties to the lightest part, then the lowest part
    id.  Claims are admitted per part in pending order with a prefix-count
    against the balance cap (exactly `_initial_partition`'s region-growing
    admission); unadmitted tasks retry next round against the updated state.
    The scalar reference mirrors these rounds item by item, which is what
    makes placement-only (``refine_passes=0``) runs byte-identical.
    """
    n_ins = int(insert_u.shape[0])
    new_labels = np.empty(n_ins, dtype=np.int64)
    if n_ins == 0:
        return new_labels
    pend = np.arange(n_ins, dtype=np.int64)
    # Composite lexicographic score (delta, sizes[p], p) packed into int64.
    w1 = np.int64((m_new + 1) * k)
    huge = np.int64(3) * w1
    part_ids = np.arange(k, dtype=np.int64)
    while pend.size:
        iu, iv = insert_u[pend], insert_v[pend]
        tu, tv = table[rel_of[iu]], table[rel_of[iv]]
        loop = iu == iv
        delta = (tu == 0).astype(np.int64) + ((~loop)[:, None] & (tv == 0))
        score = delta * w1 + sizes * np.int64(k) + part_ids
        score[:, sizes + 1 > cap] = huge
        claimed = np.argmin(score, axis=1)
        forced = score[np.arange(pend.size), claimed] >= huge
        if forced.any():  # no part under the cap — unreachable by the cap
            claimed[forced] = np.argmin(sizes)  # construction; kept as a valve
        order = np.argsort(claimed, kind="stable")  # pending order within part
        p_s = claimed[order]
        rank = segmented_cumsum(np.ones(p_s.size), run_first_mask(p_s))
        ok = forced[order] | (sizes[p_s] + rank <= cap)
        adm = order[ok]
        if adm.size == 0:  # safety valve, same shape as the scalar reference
            new_labels[pend[0]] = int(np.argmin(sizes))
            adm_p = new_labels[pend[:1]]
            ids = pend[:1]
        else:
            adm_p = claimed[adm]
            ids = pend[adm]
            new_labels[ids] = adm_p
        # Apply the round at its end — scores were against the snapshot.
        uu, vv = insert_u[ids], insert_v[ids]
        lp = uu == vv
        rows = np.concatenate([rel_of[uu], rel_of[vv][~lp]])
        parts = np.concatenate([adm_p, adm_p[~lp]])
        np.add.at(table.reshape(-1), rows * k + parts, 1)
        sizes += np.bincount(adm_p, minlength=k)
        sel = np.zeros(pend.size, dtype=bool)
        if adm.size == 0:
            sel[0] = True
        else:
            sel[adm] = True
        pend = pend[~sel]
    return new_labels


def _refine_dirty_batched(
    u_all: np.ndarray,
    v_all: np.ndarray,
    labels_all: np.ndarray,
    dirty_idx: np.ndarray,
    rel_of: np.ndarray,
    table: np.ndarray,
    sizes: np.ndarray,
    cap: float,
    k: int,
    passes: int,
) -> tuple[int, int]:
    """Whole-pass batched refinement of the dirty task set, in place.

    The task-side mirror of `partition._refine`: per pass, every dirty task
    scores all k destinations from the dense incidence table (replicas freed
    at the source minus replicas added at the destination), candidates are
    ordered overweight-escapes-first then by gain, and the shared engine
    admits the batch under the cap.  The table and sizes update
    incrementally — only moved tasks' endpoint rows change per pass.
    """
    moves = 0
    passes_run = 0
    de = dirty_idx
    if de.size == 0 or passes <= 0:
        return 0, 0
    du, dv = u_all[de], v_all[de]
    ru, rv = rel_of[du], rel_of[dv]
    loop = du == dv
    notloop_col = (~loop)[:, None]
    rows = np.arange(de.size)
    neg = np.int64(-100)  # sentinel far below any real gain (range [-2, 2])
    for _ in range(passes):
        passes_run += 1
        a = labels_all[de]
        tu, tv = table[ru], table[rv]
        freed = (tu[rows, a] == 1).astype(np.int64)
        freed += (~loop) & (tv[rows, a] == 1)
        gain = freed[:, None] - ((tu == 0).astype(np.int64) + (notloop_col & (tv == 0)))
        gain[rows, a] = neg
        full = sizes + 1 > cap
        if full.any():
            gain[:, full] = neg
        best_b = np.argmax(gain, axis=1)
        best_gain = gain[rows, best_b]
        over_row = (sizes > cap)[a]
        cand = np.flatnonzero((best_gain > 0) | (over_row & (best_gain > neg // 2)))
        if cand.size == 0:
            break
        cand = cand[np.lexsort((-best_gain[cand], ~over_row[cand]))]
        mv, dst = admit_batched_moves(
            de[cand],
            best_gain[cand].astype(np.float64),
            best_b[cand],
            a[cand],
            np.ones(cand.size),
            sizes.astype(np.float64),
            cap,
            over_row[cand],
        )
        if mv.size == 0:
            break
        old = labels_all[mv]
        labels_all[mv] = dst
        sizes += np.bincount(dst, minlength=k) - np.bincount(old, minlength=k)
        apply_task_moves(table, rel_of, u_all[mv], v_all[mv], old, dst)
        moves += int(mv.size)
    return moves, passes_run


def incremental_repartition(
    edges: EdgeList,
    labels: np.ndarray,
    k: int,
    insert_u: np.ndarray | None = None,
    insert_v: np.ndarray | None = None,
    delete_ids: np.ndarray | None = None,
    eps: float = 0.03,
    refine_passes: int = 3,
    slack: int = 1,
    dirty_degree_cap: int | None = None,
) -> tuple[EdgeList, np.ndarray, IncrementalStats]:
    """Repartition after a small edge-churn batch, touching only the dirty region.

    Returns ``(new_edges, new_labels, stats)`` where ``new_edges`` is the old
    task list minus ``delete_ids`` (order preserved) with insertions appended.
    Deleted tasks release their replicas; inserted tasks are placed in
    batched rounds in the part minimizing the vertex-cut delta (ties to the
    lightest part) under the cap ``(1+eps)*ceil(m_new/k) + slack``; then
    batched boundary refinement sweeps tasks incident to any churned vertex,
    admitting whole passes of positive-gain moves through the shared engine
    (`refine.admit_batched_moves`) — the same machinery the full multilevel
    refiner runs, restricted to the dirty task set.

    The pipeline is fully array-based: a dense ``(n_relevant, k)`` incidence
    table over a compacted index of relevant vertices (one bincount over
    packed keys) replaces the per-edge dict/set bookkeeping of
    :func:`incremental_repartition_reference`, which is retained as the
    scalar oracle — placement-only runs (``refine_passes=0``) produce
    byte-identical labels.

    ``delete_ids`` must be valid task indices in ``[0, edges.m)``; anything
    negative or past the end raises ``ValueError``.  ``dirty_degree_cap``
    bounds dirty-set expansion on skewed graphs (default:
    ``max(16, 4 * average_degree)``); inserted tasks are always refined.

    ``stats.balance_ok`` is False when the surviving distribution violates
    the cap (e.g. concentrated deletions shrank the target) — callers should
    fall back to a full run in that case, as `PartitionService.update` does.
    """
    t0 = time.perf_counter()
    cs = _churn_setup(edges, labels, insert_u, insert_v, delete_ids, dirty_degree_cap)
    cap = (1.0 + eps) * np.ceil(cs.m_new / k) + slack

    # Compacted relevant-vertex index + dense (n_rel, k) incidence table over
    # the kept labeling (one bincount over packed keys).
    rel_ids = np.flatnonzero(cs.relevant)
    rel_of = np.full(cs.relevant.shape[0], -1, dtype=np.int64)
    rel_of[rel_ids] = np.arange(rel_ids.size, dtype=np.int64)
    u_kept, v_kept = cs.u_all[: cs.n_kept], cs.v_all[: cs.n_kept]
    table = build_task_connectivity(rel_of, u_kept, v_kept, cs.lab_kept, k, rel_ids.size)
    sizes = np.bincount(cs.lab_kept, minlength=k).astype(np.int64)
    t1 = time.perf_counter()

    new_labels = _place_insertions_batched(
        cs.insert_u, cs.insert_v, rel_of, table, sizes, cap, k, cs.m_new
    )
    labels_all = np.concatenate([cs.lab_kept, new_labels])
    t2 = time.perf_counter()

    moves, passes_run = _refine_dirty_batched(
        cs.u_all, cs.v_all, labels_all, cs.dirty_idx, rel_of, table, sizes, cap, k, refine_passes
    )
    t3 = time.perf_counter()

    new_edges = EdgeList(n=cs.n, u=cs.u_all, v=cs.v_all)
    stats = _incremental_stats(cs, k, sizes, cap, moves, passes_run, t0, t1, t2, t3)
    return new_edges, labels_all.astype(np.int32), stats


def incremental_repartition_reference(
    edges: EdgeList,
    labels: np.ndarray,
    k: int,
    insert_u: np.ndarray | None = None,
    insert_v: np.ndarray | None = None,
    delete_ids: np.ndarray | None = None,
    eps: float = 0.03,
    refine_passes: int = 3,
    slack: int = 1,
    dirty_degree_cap: int | None = None,
) -> tuple[EdgeList, np.ndarray, IncrementalStats]:
    """Scalar oracle for :func:`incremental_repartition` (dict/set loops).

    Same contract and invariants as the batched pipeline: identical churned
    task list, balance cap respected, placement rounds item-for-item
    equivalent (so ``refine_passes=0`` labels are byte-identical).  The
    refinement loop applies moves one task at a time with immediate table
    updates — the pre-vectorization behaviour, kept as the property-test
    baseline for quality and balance.
    """
    t0 = time.perf_counter()
    cs = _churn_setup(edges, labels, insert_u, insert_v, delete_ids, dirty_degree_cap)
    cap = (1.0 + eps) * np.ceil(cs.m_new / k) + slack
    u_all, v_all, lab_kept = cs.u_all, cs.v_all, cs.lab_kept
    relevant, dirty_idx, n_ins = cs.relevant, cs.dirty_idx, cs.n_ins

    # Incidence tables over the kept labeling, for relevant vertices only:
    # cnt[v*k+p] = #incident tasks of v in part p (self-loops count once),
    # vparts[v] = parts with cnt>0.
    u_kept, v_kept = u_all[: cs.n_kept], v_all[: cs.n_kept]
    loop = u_kept == v_kept
    keys = np.concatenate(
        [
            (u_kept * k + lab_kept)[relevant[u_kept]],
            (v_kept * k + lab_kept)[relevant[v_kept] & ~loop],
        ]
    )
    uk, uc = np.unique(keys, return_counts=True)
    cnt: dict[int, int] = dict(zip(uk.tolist(), uc.tolist()))
    vparts: dict[int, set] = collections.defaultdict(set)
    for key in uk.tolist():
        vparts[key // k].add(key % k)
    sizes = np.bincount(lab_kept, minlength=k).astype(np.int64)

    def _add(uu: int, vv: int, p: int) -> None:
        for w in (uu,) if uu == vv else (uu, vv):
            key = _count_key(w, p, k)
            c = cnt.get(key, 0)
            cnt[key] = c + 1
            if c == 0:
                vparts[w].add(p)

    def _remove(uu: int, vv: int, p: int) -> None:
        for w in (uu,) if uu == vv else (uu, vv):
            key = _count_key(w, p, k)
            c = cnt[key] - 1
            if c == 0:
                del cnt[key]
                vparts[w].discard(p)
            else:
                cnt[key] = c

    t1 = time.perf_counter()

    # --- placement: the scalar mirror of `_place_insertions_batched`'s
    # rounds (min vertex-cut delta, tie lightest then lowest part; per-part
    # prefix-count admission against the round-start snapshot) ---
    insert_u, insert_v = cs.insert_u, cs.insert_v
    new_labels = np.empty(n_ins, dtype=np.int64)
    pending = list(range(n_ins))
    while pending:
        snap = sizes.copy()
        claim_count = [0] * k
        admitted: list[tuple[int, int]] = []
        for i in pending:
            uu, vv = int(insert_u[i]), int(insert_v[i])
            best_key, best_p = None, -1
            for p in range(k):
                if snap[p] + 1 > cap:
                    continue
                delta = (cnt.get(uu * k + p, 0) == 0) + (
                    0 if uu == vv else (cnt.get(vv * k + p, 0) == 0)
                )
                score = (delta, int(snap[p]), p)
                if best_key is None or score < best_key:
                    best_key, best_p = score, p
            forced = best_p < 0
            if forced:  # no part under the cap — unreachable, kept as a valve
                best_p = int(np.argmin(snap))
            claim_count[best_p] += 1
            if forced or snap[best_p] + claim_count[best_p] <= cap:
                admitted.append((i, best_p))
        if not admitted:  # safety valve, same shape as the batched engine
            admitted.append((pending[0], int(np.argmin(snap))))
        for i, p in admitted:
            uu, vv = int(insert_u[i]), int(insert_v[i])
            new_labels[i] = p
            _add(uu, vv, p)
            sizes[p] += 1
        done = {i for i, _ in admitted}
        pending = [i for i in pending if i not in done]

    labels_all = np.concatenate([lab_kept, new_labels])
    t2 = time.perf_counter()

    # --- localized boundary refinement over the dirty region only ---
    moves = 0
    passes_run = 0
    cnt_get = cnt.get
    cand_cap = 16  # a hub present in >cap parts contributes no candidates:
    # moving a task into one of the hub's many parts barely changes the
    # hub's replica count — the gain lives in the low-degree endpoint.
    for _ in range(refine_passes):
        passes_run += 1
        pass_moves = 0
        for e in dirty_idx:
            a = int(labels_all[e])
            uu, vv = int(u_all[e]), int(v_all[e])
            is_loop = uu == vv
            pu, pv = vparts[uu], vparts[vv]
            if len(pu) > cand_cap:
                cand = pv if len(pv) <= cand_cap else ()
            elif len(pv) > cand_cap:
                cand = pu
            else:
                cand = pu | pv
            over_a = sizes[a] > cap
            # Replicas freed by leaving part a — invariant over candidates.
            ua, va = uu * k + a, vv * k + a
            freed = (cnt_get(ua, 0) == 1) + (0 if is_loop else cnt_get(va, 0) == 1)
            best_b, best_gain = -1, 0
            for b in cand:
                if b == a or sizes[b] + 1 > cap:
                    continue
                added = (cnt_get(uu * k + b, 0) == 0) + (
                    0 if is_loop else cnt_get(vv * k + b, 0) == 0
                )
                gain = freed - added
                if gain > best_gain or (over_a and best_b < 0 and gain >= best_gain):
                    best_b, best_gain = b, gain
            if over_a and best_b < 0:
                b = int(np.argmin(sizes))
                if b != a and sizes[b] + 1 <= cap:
                    best_b = b
            if best_b >= 0 and (best_gain > 0 or over_a):
                _remove(uu, vv, a)
                _add(uu, vv, best_b)
                sizes[a] -= 1
                sizes[best_b] += 1
                labels_all[e] = best_b
                pass_moves += 1
        moves += pass_moves
        if pass_moves == 0:
            break
    t3 = time.perf_counter()

    new_edges = EdgeList(n=cs.n, u=u_all, v=v_all)
    stats = _incremental_stats(cs, k, sizes, cap, moves, passes_run, t0, t1, t2, t3)
    return new_edges, labels_all.astype(np.int32), stats


def local_repartition(
    edges: EdgeList,
    labels: np.ndarray,
    k: int,
    insert_u: np.ndarray | None = None,
    insert_v: np.ndarray | None = None,
    delete_ids: np.ndarray | None = None,
    eps: float = 0.03,
    opts: MultilevelOptions | None = None,
    seed: int = 0,
    halo_hops: int = 0,
    slack: int = 1,
    dirty_degree_cap: int | None = None,
    polish_passes: int | None = None,
) -> tuple[EdgeList, np.ndarray, IncrementalStats]:
    """Repartition after a churn batch by re-coarsening only the dirty region.

    The mid-churn gear between :func:`incremental_repartition` (single-level
    refinement, quality decays past ~1-2% churn) and a full rebuild (6-12x
    the work when most of the graph is untouched).  The churn front half is
    shared with the incremental path (`_churn_setup` + batched insertion
    placement); then a **local V-cycle** (:func:`partition._local_vcycle`)
    re-coarsens the dirty region of the method-"ep" task graph — one node
    per task, so task labels project back directly.  Labels outside the
    dirty region are frozen as per-part anchor super-vertices that pin the
    global balance cap; the dirty subgraph is re-coarsened with the anchors
    pinned, seeded from the current labels, and refined through the batched
    engine at every level.  A short vertex-cut polish
    (:func:`_refine_dirty_batched`, the incremental gear's sweep) runs last:
    the V-cycle optimizes the clone-graph edge cut, which only *bounds* the
    §3.1 vertex cut, and the direct sweep reliably claws back 5-15% of it.

    The dirty region is seeded from the churned tasks themselves — inserted
    tasks plus each deletion's ring scars (the former incidence-ring
    neighbours a deletion leaves newly adjacent) — then grown ``halo_hops``
    rings over the task graph, whose degree is ~4 (two ring neighbours per
    endpoint), so the region stays proportional to the churn batch.  The
    churn-setup's vertex-incident dirty set (right for the single-level
    sweep) is *not* used: every touched vertex would mark all of its
    incident tasks, so at 5% churn on a degree-20 graph it covers most of
    the task list and the "local" V-cycle degenerates into a full one.

    The local graph is assembled directly from the incidence-ring pair list
    (one stable argsort over the churned endpoints — the same ordering
    ``transform.contracted_clone_graph`` uses), never materializing the full
    task graph: ring-consecutive pairs with at least one dirty endpoint
    become local edges (frozen endpoints collapse to their part's anchor),
    frozen-frozen pairs are a constant of the optimization and are dropped.

    Returns ``(new_edges, new_labels, stats)`` with ``stats.gear ==
    "local"``.  ``stats.balance_ok`` False means the frozen weight alone
    breaks the cap — escalate to a full rebuild, as the service's gear
    policy does.
    """
    t0 = time.perf_counter()
    cs = _churn_setup(
        edges, labels, insert_u, insert_v, delete_ids, dirty_degree_cap,
        need_relevant=False,
    )
    cap = (1.0 + eps) * np.ceil(cs.m_new / k) + slack

    # Placement only queries the inserted endpoints' incidence rows, so the
    # table is restricted to them (not the churn-setup's full relevant set —
    # the polish sweep builds its own table over the final dirty region).
    rel_mask = np.zeros(max(cs.n, 1), dtype=bool)
    rel_mask[cs.insert_u] = True
    rel_mask[cs.insert_v] = True
    rel_ids = np.flatnonzero(rel_mask)
    rel_of = np.full(rel_mask.shape[0], -1, dtype=np.int64)
    rel_of[rel_ids] = np.arange(rel_ids.size, dtype=np.int64)
    u_kept, v_kept = cs.u_all[: cs.n_kept], cs.v_all[: cs.n_kept]
    table = build_task_connectivity(rel_of, u_kept, v_kept, cs.lab_kept, k, rel_ids.size)
    sizes = np.bincount(cs.lab_kept, minlength=k).astype(np.int64)
    t1 = time.perf_counter()

    new_labels = _place_insertions_batched(
        cs.insert_u, cs.insert_v, rel_of, table, sizes, cap, k, cs.m_new
    )
    labels_all = np.concatenate([cs.lab_kept, new_labels])
    t2 = time.perf_counter()

    # --- dirty region + new-ring pairs, from ONE old-ring argsort ---
    # The old clone list's stable argsort gives every vertex's incidence
    # ring.  Deleting a task deletes ring slots; kept clones stay in sorted
    # order (``old_to_new`` is monotone, parity is preserved), so the
    # churned ring is the kept slots MERGED with the (tiny, sorted) inserted
    # clone list via one searchsorted — no second full-size argsort.
    dirty_mask = np.zeros(cs.m_new, dtype=bool)
    dirty_mask[cs.n_kept:] = True
    clone_vertex = np.empty(2 * cs.m_old, dtype=np.int32)
    clone_vertex[0::2] = edges.u
    clone_vertex[1::2] = edges.v
    ring = np.argsort(clone_vertex, kind="stable")
    ring_vertex = clone_vertex[ring]
    ring_task = ring >> 1
    deleted = np.zeros(cs.m_old, dtype=bool)
    if cs.n_deleted:
        deleted[np.unique(np.asarray(delete_ids, dtype=np.int64))] = True
    old_to_new = np.cumsum(~deleted) - 1  # kept tasks keep their order
    if cs.n_deleted:
        # Ring scars: the surviving neighbours a deleted slot leaves newly
        # adjacent (consecutive deletions chain — both survivors still flank
        # some deleted slot, so both are caught here).
        del_slots = np.flatnonzero(deleted[ring_task])
        for off in (-1, 1):
            nb = del_slots + off
            ok = (nb >= 0) & (nb < ring.size)
            nb, slots = nb[ok], del_slots[ok]
            same = ring_vertex[nb] == ring_vertex[slots]
            scar = ring_task[nb[same]]
            scar = scar[~deleted[scar]]
            dirty_mask[old_to_new[scar]] = True

    kept_slot = ~deleted[ring_task]
    kept_vert = ring_vertex[kept_slot]
    kept_clone = (old_to_new[ring_task[kept_slot]] << 1) | (ring[kept_slot] & 1)
    if cs.n_ins:
        ins_vert = np.empty(2 * cs.n_ins, dtype=np.int32)
        ins_vert[0::2] = cs.insert_u
        ins_vert[1::2] = cs.insert_v
        io_ = np.argsort(ins_vert, kind="stable")
        # Inserted clone j is new clone 2*n_kept + j; inserted tasks sort
        # after every kept task of the same vertex (their ids are larger),
        # so side="right" keeps the merge stable.
        pos = np.searchsorted(kept_vert, ins_vert[io_], side="right")
        total = kept_vert.size + io_.size
        ins_at = pos + np.arange(io_.size, dtype=np.int64)
        kept_at = np.ones(total, dtype=bool)
        kept_at[ins_at] = False
        merged_vert = np.empty(total, dtype=np.int32)
        merged_clone = np.empty(total, dtype=np.int64)
        merged_vert[kept_at] = kept_vert
        merged_vert[ins_at] = ins_vert[io_]
        merged_clone[kept_at] = kept_clone
        merged_clone[ins_at] = 2 * cs.n_kept + io_
    else:
        merged_vert, merged_clone = kept_vert, kept_clone

    # Ring-consecutive pairs of the churned task list == task-graph edges.
    same_new = merged_vert[:-1] == merged_vert[1:]
    pa = merged_clone[:-1][same_new] >> 1
    pb = merged_clone[1:][same_new] >> 1
    for _ in range(max(0, halo_hops)):
        touch = dirty_mask[pa] | dirty_mask[pb]
        dirty_mask[pa[touch]] = True
        dirty_mask[pb[touch]] = True

    # --- assemble the local graph: dirty tasks + per-part anchors ---
    dirty_ids = np.flatnonzero(dirty_mask)
    nd = int(dirty_ids.size)
    frozen_count = np.bincount(labels_all[~dirty_mask], minlength=k)
    anchor_parts = np.flatnonzero(frozen_count > 0)
    n_anchor = int(anchor_parts.size)
    n_local = nd + n_anchor
    anchor_of = np.full(k, -1, dtype=np.int64)
    anchor_of[anchor_parts] = nd + np.arange(n_anchor, dtype=np.int64)
    task_local = np.empty(cs.m_new, dtype=np.int64)
    task_local[dirty_ids] = np.arange(nd, dtype=np.int64)
    task_local[~dirty_mask] = anchor_of[labels_all[~dirty_mask]]
    keep_pair = dirty_mask[pa] | dirty_mask[pb]
    vw = np.ones(n_local, dtype=np.int64)
    vw[nd:] = frozen_count[anchor_parts]
    # Parallel local edges are left as-is (dedupe=False): the refinement
    # tables and contraction histograms sum them exactly like a merged edge,
    # and the next coarsening level dedupes anyway.
    local_g = csr_from_edges(
        n_local, task_local[pa[keep_pair]], task_local[pb[keep_pair]],
        vweights=vw, dedupe=False,
    )
    pinned = np.zeros(n_local, dtype=bool)
    pinned[nd:] = True
    lab_local = np.empty(n_local, dtype=np.int64)
    lab_local[task_local] = labels_all  # anchors are per-part: scatter is exact
    t3 = time.perf_counter()

    # --- local V-cycle + vertex-cut polish over the dirty tasks ---
    # Lighter default pass counts than a cold build: the V-cycle starts from
    # an already-good seed and the vertex-cut polish below catches residue.
    vopts = (
        opts
        if opts is not None
        else MultilevelOptions(
            seed=seed, refine_passes=3, coarsest_refine_passes=5, cluster_rounds=1
        )
    )
    rng = np.random.default_rng(vopts.seed)
    before = labels_all[dirty_ids].copy()
    lab, levels, _level_stats, coarsen_s, _ref_s = _local_vcycle(
        local_g, lab_local, pinned, k, cap, vopts, rng
    )
    labels_all[dirty_ids] = lab[:nd]
    t4 = time.perf_counter()

    rel2 = np.zeros(max(cs.n, 1), dtype=bool)
    rel2[cs.u_all[dirty_mask]] = True
    rel2[cs.v_all[dirty_mask]] = True
    rel2_ids = np.flatnonzero(rel2)
    rel2_of = np.full(rel2.shape[0], -1, dtype=np.int64)
    rel2_of[rel2_ids] = np.arange(rel2_ids.size, dtype=np.int64)
    table2 = build_task_connectivity(
        rel2_of, cs.u_all, cs.v_all, labels_all, k, rel2_ids.size
    )
    sizes2 = np.bincount(labels_all, minlength=k).astype(np.int64)
    if polish_passes is None:
        # Small batches leave a near-optimal V-cycle seed — one sweep
        # converges; past ~6% churn the extra residue makes a second pass
        # pay for its candidate scan (measured on the bench graph family).
        churn_frac = (cs.n_ins + cs.n_deleted) / max(cs.m_new, 1)
        polish_passes = 1 if churn_frac <= 0.06 else 2
    pol_moves, pol_passes = _refine_dirty_batched(
        cs.u_all, cs.v_all, labels_all, dirty_ids, rel2_of, table2, sizes2,
        cap, k, polish_passes,
    )
    t5 = time.perf_counter()

    new_edges = EdgeList(n=cs.n, u=cs.u_all, v=cs.v_all)
    avg = cs.m_new / k if k else 1.0
    moved = int((labels_all[dirty_ids] != before).sum())
    stats = IncrementalStats(
        m_old=cs.m_old,
        m_new=cs.m_new,
        n_inserted=cs.n_ins,
        n_deleted=cs.n_deleted,
        n_dirty=nd,
        moves=moved,
        passes_run=int(pol_passes),
        dirty_fraction=(cs.n_ins + cs.n_deleted) / max(cs.m_new, 1),
        balance=float(sizes2.max() / avg) if avg > 0 else 1.0,
        balance_ok=bool(sizes2.max() <= cap),
        time_s=t5 - t0,
        dirty_s=(t1 - t0) + (t3 - t2),
        place_s=t2 - t1,
        refine_s=(t4 - t3 - coarsen_s) + (t5 - t4),
        gear="local",
        coarsen_s=coarsen_s,
        levels=levels,
    )
    return new_edges, labels_all.astype(np.int32), stats


# ---------------------------------------------------------------------------
# Gear policy: drift-gated choice of incremental / local / full
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GearPolicy:
    """Drift-gated selection among the three update gears.

    The drift estimate for an update is the base plan's accumulated drift
    (carried on ``ServicePlan.drift``: incremental updates inherit and grow
    it, local/full rebuilds reset it to 0) plus the batch's churn fraction —
    so a stream of small batches escalates exactly like one large batch.

    Thresholds are measured, not principled: on the bench graph families the
    incremental gear's cut tracks a rebuild to ~2% cumulative churn, and
    past ~15% the local gear's drift against a same-run rebuild climbs
    toward the quality ceiling while its speedup decays toward ~2x — the
    dirty region stops being "local" — so the top of the churn band goes to
    a full rebuild (see docs/serving.md, "Churn & repartition policy").
    Note the drift estimate for a pure-churn batch of rate r lands at
    ~r/(1 + r/2), not r (deletions do not grow ``m``), so the threshold is
    calibrated against the estimate, not the nominal rate.

    Quality escalation is independent of the thresholds: an incremental
    result whose cut grew past ``cut_growth_limit`` x the base plan's
    recorded cut (or broke balance) escalates to local; a local result that
    cannot restore balance (frozen weight alone over the cap) escalates to
    full.
    """

    incremental_max_drift: float = 0.02
    local_max_drift: float = 0.15
    cut_growth_limit: float = 1.10
    # Task-graph halo rings around the churn seed.  0 (seed only: inserted
    # tasks + deletion scars) measures fastest and the vertex-cut polish
    # recovers what a wider region would; raise it when churn is spatially
    # clustered and the repair needs room to move the surrounding boundary.
    halo_hops: int = 0

    def __post_init__(self) -> None:
        if not 0.0 <= self.incremental_max_drift <= self.local_max_drift:
            raise ValueError(
                "need 0 <= incremental_max_drift <= local_max_drift, got "
                f"{self.incremental_max_drift} / {self.local_max_drift}"
            )
        if self.cut_growth_limit < 1.0:
            raise ValueError(
                f"cut_growth_limit must be >= 1.0, got {self.cut_growth_limit}"
            )
        if self.halo_hops < 0:
            raise ValueError(f"halo_hops must be >= 0, got {self.halo_hops}")

    def pick(self, drift: float) -> str:
        if drift <= self.incremental_max_drift:
            return "incremental"
        if drift <= self.local_max_drift:
            return "local"
        return "full"


# ---------------------------------------------------------------------------
# Service plumbing: plans, double buffer, stats
# ---------------------------------------------------------------------------


def _payload_nbytes(obj) -> int:
    """Deterministic size estimate of a JSON-shaped stats payload.

    The plan cache's byte budgets must account for *everything* a cached
    plan pins, including the ``vcycle``/``stage_times_s`` dict payloads —
    a deep V-cycle's per-level records are real memory.  CPython object
    headers vary across builds, so this uses fixed per-node costs (close to
    64-bit CPython's) rather than ``sys.getsizeof``: the estimate must be
    stable for the eviction tests and the committed bench baselines.
    """
    if obj is None:
        return 0
    if isinstance(obj, (bool, int, float)):
        return 8
    if isinstance(obj, str):
        return 49 + len(obj)
    if isinstance(obj, np.ndarray):
        return int(obj.nbytes)
    if isinstance(obj, (list, tuple)):
        return 56 + sum(_payload_nbytes(x) for x in obj)
    if isinstance(obj, dict):
        return 64 + sum(
            _payload_nbytes(k) + _payload_nbytes(v) for k, v in obj.items()
        )
    return 48


@dataclasses.dataclass(frozen=True)
class PlanPadding:
    """Padded-shape metadata of a plan's cpack tiles (§4.1 layout).

    Everything the serve path's shape-bucketing needs to pick a compile
    bucket *without* touching the PackPlan arrays: the logical matrix dims,
    the true nnz, and the 128-aligned per-cluster tile ceilings.  Carried on
    :class:`ServicePlan` so bucket selection is O(1) per request.
    """

    pad: int
    k: int
    n_rows: int
    n_cols: int
    nnz: int
    e_max: int
    x_max: int
    y_max: int

    @classmethod
    def from_plan(cls, plan: PackPlan, pad: int) -> "PlanPadding":
        return cls(
            pad=pad,
            k=plan.k,
            n_rows=plan.n_rows,
            n_cols=plan.n_cols,
            nnz=int(plan.e_count.sum()),
            e_max=plan.e_max,
            x_max=plan.x_max,
            y_max=plan.y_max,
        )


@dataclasses.dataclass(frozen=True)
class ServicePlan:
    """One cached unit of partitioning work: labels (+ optional PackPlan)."""

    fingerprint: str
    result: EdgePartitionResult
    plan: Optional[PackPlan]
    edges: EdgeList
    source: str  # "full" | "incremental" | "local" — the gear that built it
    compute_time_s: float
    coo: Optional[tuple] = None  # (n_rows, n_cols, rows, cols) for SpMV plans
    # Padded-shape metadata of the PackPlan tiles (set iff plan is set) —
    # what the serve path's bucketed compilation keys on.
    padding: Optional[PlanPadding] = None
    # Per-stage wall times of the cold path (coarsen/init/refine/partition/
    # pack for full runs; incremental/pack for churn updates), so serving
    # dashboards see where compute_time_s goes.  Values are seconds, always.
    stage_times_s: Optional[dict] = None
    # V-cycle shape of a full multilevel run (levels, coarsest_n,
    # coarsen_mode, per-level records) — kept apart from stage_times_s so
    # that mapping stays a flat {stage: seconds}.
    vcycle: Optional[dict] = None
    # Base-plan fingerprint for incrementally-derived plans: the plan cache
    # refcounts these so a churn stream's base survives eviction.
    lineage: Optional[str] = None
    # Accumulated drift since the last multilevel pass over this graph:
    # incremental updates inherit the base's drift plus their churn
    # fraction; local and full rebuilds reset it to 0.  The gear policy
    # gates on it (see GearPolicy).
    drift: float = 0.0

    def nbytes(self) -> int:
        """Host-side bytes this plan pins — the unit of cache budgeting.

        Counts the labels, the task list, the PackPlan tiles, the COO
        arrays retained for SpMV re-pack, and the stats payloads
        (``stage_times_s``/``vcycle`` — the per-level V-cycle records grew
        real weight in PR 4 and budget accounting must see them).
        """
        b = self.result.labels.nbytes + self.edges.u.nbytes + self.edges.v.nbytes
        if self.plan is not None:
            b += self.plan.nbytes()
        if self.coo is not None:
            _, _, rows, cols = self.coo
            b += getattr(rows, "nbytes", 8) + getattr(cols, "nbytes", 8)
        b += _payload_nbytes(self.stage_times_s) + _payload_nbytes(self.vcycle)
        return b


class DoubleBuffer:
    """Two-slot atomic handoff: the compute path reads ``current()`` while the
    optimization thread builds into the back slot and ``publish``es with a
    front/back swap — the §4.2 schedule-swap, no torn reads, no locks held
    during compute."""

    def __init__(self) -> None:
        self._slots: list[Optional[ServicePlan]] = [None, None]
        self._front = 0
        self._generation = 0
        self._lock = threading.Lock()

    def publish(self, value: ServicePlan) -> int:
        with self._lock:
            back = 1 - self._front
            self._slots[back] = value
            self._front = back
            self._generation += 1
            return self._generation

    def current(self) -> tuple[Optional[ServicePlan], int]:
        with self._lock:
            return self._slots[self._front], self._generation


@dataclasses.dataclass
class ServiceStats:
    hits: int = 0
    misses: int = 0
    full_runs: int = 0
    incremental_runs: int = 0
    local_runs: int = 0
    # Updates whose chosen gear escalated on its own quality signal
    # (incremental -> local on cut growth / balance, local -> full on
    # unrecoverable balance).
    incremental_fallbacks: int = 0
    evictions: int = 0
    lookup_time_s: float = 0.0
    compute_time_s: float = 0.0


# ---------------------------------------------------------------------------
# Worker jobs — module-level pure functions over picklable request records,
# so the scheduler's process executor can ship them to spawned workers (the
# GIL serializes CPU-bound numpy across threads; real cold-plan parallelism
# needs processes).  All service-state side effects (stats, cache, memo)
# happen in the facade's on_done callbacks, never here.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _FullRequest:
    fingerprint: str
    edges: EdgeList
    k: int
    method: str
    opts: MultilevelOptions | None
    seed: int
    pad: int
    coo: Optional[tuple]


def _full_plan_job(req: _FullRequest) -> tuple[ServicePlan, dict]:
    t0 = time.perf_counter()
    result = edge_partition(req.edges, req.k, method=req.method, opts=req.opts, seed=req.seed)
    t_part = time.perf_counter() - t0
    plan = None
    padding = None
    if req.coo is not None:
        n_rows, n_cols, rows, cols = req.coo
        plan = build_pack_plan(n_rows, n_cols, rows, cols, result.labels, req.k, pad=req.pad)
        padding = PlanPadding.from_plan(plan, req.pad)
    dt = time.perf_counter() - t0
    stage_times = {"partition": t_part, "pack": dt - t_part}
    vcycle = None
    if result.stats is not None:
        stage_times.update(_multilevel_stage_times(result.stats))
        vcycle = _vcycle_shape(result.stats)
    sp = ServicePlan(
        fingerprint=req.fingerprint,
        result=result,
        plan=plan,
        edges=req.edges,
        source="full",
        compute_time_s=dt,
        coo=req.coo,
        padding=padding,
        stage_times_s=stage_times,
        vcycle=vcycle,
    )
    return sp, {"kind": "full"}


@dataclasses.dataclass
class _UpdateRequest:
    churn_key: str
    base: ServicePlan
    k: int
    insert_u: np.ndarray
    insert_v: np.ndarray
    delete_ids: np.ndarray
    pad: int
    method: str
    opts: MultilevelOptions | None
    seed: int
    eps: float
    policy: GearPolicy
    refine_passes: int


def _update_plan_job(req: _UpdateRequest) -> tuple[ServicePlan, dict]:
    t0 = time.perf_counter()
    base = req.base
    policy = req.policy
    insert_u, insert_v, delete_ids = req.insert_u, req.insert_v, req.delete_ids
    n_churn = len(insert_u) + len(delete_ids)
    m_new_est = max(base.edges.m + n_churn, 1)
    # Drift estimate: the base plan's accumulated drift (0.0 on plans from
    # before the field existed, via getattr) plus this batch's churn
    # fraction — a stream of small batches escalates like one big batch.
    drift_est = float(getattr(base, "drift", 0.0)) + n_churn / m_new_est
    gear = policy.pick(drift_est)
    if gear == "local" and req.method != "ep":
        # The local V-cycle runs on the method-"ep" task graph (node == task);
        # other methods have no such identification, so they skip the gear.
        gear = "full"
    new_edges, labels, inc = None, None, None
    result = None
    escalated = False
    gear_times: dict = {}
    stage_times: dict = {}
    vcycle = None
    base_cut = float(base.result.quality.vertex_cut)

    if gear == "incremental":
        tg = time.perf_counter()
        new_edges, labels, inc = incremental_repartition(
            base.edges,
            base.result.labels,
            req.k,
            insert_u=insert_u,
            insert_v=insert_v,
            delete_ids=delete_ids,
            eps=req.eps,
            refine_passes=req.refine_passes,
        )
        quality = evaluate_edge_partition(new_edges, labels, req.k)
        gear_times["incremental"] = time.perf_counter() - tg
        # The incremental path's own quality signal: cut delta vs. the base
        # plan's recorded cut, and the balance invariant.
        cut_ok = quality.vertex_cut <= policy.cut_growth_limit * max(base_cut, 1.0)
        if inc.balance_ok and cut_ok:
            result = EdgePartitionResult(
                labels=labels,
                k=req.k,
                method=f"{req.method}+incremental",
                quality=quality,
                partition_time_s=inc.time_s,
            )
            stage_times["incremental"] = inc.time_s
            stage_times.update(
                inc_dirty=inc.dirty_s,
                inc_place=inc.place_s,
                inc_refine=inc.refine_s,
            )
        else:
            gear = "local" if req.method == "ep" else "full"
            escalated = True

    if result is None and gear == "local":
        tg = time.perf_counter()
        new_edges, labels, inc = local_repartition(
            base.edges,
            base.result.labels,
            req.k,
            insert_u=insert_u,
            insert_v=insert_v,
            delete_ids=delete_ids,
            eps=req.eps,
            opts=req.opts,
            seed=req.seed,
            halo_hops=policy.halo_hops,
        )
        gear_times["local"] = time.perf_counter() - tg
        if inc.balance_ok:
            quality = evaluate_edge_partition(new_edges, labels, req.k)
            result = EdgePartitionResult(
                labels=labels,
                k=req.k,
                method=f"{req.method}+local",
                quality=quality,
                partition_time_s=inc.time_s,
            )
            stage_times["local"] = inc.time_s
            stage_times.update(
                loc_dirty=inc.dirty_s,
                loc_place=inc.place_s,
                loc_coarsen=inc.coarsen_s,
                loc_refine=inc.refine_s,
            )
        else:
            gear = "full"
            escalated = True

    if result is None:
        gear = "full"
        tg = time.perf_counter()
        if new_edges is None:
            new_edges, labels, _ = incremental_repartition(
                base.edges,
                base.result.labels,
                req.k,
                insert_u=insert_u,
                insert_v=insert_v,
                delete_ids=delete_ids,
                eps=req.eps,
                refine_passes=0,
            )
        result = edge_partition(new_edges, req.k, method=req.method, opts=req.opts, seed=req.seed)
        labels = result.labels
        gear_times["full"] = time.perf_counter() - tg
        stage_times["partition"] = result.partition_time_s
        if result.stats is not None:
            stage_times.update(_multilevel_stage_times(result.stats))
            vcycle = _vcycle_shape(result.stats)

    source = gear
    # Per-gear wall times of every gear *attempted* this update (an
    # escalated attempt's cost is real and shows up here), plus the final
    # decision on the stats record.
    for gname, gt in gear_times.items():
        stage_times[f"gear_{gname}"] = gt
    if inc is not None:
        inc.gear = source
        inc.drift = drift_est
    plan = None
    coo = None
    padding = None
    t_pack0 = time.perf_counter()
    if base.coo is not None:
        n_rows, n_cols, _, _ = base.coo
        # Affinity convention: u = column vertex, v = n_cols + row.
        rows = (new_edges.v - n_cols).astype(np.int64)
        cols = new_edges.u.astype(np.int64)
        coo = (n_rows, n_cols, rows, cols)
        plan = build_pack_plan(n_rows, n_cols, rows, cols, labels, req.k, pad=req.pad)
        padding = PlanPadding.from_plan(plan, req.pad)
    stage_times["pack"] = time.perf_counter() - t_pack0
    # Content fingerprint of the post-churn graph — hashed here on the
    # worker so the request path stays O(churn), not O(m).
    extra = (base.coo[0], base.coo[1]) if base.coo is not None else ()
    fingerprint = graph_fingerprint(
        new_edges, req.k, req.pad, req.opts, req.method, req.seed, extra
    )
    dt = time.perf_counter() - t0
    sp = ServicePlan(
        fingerprint=fingerprint,
        result=result,
        plan=plan,
        edges=new_edges,
        source=source,
        compute_time_s=dt,
        coo=coo,
        padding=padding,
        stage_times_s=stage_times,
        vcycle=vcycle,
        lineage=base.fingerprint if source in ("incremental", "local") else None,
        # Incremental updates accumulate drift; local and full rebuilds ran
        # a (local) V-cycle over everything that drifted, so they reset it.
        drift=drift_est if source == "incremental" else 0.0,
    )
    return sp, {
        "kind": "update",
        "source": source,
        "fallback": escalated,
        "churn_key": req.churn_key,
    }


# ---------------------------------------------------------------------------
# The service facade
# ---------------------------------------------------------------------------


class PartitionService:
    """Thin facade: `PlanScheduler` (workers) + `PlanCache` (tenant budgets).

    Synchronous fast path: ``get``/``get_spmv_plan`` return a cached plan in
    O(fingerprint) time on a warm hit; on a miss the request is computed on
    the worker pool (callers block on the ticket — use ``submit`` /
    ``update_async`` to overlap with compute, per §4.2).  Every request may
    carry ``tenant=`` (cache accounting + budget isolation) and
    ``priority=`` (queue ordering; higher first).

    ``workers``/``executor`` size the pool: the default single thread
    matches PR 1's behavior; ``executor="process"`` buys real cold-plan
    parallelism for multi-worker pools (partitioning is CPU-bound and the
    GIL serializes threads).  ``persist_path`` warms the cache from a prior
    snapshot at construction and saves it on ``close()``.
    """

    def __init__(
        self,
        max_entries: int = 64,
        max_bytes: int | None = None,
        eps: float = 0.03,
        churn_threshold: float = 0.15,
        refine_passes: int = 3,
        gear_policy: GearPolicy | None = None,
        default_opts: MultilevelOptions | None = None,
        start: bool = True,
        workers: int = 1,
        executor: str = "thread",
        tenant_budgets: dict[str, int] | None = None,
        default_tenant_budget: int | None = None,
        persist_path: str | None = None,
        max_pinned_bases: int = 16,
        max_queue_depth: int | None = None,
        tenant_weights: dict[str, float] | None = None,
    ) -> None:
        self.max_entries = max_entries
        self.max_bytes = max_bytes
        self.eps = eps
        self.churn_threshold = churn_threshold
        self.refine_passes = refine_passes
        # Gear selection for plan updates.  ``churn_threshold`` survives as
        # the shorthand knob: it bounds the *cheap* gears from above (drift
        # past it -> full rebuild), exactly its historical meaning, with the
        # incremental/local split handled by the policy's inner threshold.
        self.gear_policy = gear_policy or GearPolicy(
            incremental_max_drift=min(
                GearPolicy.incremental_max_drift, churn_threshold
            ),
            local_max_drift=churn_threshold,
        )
        self.default_opts = default_opts
        self.persist_path = persist_path
        self.stats = ServiceStats()
        self._cache = PlanCache(
            max_entries=max_entries,
            max_bytes=max_bytes,
            tenant_budgets=tenant_budgets,
            default_tenant_budget=default_tenant_budget,
        )
        self._sched = PlanScheduler(
            workers=workers, executor=executor, name="partition-service",
            max_queue_depth=max_queue_depth, tenant_weights=tenant_weights,
        )
        # churn-request key -> content fingerprint of the resulting plan, so
        # a repeated identical update is a cache hit without re-applying the
        # churn (the request key is O(churn) to compute, see update_async).
        self._churn_memo: collections.OrderedDict[str, str] = collections.OrderedDict()
        # LRU of churn-stream anchors currently pinned in the cache (see
        # update_async): bounds pin accumulation at max_pinned_bases — an
        # active stream refreshes its anchor every update, a dead stream's
        # anchor expires once enough newer anchors appear.
        self.max_pinned_bases = max_pinned_bases
        self._pinned_bases: collections.OrderedDict[str, None] = collections.OrderedDict()
        self._lock = threading.RLock()
        self._closed = False
        if persist_path and os.path.exists(persist_path):
            self._cache.load(persist_path)
            self._adopt_restored_pins()
        if start:
            self.start()

    def _adopt_restored_pins(self) -> None:
        """Fold pins restored from a snapshot into the bounded anchor LRU,
        so a dead stream's pin ages out after a restart exactly as it would
        have in the original process (instead of becoming immortal)."""
        with self._lock:
            for fp in self._cache.pinned_fingerprints():
                self._pinned_bases[fp] = None
                self._pinned_bases.move_to_end(fp)
            while len(self._pinned_bases) > self.max_pinned_bases:
                expired, _ = self._pinned_bases.popitem(last=False)
                self._cache.unpin(expired)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        """Start (or, after ``close()``, reopen) the worker pool."""
        with self._lock:
            self._closed = False
        self._sched.start()

    def close(self) -> None:
        """Idempotent, drain-safe shutdown: queued tickets fail with
        :class:`ServiceClosedError`, in-flight work completes, the cache is
        snapshotted to ``persist_path`` (when set), and a second ``close()``
        is a no-op."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._sched.close()
        if self.persist_path:
            self._cache.save(self.persist_path)

    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def plan_cache(self) -> PlanCache:
        """The underlying plan cache — read/write access for replication:
        ``ReplicaGroup``'s anti-entropy pump copies shared-store entries in
        through it so a warm hit on any replica is a warm hit on all."""
        return self._cache

    @property
    def scheduler(self) -> PlanScheduler:
        """The underlying scheduler — exposed for fault injection seams
        (``pre_job_hook``) and replica-level metrics."""
        return self._sched

    def __enter__(self) -> "PartitionService":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- cache surface -----------------------------------------------------

    def lookup(self, fingerprint: str, tenant: str = "default") -> Optional[ServicePlan]:
        """Warm-path cache probe: O(1) dict hit, no partitioning."""
        t0 = time.perf_counter()
        plan = self._cache.get(fingerprint, tenant)
        with self._lock:
            if plan is not None:
                self.stats.hits += 1
            self.stats.lookup_time_s += time.perf_counter() - t0
        return plan

    def __len__(self) -> int:
        return len(self._cache)

    def unpin_plan(self, fingerprint: str) -> bool:
        """Release a churn stream's base-plan pin (see ``update_async``).
        Call when a stream ends and its base graph will not be updated
        again; the entry then competes for cache space normally."""
        with self._lock:
            self._pinned_bases.pop(fingerprint, None)
            return self._cache.unpin(fingerprint)

    def save_cache(self, path: str | None = None) -> int:
        """Snapshot the plan cache (defaults to ``persist_path``); returns
        the number of entries written."""
        path = path or self.persist_path
        if not path:
            raise ValueError("no path given and no persist_path configured")
        return self._cache.save(path)

    def load_cache(self, path: str | None = None) -> int:
        """Restore a cache snapshot (defaults to ``persist_path``); returns
        the number of entries admitted under the configured budgets."""
        path = path or self.persist_path
        if not path:
            raise ValueError("no path given and no persist_path configured")
        n = self._cache.load(path)
        self._adopt_restored_pins()
        return n

    def metrics(self) -> ServiceMetrics:
        """One ServiceMetrics snapshot: scheduler state (queue depth, worker
        utilization, latency histograms) merged with the cache's per-tenant
        hit/miss/eviction/bytes counters."""
        snap = self._sched.metrics_snapshot()
        for tenant, st in self._cache.tenant_stats().items():
            d = snap.tenants.setdefault(tenant, {})
            d.update(
                hits=st.hits,
                misses=st.misses,
                evictions=st.evictions,
                entries=st.entries,
                bytes=st.bytes,
                budget_bytes=st.budget_bytes,
            )
        return snap

    # -- completion callbacks (dispatcher thread, before ticket resolve) ----

    def _on_full_done(self, value: tuple, ticket: PlanTicket) -> ServicePlan:
        plan, _ = value
        with self._lock:
            self.stats.full_runs += 1
            self.stats.compute_time_s += plan.compute_time_s
            self.stats.evictions += self._cache.put(plan, tenant=ticket.tenant)
        return plan

    def _on_update_done(self, value: tuple, ticket: PlanTicket) -> ServicePlan:
        plan, info = value
        with self._lock:
            if info["source"] == "incremental":
                self.stats.incremental_runs += 1
            elif info["source"] == "local":
                self.stats.local_runs += 1
            else:
                self.stats.full_runs += 1
            if info["fallback"]:
                self.stats.incremental_fallbacks += 1
            self.stats.compute_time_s += plan.compute_time_s
            self._churn_memo[info["churn_key"]] = plan.fingerprint
            while len(self._churn_memo) > 4 * self.max_entries:
                self._churn_memo.popitem(last=False)
            self.stats.evictions += self._cache.put(plan, tenant=ticket.tenant)
        return plan

    # -- full partition requests -------------------------------------------

    def submit(
        self,
        edges: EdgeList,
        k: int,
        method: str = "ep",
        opts: MultilevelOptions | None = None,
        seed: int = 0,
        pad: int = 128,
        coo: Optional[tuple] = None,
        buffer: DoubleBuffer | None = None,
        tenant: str = "default",
        priority: int = 0,
        timeout: float | None = None,
    ) -> PlanTicket:
        """Async request: returns a ticket immediately; cache hits resolve at
        once (and publish to ``buffer``); misses are queued by ``priority``
        and computed on the worker pool (identical concurrent requests
        coalesce onto one computation).

        ``timeout`` is the end-to-end deadline budget: it bounds the
        caller's ``ticket.result(timeout)`` wait *and* rides into the
        scheduler as an absolute deadline, so a queued job whose
        p50-predicted service time no longer fits its remaining budget is
        shed (:class:`DeadlineShedError`) instead of occupying a worker.
        With a bounded scheduler (``max_queue_depth``), an over-share
        submit raises :class:`AdmissionRejectedError` carrying a
        ``retry_after_s`` hint."""
        opts = opts if opts is not None else self.default_opts
        extra = (coo[0], coo[1]) if coo is not None else ()
        fingerprint = graph_fingerprint(edges, k, pad, opts, method, seed, extra)
        deadline = time.perf_counter() + timeout if timeout is not None else None
        with self._lock:
            # Hit/miss decided under the lock: a dispatcher finishing the
            # same fingerprint blocks on this lock in on_done, so its job
            # stays visible to the scheduler for coalescing until the plan
            # is in the cache — no rerun race.
            cached = self._cache.get(fingerprint, tenant)
            if cached is not None:
                self.stats.hits += 1
                ticket = PlanTicket(tenant=tenant, priority=priority)
                ticket.cache_hit = True
            else:
                req = _FullRequest(fingerprint, edges, k, method, opts, seed, pad, coo)
                ticket, created = self._sched.submit(
                    fingerprint,
                    _full_plan_job,
                    (req,),
                    priority=priority,
                    tenant=tenant,
                    buffer=buffer,
                    on_done=self._on_full_done,
                    deadline=deadline,
                )
                if created:
                    self._cache.record_miss(tenant)
                    self.stats.misses += 1
                return ticket
        if buffer is not None:
            buffer.publish(cached)
        ticket._resolve(cached)
        return ticket

    def get(
        self,
        edges: EdgeList,
        k: int,
        method: str = "ep",
        opts: MultilevelOptions | None = None,
        seed: int = 0,
        pad: int = 128,
        coo: Optional[tuple] = None,
        timeout: float | None = None,
        tenant: str = "default",
        priority: int = 0,
    ) -> ServicePlan:
        """Sync request: warm hit returns the cached plan object; cold blocks
        until a worker finishes."""
        return self.submit(
            edges, k, method=method, opts=opts, seed=seed, pad=pad, coo=coo,
            tenant=tenant, priority=priority, timeout=timeout,
        ).result(timeout)

    def get_spmv_plan(
        self,
        n_rows: int,
        n_cols: int,
        rows: np.ndarray,
        cols: np.ndarray,
        k: int,
        method: str = "ep",
        opts: MultilevelOptions | None = None,
        seed: int = 0,
        pad: int = 128,
        timeout: float | None = None,
        tenant: str = "default",
        priority: int = 0,
    ) -> ServicePlan:
        """SpMV request path: affinity graph from COO + a PackPlan (§4.1)."""
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        edges = affinity_graph_from_coo(n_rows, n_cols, rows, cols)
        return self.get(
            edges,
            k,
            method=method,
            opts=opts,
            seed=seed,
            pad=pad,
            coo=(n_rows, n_cols, rows, cols),
            timeout=timeout,
            tenant=tenant,
            priority=priority,
        )

    # -- incremental updates -----------------------------------------------

    def update_async(
        self,
        base_fingerprint: str,
        k: int,
        insert_u: np.ndarray | None = None,
        insert_v: np.ndarray | None = None,
        delete_ids: np.ndarray | None = None,
        method: str = "ep",
        opts: MultilevelOptions | None = None,
        seed: int = 0,
        pad: int = 128,
        buffer: DoubleBuffer | None = None,
        tenant: str = "default",
        priority: int = 0,
        timeout: float | None = None,
    ) -> PlanTicket:
        """Apply an edge-churn batch to a cached plan, off the request path.

        The serving loop keeps using the old plan (e.g. via ``buffer``) until
        the updated plan is published — the paper's overlap of optimization
        with compute.  The update gear is drift-gated (``gear_policy``):
        small accumulated drift runs single-level incremental refinement,
        the mid-range re-coarsens only the dirty region through a local
        V-cycle (:func:`local_repartition`), heavy drift — or a cheap gear's
        own quality signal (cut growth vs. the base plan's recorded cut,
        balance breakage) — escalates to a full multilevel rebuild.  The
        decision ships on ``ServicePlan.source``/``drift`` and the per-gear
        ``gear_*`` entries of ``stage_times_s``.

        The request path is O(churn): the request is identified by
        ``(base fingerprint, churn batch)``; applying the churn and hashing
        the resulting graph happen on a worker.  A repeated identical
        update hits the cache through the churn memo.  The base plan is
        *pinned* in the cache while it is used as an update base: a churn
        stream's anchor must survive eviction even when every derived plan
        is cheap to recompute.  Pins are bounded by an LRU of
        ``max_pinned_bases`` anchors (each update refreshes its base's
        slot, so active streams never expire; dead streams' pins age out),
        and ``unpin_plan`` releases an anchor explicitly when a stream
        ends.

        Raises ``KeyError`` when the base plan has been evicted — the
        churn alone cannot reconstruct the graph, so callers that retain
        only a fingerprint must treat this as "cache cold" and resubmit the
        full graph via ``submit``/``get`` (sizing the budgets to the
        working set, plus the pinning above, avoids it).
        """
        base = self._cache.peek(base_fingerprint)
        if base is None:
            raise KeyError(
                f"no cached plan for fingerprint {base_fingerprint!r} "
                "(evicted or never computed); resubmit the full graph"
            )
        self._cache.touch(base_fingerprint)
        with self._lock:
            # Pin the stream's anchor, bounded: the pinned-anchor set is an
            # LRU of at most max_pinned_bases fingerprints, so dead streams
            # cannot leak immortal pins that starve the owner's budget,
            # while every actively-updated base stays protected (each
            # update refreshes its anchor's recency here).
            self._cache.pin(base_fingerprint)
            self._pinned_bases[base_fingerprint] = None
            self._pinned_bases.move_to_end(base_fingerprint)
            while len(self._pinned_bases) > self.max_pinned_bases:
                expired, _ = self._pinned_bases.popitem(last=False)
                self._cache.unpin(expired)
        opts = opts if opts is not None else self.default_opts
        iu = np.asarray(insert_u, dtype=np.int64) if insert_u is not None else np.empty(0, np.int64)
        iv = np.asarray(insert_v, dtype=np.int64) if insert_v is not None else np.empty(0, np.int64)
        dele = (
            np.unique(np.asarray(delete_ids, dtype=np.int64))
            if delete_ids is not None and len(delete_ids) > 0
            else np.empty(0, np.int64)
        )
        h = hashlib.blake2b(digest_size=16)
        meta = (base_fingerprint, k, pad, method, seed)
        if opts is not None:
            meta = meta + dataclasses.astuple(opts)
        h.update(repr(meta).encode())
        h.update(iu.tobytes())
        h.update(iv.tobytes())
        h.update(dele.tobytes())
        churn_key = "churn-" + h.hexdigest()
        deadline = time.perf_counter() + timeout if timeout is not None else None
        with self._lock:
            known_fp = self._churn_memo.get(churn_key)
            cached = self._cache.get(known_fp, tenant) if known_fp is not None else None
            if cached is not None:
                self.stats.hits += 1
                ticket = PlanTicket(tenant=tenant, priority=priority)
                ticket.cache_hit = True
            else:
                req = _UpdateRequest(
                    churn_key, base, k, iu, iv, dele, pad, method, opts, seed,
                    self.eps, self.gear_policy, self.refine_passes,
                )
                ticket, created = self._sched.submit(
                    churn_key,
                    _update_plan_job,
                    (req,),
                    priority=priority,
                    tenant=tenant,
                    buffer=buffer,
                    on_done=self._on_update_done,
                    deadline=deadline,
                )
                if created:
                    self._cache.record_miss(tenant)
                    self.stats.misses += 1
                return ticket
        if buffer is not None:
            buffer.publish(cached)
        ticket._resolve(cached)
        return ticket

    def update(
        self,
        base_fingerprint: str,
        k: int,
        insert_u: np.ndarray | None = None,
        insert_v: np.ndarray | None = None,
        delete_ids: np.ndarray | None = None,
        method: str = "ep",
        opts: MultilevelOptions | None = None,
        seed: int = 0,
        pad: int = 128,
        timeout: float | None = None,
        tenant: str = "default",
        priority: int = 0,
    ) -> ServicePlan:
        """Sync wrapper over ``update_async``."""
        return self.update_async(
            base_fingerprint,
            k,
            insert_u=insert_u,
            insert_v=insert_v,
            delete_ids=delete_ids,
            method=method,
            opts=opts,
            seed=seed,
            pad=pad,
            tenant=tenant,
            priority=priority,
            timeout=timeout,
        ).result(timeout)
