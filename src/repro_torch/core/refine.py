# Copied verbatim from src/repro/core/refine.py; keep the two in step.
"""Shared batched-refinement engine (Jostle/parallel-FM style primitives).

Both refinement sweeps in this codebase — the full multilevel refiner
(`partition._refine`, vertex moves against an edge-cut objective) and the
incremental dirty-region sweep (`partition_service.incremental_repartition`,
task moves against the §3.1 vertex-cut objective) — run the same batched
move machinery: collect candidates, order them overweight-escapes-first then
by gain, and admit whole batches per destination part with cumulative-weight
prefix sums against the balance cap.  This module is that machinery, factored
out so the two callers only differ in *what* they score (vertex connectivity
rows vs. a dense task-incidence table) and *which* item subset they sweep
(every boundary vertex vs. the churn-dirty task set).

Primitives:

  * :func:`run_first_mask` / :func:`run_last_mask` — run boundaries of a
    sorted key array; the building block for every segmented reduction here.
  * :func:`segmented_cumsum` — inclusive prefix sums restarting per segment;
    the balance-cap admission test is ``part_weight + segmented_cumsum(w)``.
  * :func:`admit_batched_moves` — one whole refinement pass' admission:
    per-destination prefix-sum capping (phase A) plus rank-packed repair of
    overweight leftovers into the remaining room (phase B).
  * :func:`build_task_connectivity` / :func:`apply_task_moves` — the dense
    ``(n_relevant, k)`` task-incidence table over a compacted vertex index
    (one bincount over packed keys) and its incremental per-pass update,
    used by the dirty-region sweep.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "admit_batched_moves",
    "apply_task_moves",
    "build_task_connectivity",
    "project_majority_labels",
    "run_first_mask",
    "run_last_mask",
    "segmented_cumsum",
    "segmented_max",
]


def run_last_mask(keys: np.ndarray) -> np.ndarray:
    """Boolean mask marking the last element of each run of equal keys."""
    last = np.empty(keys.shape[0], dtype=bool)
    last[-1] = True
    np.not_equal(keys[:-1], keys[1:], out=last[:-1])
    return last


def run_first_mask(keys: np.ndarray) -> np.ndarray:
    """Boolean mask marking the first element of each run of equal keys."""
    first = np.empty(keys.shape[0], dtype=bool)
    first[0] = True
    np.not_equal(keys[1:], keys[:-1], out=first[1:])
    return first


def segmented_cumsum(values: np.ndarray, seg_first: np.ndarray) -> np.ndarray:
    """Inclusive prefix sum of ``values`` restarting where ``seg_first``."""
    cum = np.cumsum(values)
    seg_id = np.cumsum(seg_first) - 1
    base = (cum - values)[seg_first]
    return cum - base[seg_id]


def segmented_max(values: np.ndarray, seg_first: np.ndarray) -> np.ndarray:
    """Per-segment maximum, broadcast back to every element of the segment.

    One ``maximum.reduceat`` over the run starts — the segmented-argmax
    building block shared by heavy-edge matching (heaviest remaining
    neighbour per vertex) and cluster coarsening (best-affinity proposal
    per vertex): compare ``values == segmented_max(values, first)`` to mask
    each segment's winners.
    """
    starts = np.flatnonzero(seg_first)
    seg_max = np.maximum.reduceat(values, starts)
    return seg_max[np.cumsum(seg_first) - 1]


def project_majority_labels(
    cmap: np.ndarray,
    labels: np.ndarray,
    weights: np.ndarray,
    k: int,
    nc: int,
) -> np.ndarray:
    """Weight-majority label per coarse vertex — seeded re-initialization.

    ``cmap`` maps fine vertices to coarse ids, ``labels`` / ``weights`` are
    the fine labels and vertex weights; each coarse vertex takes the label
    holding the largest member weight (ties to the lowest part id, via the
    row argmax).  One bincount over packed ``coarse * k + label`` keys — the
    local V-cycle uses this instead of region growing to re-initialize each
    coarser level from the labels being repaired.
    """
    hist = np.bincount(
        cmap * np.int64(k) + labels, weights=weights, minlength=nc * k
    ).reshape(nc, k)
    return np.argmax(hist, axis=1)


def admit_batched_moves(
    cand: np.ndarray,
    gain: np.ndarray,
    dest: np.ndarray,
    cur: np.ndarray,
    weights: np.ndarray,
    part_weight: np.ndarray,
    cap: float,
    over_cand: np.ndarray,
) -> tuple[np.ndarray, np.ndarray]:
    """Admit one pass' worth of moves under the balance cap.

    ``cand`` holds item ids already in priority order (overweight escapes
    first, then descending gain); ``gain`` / ``dest`` / ``cur`` / ``weights``
    / ``over_cand`` are aligned with it (desired destination, current part,
    item weight, and whether the item sits in an overweight part).

    Phase A admits each item toward its desired destination, capped by a
    per-destination cumulative-weight prefix sum (stable sort keeps the
    priority order within each destination).  Phase B rank-packs the
    overweight leftovers into whatever room remains across parts
    (conservative: incoming weight from phase A counts, outgoing weight is
    ignored, so the cap can never be breached).

    Returns ``(mv, dst_p)``: the admitted item ids and their destinations.
    """
    k = int(part_weight.shape[0])
    order = np.argsort(dest, kind="stable")
    c2, d2, g2 = cand[order], dest[order], gain[order]
    w2, cur2, ov2 = weights[order], cur[order], over_cand[order]
    local = segmented_cumsum(w2, run_first_mask(d2)) if d2.size else w2
    admit = (part_weight[d2] + local <= cap) & (d2 != cur2)
    mv, dst_p = c2[admit], d2[admit]

    left_mask = ~admit & ov2
    if left_mask.any():
        incoming = np.bincount(dst_p, weights=w2[admit], minlength=k)
        pw_after = part_weight + incoming
        room = cap - pw_after
        targ = np.flatnonzero(room > 0)
        if targ.size:
            left, lw, lcur = c2[left_mask], w2[left_mask], cur2[left_mask]
            o = np.argsort(-g2[left_mask], kind="stable")
            left, lw, lcur = left[o], lw[o], lcur[o]
            torder = targ[np.argsort(pw_after[targ], kind="stable")]
            bounds = np.cumsum(room[torder])
            pos = np.cumsum(lw)
            rank = np.searchsorted(bounds, pos, side="left")
            fits = rank < torder.size
            bdest = np.where(fits, torder[np.minimum(rank, torder.size - 1)], -1)
            # Exact per-part re-check: an item straddling a room boundary
            # could overflow its slot — drop it this pass.
            ok = fits & (bdest != lcur)
            if ok.any():
                lcum = segmented_cumsum(lw, run_first_mask(bdest))
                ok &= pw_after[np.maximum(bdest, 0)] + lcum <= cap
            if ok.any():
                mv = np.concatenate([mv, left[ok]])
                dst_p = np.concatenate([dst_p, bdest[ok]])
    return mv, dst_p


def build_task_connectivity(
    rel_of: np.ndarray,
    u: np.ndarray,
    v: np.ndarray,
    labels: np.ndarray,
    k: int,
    n_rel: int,
) -> np.ndarray:
    """Dense ``(n_rel, k)`` task-incidence table over a compacted vertex index.

    ``table[rel_of[w], p]`` = number of tasks incident to vertex ``w`` that
    are assigned to part ``p`` (self-loops count once — a task contributes
    one incidence per *distinct* endpoint).  Only endpoints with
    ``rel_of >= 0`` (the relevant-vertex compaction) are counted; everything
    is one bincount over packed ``row * k + part`` keys.
    """
    loop = u == v
    ru, rv = rel_of[u], rel_of[v]
    mu, mv_ = ru >= 0, (rv >= 0) & ~loop
    keys = np.concatenate([(ru[mu] * k + labels[mu]), (rv[mv_] * k + labels[mv_])])
    return np.bincount(keys, minlength=n_rel * k).reshape(n_rel, k)


def apply_task_moves(
    table: np.ndarray,
    rel_of: np.ndarray,
    u: np.ndarray,
    v: np.ndarray,
    old_parts: np.ndarray,
    new_parts: np.ndarray,
) -> None:
    """Incrementally update the task-incidence table after a batch of moves.

    Each moved task (endpoints ``u[i]``, ``v[i]``) leaves ``old_parts[i]``
    and joins ``new_parts[i]``; only its (at most two distinct) endpoint rows
    change, so the per-pass cost is O(moved), not a table rebuild.
    """
    k = table.shape[1]
    loop = u == v
    rows = np.concatenate([rel_of[u], rel_of[v][~loop]])
    olds = np.concatenate([old_parts, old_parts[~loop]])
    news = np.concatenate([new_parts, new_parts[~loop]])
    flat = table.reshape(-1)
    np.subtract.at(flat, rows * k + olds, 1)
    np.add.at(flat, rows * k + news, 1)
