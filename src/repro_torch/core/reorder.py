# Copied from src/repro/core/reorder.py, plus PackPlan.from_arrays; keep the two in step.
"""Data layout transformation (paper §4.1) — cpack + kernel pack plan.

After edge partitioning, the paper reorganizes tasks among thread blocks and
reorders the data layout with the cpack algorithm (consecutive packing: data
objects are laid out in first-touch order of the scheduled tasks), so each
thread block loads a *contiguous* segment into its software cache.

The TPU analogue: each Pallas grid cell p owns

  * a packed task tile   (vals, local x index, local y index)  — E_max slots
  * a packed input tile  x[x_gidx[p]]                          — X_max slots
  * a packed output tile scattered back via y_gidx[p]          — Y_max slots

Cut vertices are *replicated* across the segments that use them; the number
of replicas is exactly p_v, so total packed input size = n_touched + C —
the vertex-cut cost C is the physical redundancy of the layout, which is
what makes the model's cost function the real memory-traffic count.

``build_pack_plan`` is fully vectorized — no per-partition Python loop, no
dict-based id remapping.  One stable argsort groups tasks by partition;
one global sort over ``(partition, object)`` keys finds each partition's
distinct objects together with their *first-touch position*, and a second
sort by ``(partition, first_touch)`` turns those groups into cpack ranks.
Every task's local slot is then a single gather through the group-id array,
and all per-partition tiles are filled with flat fancy-index scatters into
the padded (k, ·) planes.  ``build_pack_plan_reference`` retains the
original per-partition formulation as an executable specification — the
property suite asserts the two are slot-for-slot identical.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["PackPlan", "build_pack_plan", "build_pack_plan_reference", "cpack_order"]


def _pad_to(x: int, mult: int) -> int:
    return max(mult, ((x + mult - 1) // mult) * mult)


@dataclasses.dataclass(frozen=True)
class PackPlan:
    """Padded, rectangular schedule for k cache-tiles (host-side numpy)."""

    k: int
    n_rows: int
    n_cols: int
    e_max: int
    x_max: int
    y_max: int
    # Per-partition packed indices.
    x_lidx: np.ndarray  # (k, E_max) i32: task -> local slot in x tile
    y_lidx: np.ndarray  # (k, E_max) i32: task -> local slot in y tile
    x_gidx: np.ndarray  # (k, X_max) i32: local x slot -> global column id
    y_gidx: np.ndarray  # (k, Y_max) i32: local y slot -> global row id (n_rows = sentinel)
    e_count: np.ndarray  # (k,)
    x_count: np.ndarray  # (k,)
    y_count: np.ndarray  # (k,)
    # Permutation from original edge order into the packed layout.
    edge_perm: np.ndarray  # (m,) original edge id for packed slot (p * E_max + s)
    edge_valid: np.ndarray  # (k, E_max) bool

    @classmethod
    def from_arrays(cls, obj) -> "PackPlan":
        """Build a plan from any object carrying PackPlan's fields by name.

        The fields are read with ``getattr`` (ints as ints, arrays as numpy),
        so a plan built by another package with the same layout carries over
        without importing that package.
        """
        kw = {}
        for f in dataclasses.fields(cls):
            v = getattr(obj, f.name)
            kw[f.name] = int(v) if f.type == "int" else np.array(v, copy=True)
        return cls(**kw)

    @property
    def m(self) -> int:
        return int(self.edge_perm.shape[0])

    def pack_values(self, vals: np.ndarray) -> np.ndarray:
        """Arrange per-edge values (e.g. A's non-zeros) as (k, E_max)."""
        out = np.zeros((self.k, self.e_max), dtype=vals.dtype)
        flat = out.reshape(-1)
        slots = np.where(self.edge_valid.reshape(-1))[0]
        flat[slots] = vals[self.edge_perm]
        return out

    def modeled_loads(self) -> int:
        """Memory-traffic model: distinct objects fetched per tile, summed."""
        return int(self.x_count.sum() + self.y_count.sum())

    def vmem_bytes(self, val_bytes: int = 4, idx_bytes: int = 4) -> int:
        """Working set of ONE grid cell (the VMEM footprint the kernel claims)."""
        return (
            self.e_max * (val_bytes + 2 * idx_bytes)
            + self.x_max * val_bytes
            + self.y_max * val_bytes
        )

    def nbytes(self) -> int:
        """Host-side bytes this plan pins (used for cache byte-budget eviction)."""
        return sum(
            a.nbytes
            for a in (
                self.x_lidx,
                self.y_lidx,
                self.x_gidx,
                self.y_gidx,
                self.e_count,
                self.x_count,
                self.y_count,
                self.edge_perm,
                self.edge_valid,
            )
        )


def cpack_order(ids_in_task_order: np.ndarray) -> np.ndarray:
    """cpack (Ding & Kennedy): unique ids in first-touch order."""
    vals, first_idx = np.unique(ids_in_task_order, return_index=True)
    return vals[np.argsort(first_idx, kind="stable")]


def _cpack_ranks(
    part_sorted_labels: np.ndarray, part_sorted_ids: np.ndarray, n_ids: int, k: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Segmented first-touch unique over ``(partition, object)`` pairs.

    Inputs are task-parallel arrays already grouped by partition with the
    original task order preserved inside each group (= cpack's first-touch
    order).  Returns per-task local slots plus per-group scatter data:

      ``local``   (m,) cpack rank of every task's object within its partition
      ``g_part``  (#groups,) owning partition of each distinct object
      ``g_rank``  (#groups,) cpack rank of that object in its partition
      ``g_id``    (#groups,) the global object id
      ``counts``  (k,) distinct objects per partition
    """
    m = part_sorted_ids.shape[0]
    key = part_sorted_labels * n_ids + part_sorted_ids
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    first = np.empty(m, dtype=bool)
    first[0] = True
    np.not_equal(key_s[1:], key_s[:-1], out=first[1:])
    group_of = np.empty(m, dtype=np.int64)
    group_of[order] = np.cumsum(first) - 1  # task -> group id
    first_pos = order[first]  # first-touch position of each group
    g_key = key_s[first]
    g_part = g_key // n_ids
    g_id = g_key % n_ids
    counts = np.bincount(g_part, minlength=k)
    # cpack rank: groups ordered by (partition, first touch).
    by_touch = np.lexsort((first_pos, g_part))
    offsets = np.zeros(k, dtype=np.int64)
    np.cumsum(counts[:-1], out=offsets[1:])
    g_rank = np.empty(g_part.shape[0], dtype=np.int64)
    g_rank[by_touch] = np.arange(g_part.shape[0], dtype=np.int64) - np.repeat(
        offsets, counts
    )
    return g_rank[group_of], g_part, g_rank, g_id, counts


def build_pack_plan(
    n_rows: int,
    n_cols: int,
    rows: np.ndarray,
    cols: np.ndarray,
    labels: np.ndarray,
    k: int,
    pad: int = 128,
) -> PackPlan:
    """Build the packed tile schedule for SpMV from an edge partition.

    ``labels[e]`` is the cluster of non-zero e = (rows[e], cols[e]).
    Within each cluster, tasks are ordered by local row then column (so the
    per-tile scatter is segment-friendly) and data objects are packed in
    first-touch (cpack) order.  Fully vectorized: one global lexsort plus a
    segmented first-touch unique per side, no per-partition loop.
    """
    m = rows.shape[0]
    labels = np.asarray(labels, dtype=np.int64)
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)

    # Group tasks by partition (stable keeps original task order = cpack's
    # first-touch order within the cluster).
    part_order = np.argsort(labels, kind="stable")
    sorted_labels = labels[part_order]
    e_count = np.bincount(labels, minlength=k)
    e_max = _pad_to(int(e_count.max(initial=1)), pad)

    x_gidx_shape_known = m > 0
    if not x_gidx_shape_known:
        x_max = y_max = _pad_to(1, pad)
        return PackPlan(
            k=k,
            n_rows=n_rows,
            n_cols=n_cols,
            e_max=e_max,
            x_max=x_max,
            y_max=y_max,
            x_lidx=np.zeros((k, e_max), dtype=np.int32),
            y_lidx=np.zeros((k, e_max), dtype=np.int32),
            x_gidx=np.zeros((k, x_max), dtype=np.int32),
            y_gidx=np.full((k, y_max), n_rows, dtype=np.int32),
            e_count=e_count.astype(np.int64),
            x_count=np.zeros(k, dtype=np.int64),
            y_count=np.zeros(k, dtype=np.int64),
            edge_perm=np.empty(0, dtype=np.int64),
            edge_valid=np.zeros((k, e_max), dtype=bool),
        )

    # Per-side cpack: local slot per task + (partition, rank) -> object id.
    lx, gx_part, gx_rank, gx_id, x_counts = _cpack_ranks(
        sorted_labels, cols[part_order], n_cols, k
    )
    ly, gy_part, gy_rank, gy_id, y_counts = _cpack_ranks(
        sorted_labels, rows[part_order], n_rows, k
    )
    x_max = _pad_to(int(x_counts.max(initial=1)), pad)
    y_max = _pad_to(int(y_counts.max(initial=1)), pad)

    x_gidx = np.zeros((k, x_max), dtype=np.int32)
    y_gidx = np.full((k, y_max), n_rows, dtype=np.int32)  # sentinel row
    x_gidx.reshape(-1)[gx_part * x_max + gx_rank] = gx_id
    y_gidx.reshape(-1)[gy_part * y_max + gy_rank] = gy_id

    # Order tasks by (partition, local y, local x): scatter-friendly.  The
    # primary key keeps partitions contiguous, so the packed slot of a task
    # is its position minus its partition's start offset.
    torder = np.lexsort((lx, ly, sorted_labels))
    lx, ly = lx[torder], ly[torder]
    edge_perm = part_order[torder]
    starts = np.zeros(k + 1, dtype=np.int64)
    np.cumsum(e_count, out=starts[1:])
    slot = np.arange(m, dtype=np.int64) - np.repeat(starts[:-1], e_count)
    flat_slot = sorted_labels * e_max + slot  # sorted_labels is unchanged by torder

    x_lidx = np.zeros((k, e_max), dtype=np.int32)
    y_lidx = np.zeros((k, e_max), dtype=np.int32)
    edge_valid = np.zeros((k, e_max), dtype=bool)
    x_lidx.reshape(-1)[flat_slot] = lx
    y_lidx.reshape(-1)[flat_slot] = ly
    edge_valid.reshape(-1)[flat_slot] = True

    return PackPlan(
        k=k,
        n_rows=n_rows,
        n_cols=n_cols,
        e_max=e_max,
        x_max=x_max,
        y_max=y_max,
        x_lidx=x_lidx,
        y_lidx=y_lidx,
        x_gidx=x_gidx,
        y_gidx=y_gidx,
        e_count=e_count.astype(np.int64),
        x_count=x_counts.astype(np.int64),
        y_count=y_counts.astype(np.int64),
        edge_perm=edge_perm,
        edge_valid=edge_valid,
    )


def build_pack_plan_reference(
    n_rows: int,
    n_cols: int,
    rows: np.ndarray,
    cols: np.ndarray,
    labels: np.ndarray,
    k: int,
    pad: int = 128,
) -> PackPlan:
    """Naive per-partition reference for :func:`build_pack_plan`.

    Kept as an executable specification: the property suite asserts the
    vectorized builder is slot-for-slot identical to this loop on random
    COO inputs.  Not a hot path — do not call from serving code.
    """
    m = rows.shape[0]
    labels = np.asarray(labels, dtype=np.int64)
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)

    part_order = np.argsort(labels, kind="stable")
    sorted_labels = labels[part_order]
    e_count = np.bincount(labels, minlength=k)
    e_max = _pad_to(int(e_count.max(initial=1)), pad)

    xkey = np.unique(sorted_labels * n_cols + cols[part_order])
    x_counts = np.bincount((xkey // n_cols).astype(np.int64), minlength=k)
    ykey = np.unique(sorted_labels * n_rows + rows[part_order])
    y_counts = np.bincount((ykey // n_rows).astype(np.int64), minlength=k)
    x_max = _pad_to(int(x_counts.max(initial=1)), pad)
    y_max = _pad_to(int(y_counts.max(initial=1)), pad)

    x_lidx = np.zeros((k, e_max), dtype=np.int32)
    y_lidx = np.zeros((k, e_max), dtype=np.int32)
    x_gidx = np.zeros((k, x_max), dtype=np.int32)
    y_gidx = np.full((k, y_max), n_rows, dtype=np.int32)  # sentinel row
    edge_valid = np.zeros((k, e_max), dtype=bool)
    edge_perm = np.empty(m, dtype=np.int64)

    starts = np.zeros(k + 1, dtype=np.int64)
    np.cumsum(e_count, out=starts[1:])
    slot_base = 0
    for p in range(k):
        seg = part_order[starts[p] : starts[p + 1]]
        if seg.size == 0:
            continue
        c = cols[seg]
        r = rows[seg]
        cx = cpack_order(c)
        cy = cpack_order(r)
        x_gidx[p, : cx.size] = cx
        y_gidx[p, : cy.size] = cy
        cmap = {int(g): i for i, g in enumerate(cx)}
        rmap = {int(g): i for i, g in enumerate(cy)}
        lx = np.fromiter((cmap[int(g)] for g in c), dtype=np.int32, count=seg.size)
        ly = np.fromiter((rmap[int(g)] for g in r), dtype=np.int32, count=seg.size)
        torder = np.lexsort((lx, ly))
        seg, lx, ly = seg[torder], lx[torder], ly[torder]
        ne = seg.size
        x_lidx[p, :ne] = lx
        y_lidx[p, :ne] = ly
        edge_valid[p, :ne] = True
        edge_perm[slot_base : slot_base + ne] = seg
        slot_base += ne

    return PackPlan(
        k=k,
        n_rows=n_rows,
        n_cols=n_cols,
        e_max=e_max,
        x_max=x_max,
        y_max=y_max,
        x_lidx=x_lidx,
        y_lidx=y_lidx,
        x_gidx=x_gidx,
        y_gidx=y_gidx,
        e_count=e_count.astype(np.int64),
        x_count=x_counts.astype(np.int64),
        y_count=y_counts.astype(np.int64),
        edge_perm=edge_perm,
        edge_valid=edge_valid,
    )
