"""Public SpMV entry points around the Hopper kernels: pack -> kernel -> combine.

``ep_spmv`` is the end-to-end EP-scheduled SpMV over a host-side
``PackPlan``:

  1. *pack*    — gather ``x`` into per-cluster contiguous tiles
                 (``x[x_gidx]``, torch indexing);
  2. *kernel*  — per-cluster partial products (``ep_spmv.spmv_*``);
  3. *combine* — the partial y tiles summed into y in a fixed order
                 (``ep_spmv.ep_combine``), the sentinel row dropped.

``mode="software"`` stages x tiles in shared memory; ``mode="streaming"``
gathers from the full x inside the kernel and skips step 1.

Two contracts, as in the reference:

* **Per-plan** (``make_ep_spmv_fn``) — the plan's operands, summation runs
  and combine table are moved to the device once and held by the returned
  callable.
* **Bucketed** (``BucketSpec`` + ``pad_plan_operands`` +
  ``make_bucketed_spmv_fn``) — the plan arrays are arguments of one callable
  per shape bucket, so every request whose plan fits the bucket's padded
  ceilings goes through it, ``spec.batch`` requests at a time.  Tail slots
  are zero-filled and out-of-range rows land on the bucket's sentinel row.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, NamedTuple

import numpy as np
import torch

from ..core.reorder import PackPlan
from ..device import resolve_device
from . import ep_spmv as _spmv

__all__ = [
    "BucketSpec",
    "ep_spmv",
    "make_bucketed_spmv_fn",
    "make_ep_spmv_fn",
    "moe_mlp",
    "pad_plan_operands",
    "resolve_plan",
    "spmv_hbm_traffic_model",
]


def __getattr__(name):
    """``moe_mlp``, the expert-FFN kernel's wrapper (``kernels/moe_mlp.py``),
    loaded on first use: ``repro_torch.kernels`` imports this module before
    that one."""
    if name == "moe_mlp":
        import importlib

        return importlib.import_module(f"{__package__}.moe_mlp").moe_mlp
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def resolve_plan(plan, timeout: float | None = None) -> PackPlan:
    """Deprecated alias of :func:`repro_torch.runtime.request.resolve_plan`:
    unwrapping a plan service's handles is the request layer's work; this
    module takes host-side ``PackPlan``s only."""
    import warnings

    warnings.warn("repro_torch.kernels.resolve_plan is deprecated; use "
                  "repro_torch.runtime.request.resolve_plan", DeprecationWarning, stacklevel=2)
    from ..runtime.request import resolve_plan as _resolve  # lazy: layering

    return _resolve(plan, timeout)


# ---------------------------------------------------------------------------
# Bucketed contract: padded-shape spec
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """Padded-shape contract of one bucket callable.

    Every request served through a bucket arrives widened to these
    rectangular ceilings: the plan tiles to ``(k, e_max/x_max/y_max)``, the
    input vector to ``n_cols`` slots, the output to ``n_rows`` rows, and
    the micro-batch to exactly ``batch`` requests (unused slots are
    all-zero and contribute nothing).  The spec is the build-cache key.
    """

    k: int
    n_rows: int  # row ceiling: y is produced at this length, de-padded by the caller
    n_cols: int  # column ceiling: x must arrive zero-padded to this length
    e_max: int
    x_max: int
    y_max: int
    batch: int  # fixed micro-batch width; short batches are zero-padded
    mode: str = "software"

    def fits(self, plan: PackPlan) -> bool:
        """True when ``plan``'s padded tiles fit inside this bucket."""
        return (
            plan.k == self.k
            and plan.n_rows <= self.n_rows
            and plan.n_cols <= self.n_cols
            and plan.e_max <= self.e_max
            and plan.x_max <= self.x_max
            and plan.y_max <= self.y_max
        )

    def operand_elems(self) -> int:
        """Total padded operand elements of one launch — the build-cache
        size coordinate for (size, recency) eviction."""
        return self.batch * (
            self.k * (3 * self.e_max + self.x_max + self.y_max) + self.n_cols
        )


class PaddedOperands(NamedTuple):
    """One plan widened to a bucket: the reference's five arrays, then the
    summation runs (:func:`ep_spmv.tile_order`) and the combine table
    (:func:`ep_spmv.combine_table`) built from them."""

    vals: np.ndarray | torch.Tensor  # (k, E)
    x_lidx: np.ndarray | torch.Tensor  # (k, E) int32
    y_lidx: np.ndarray | torch.Tensor  # (k, E) int32
    x_gidx: np.ndarray | torch.Tensor  # (k, X) int32
    y_gidx: np.ndarray | torch.Tensor  # (k, Y) int32, spec.n_rows = sentinel
    seg: np.ndarray | torch.Tensor  # (k, Y + 1) int32
    row_ptr: np.ndarray | torch.Tensor  # (spec.n_rows + 1,) int32
    src: np.ndarray | torch.Tensor  # (entries,) int32, flat index into (k, Y)

    def to(self, device: torch.device) -> "PaddedOperands":
        return PaddedOperands(*(torch.as_tensor(a).to(device) for a in self))


def pad_plan_operands(plan: PackPlan, vals: np.ndarray, spec: BucketSpec) -> PaddedOperands:
    """Widen one plan + its matrix values into ``spec``'s rectangular tiles.

    The first five fields are the reference's host arrays
    ``(vals_packed, x_lidx, y_lidx, x_gidx, y_gidx)``; the tail contract:

    * task tail slots carry ``vals == 0`` with local indices 0, so they add
      exactly ``0.0`` to slot 0 of their tiles;
    * ``x_gidx`` tail slots gather ``x[0]`` into x-tile slots no task reads;
    * ``y_gidx`` tail slots — and the plan's own ``n_rows`` sentinel — are
      remapped to the bucket sentinel ``spec.n_rows``, which the combine
      table leaves out.

    The summation runs (padding left out of every run) and the combine
    table follow, built here once per plan so that serving a request does no
    sorting.
    """
    if not spec.fits(plan):
        raise ValueError(
            f"plan (k={plan.k}, rows={plan.n_rows}, cols={plan.n_cols}, "
            f"tiles=({plan.e_max},{plan.x_max},{plan.y_max})) does not fit "
            f"bucket {spec}"
        )
    vals = np.asarray(vals)
    vp = np.zeros((spec.k, spec.e_max), dtype=vals.dtype)
    vp[:, : plan.e_max] = plan.pack_values(vals)
    xl = np.zeros((spec.k, spec.e_max), dtype=np.int32)
    xl[:, : plan.e_max] = plan.x_lidx
    yl = np.zeros((spec.k, spec.e_max), dtype=np.int32)
    yl[:, : plan.e_max] = plan.y_lidx
    xg = np.zeros((spec.k, spec.x_max), dtype=np.int32)
    xg[:, : plan.x_max] = plan.x_gidx
    yg = np.full((spec.k, spec.y_max), spec.n_rows, dtype=np.int32)
    yg[:, : plan.y_max] = np.where(plan.y_gidx == plan.n_rows, spec.n_rows, plan.y_gidx)
    valid = np.zeros((spec.k, spec.e_max), dtype=bool)
    valid[:, : plan.e_max] = plan.edge_valid
    seg = _spmv.tile_order(torch.from_numpy(yl), spec.y_max, torch.from_numpy(valid))
    row_ptr, src = _spmv.combine_table(torch.from_numpy(yg), spec.n_rows)
    return PaddedOperands(vp, xl, yl, xg, yg, seg.numpy(), row_ptr.numpy(), src.numpy())


def stack_combine_tables(tables, n_rows: int, stride: int, device=None):
    """One combine table for a stacked batch from per-plan tables.

    ``tables[b]`` is request b's ``(row_ptr, src)`` over its ``(k, Y)``
    partials (``stride = k * Y``), or ``None`` for an empty batch slot.
    Equal to :func:`ep_spmv.combine_table` of the stacked ``y_gidx``.
    """
    rps, srcs, base = [], [], 0
    for b, t in enumerate(tables):
        if t is None:
            rps.append(torch.full((n_rows,), base, dtype=torch.int32, device=device))
            continue
        row_ptr, src = t
        rps.append(row_ptr[:-1] + base)
        srcs.append(src + b * stride)
        base += int(src.shape[0])
    _spmv._check_int32(len(tables) * stride, "partials size")
    rps.append(torch.full((1,), base, dtype=torch.int32, device=device))
    src = torch.cat(srcs) if srcs else torch.zeros(0, dtype=torch.int32, device=device)
    return torch.cat(rps), src


def make_bucketed_spmv_fn(spec: BucketSpec, device=None):
    """One callable per shape bucket: ``(plan arrays, x) -> y``.

    Nothing about the matrix is held by the callable — the packed values and
    indices are arguments, so it serves every (plan, values, x) widened to
    ``spec`` by :func:`pad_plan_operands`.  It maps batch-leading operands

        ``vals (B,k,E) · x_lidx (B,k,E) · y_lidx (B,k,E) ·
        x_gidx (B,k,X) · y_gidx (B,k,Y) · x (B, n_cols)``

    to ``y (B, n_rows)`` on ``device`` (``B == spec.batch``); callers
    zero-pad short micro-batches and de-pad each row.  ``seg`` (the stacked
    summation runs) and ``table`` (the stacked combine table) are computed
    from ``y_lidx``/``y_gidx`` when not given.
    """
    dev = resolve_device(device)
    b, k = spec.batch, spec.k
    e_max, x_max, y_max = spec.e_max, spec.x_max, spec.y_max
    n_rows = spec.n_rows
    if spec.mode not in ("software", "streaming"):
        raise ValueError(f"unknown mode {spec.mode!r}")

    def run(vals, x_lidx, y_lidx, x_gidx, y_gidx, x, *, seg=None, table=None):
        vals, x = torch.as_tensor(vals, device=dev), torch.as_tensor(x, device=dev)
        x_lidx = torch.as_tensor(x_lidx, device=dev)
        y_lidx = torch.as_tensor(y_lidx, device=dev)
        x_gidx = torch.as_tensor(x_gidx, device=dev)
        if table is None:
            table = _spmv.combine_table(torch.as_tensor(y_gidx, device=dev), n_rows)
        if spec.mode == "software":
            # pack: each request gathers its unique x entries (n_touched + C loads)
            x_packed = torch.gather(x, 1, x_gidx.reshape(b, k * x_max).long())
            partials = _spmv.spmv_software_cache(
                vals.reshape(b * k, e_max),
                x_lidx.reshape(b * k, e_max),
                y_lidx.reshape(b * k, e_max),
                x_packed.reshape(b * k, x_max),
                y_max,
                seg=None if seg is None else seg.reshape(b * k, y_max + 1),
            )
        else:
            # Global x index per task = x_gidx[b, p, x_lidx[b, p, e]].
            xg_task = torch.gather(x_gidx, 2, x_lidx.long())
            partials = _spmv.spmv_streaming_batched(
                vals, xg_task, y_lidx, x, y_max, seg=seg)
        return _spmv.ep_combine(partials, *table, b * n_rows).view(b, n_rows)

    return run


# ---------------------------------------------------------------------------
# Per-plan contract
# ---------------------------------------------------------------------------


def make_ep_spmv_fn(
    plan: PackPlan,
    vals: np.ndarray,
    mode: Literal["software", "streaming"] = "software",
    device=None,
):
    """Bind a PackPlan + matrix values; return ``x -> y`` on ``device``.

    The packed operands, the summation runs and the combine table are built
    on the host once and held on the device by the returned callable (they
    change only when the matrix or its partition changes — per paper §4 the
    relayout happens once, asynchronously).  ``x`` may be a numpy array or a
    tensor; ``y`` is a tensor of ``n_rows`` on ``device``.
    """
    if not isinstance(plan, PackPlan):
        raise TypeError(f"expected a PackPlan, got {type(plan).__name__}; "
                        "resolve service handles with runtime.request.resolve_plan")
    if mode not in ("software", "streaming"):
        raise ValueError(f"unknown mode {mode!r}")
    dev = resolve_device(device)
    vals_packed = torch.from_numpy(plan.pack_values(np.asarray(vals)))
    x_lidx = torch.from_numpy(np.ascontiguousarray(plan.x_lidx, dtype=np.int32))
    y_lidx = torch.from_numpy(np.ascontiguousarray(plan.y_lidx, dtype=np.int32))
    x_gidx = torch.from_numpy(np.ascontiguousarray(plan.x_gidx, dtype=np.int32))
    y_gidx = torch.from_numpy(np.ascontiguousarray(plan.y_gidx, dtype=np.int32))
    n_rows, y_max = plan.n_rows, plan.y_max
    valid = torch.from_numpy(np.asarray(plan.edge_valid, dtype=bool))
    seg = _spmv.tile_order(y_lidx, y_max, valid).to(dev)
    row_ptr, src = (t.to(dev) for t in _spmv.combine_table(y_gidx, n_rows))
    vals_packed, y_lidx = vals_packed.to(dev), y_lidx.to(dev)
    dtype = vals_packed.dtype

    if mode == "software":
        x_lidx = x_lidx.to(dev)
        x_gidx_flat = x_gidx.reshape(-1).long().to(dev)

        def partials_of(x):
            x_packed = x[x_gidx_flat].view(plan.k, plan.x_max)  # pack: n_touched + C loads
            return _spmv.spmv_software_cache(vals_packed, x_lidx, y_lidx, x_packed, y_max,
                                             seg=seg)

    else:
        # Global x index per task = x_gidx[p, x_lidx[p, e]].
        xg_task = torch.gather(x_gidx, 1, x_lidx.long()).to(dev)

        def partials_of(x):
            return _spmv.spmv_streaming(vals_packed, xg_task, y_lidx, x, y_max, seg=seg)

    def run(x):
        x = torch.as_tensor(x, dtype=dtype, device=dev)
        return _spmv.ep_combine(partials_of(x), row_ptr, src, n_rows)

    return run


def ep_spmv(
    x,
    plan: PackPlan,
    vals: np.ndarray,
    mode: Literal["software", "streaming"] = "software",
    device=None,
) -> torch.Tensor:
    """One-shot convenience wrapper (rebinds the plan every call)."""
    return make_ep_spmv_fn(plan, vals, mode, device)(x)


def spmv_hbm_traffic_model(plan: PackPlan, mode: str = "software") -> dict:
    """Modeled off-chip loads (paper Fig. 11's transaction count).

    software: unique x + unique y entries per cluster (C is the redundancy);
    streaming: every task load goes through the implicit cache — best case
    equals software, worst case one load per task (cache thrashing).
    """
    unique_loads = int(plan.x_count.sum() + plan.y_count.sum())
    task_loads = int(plan.e_count.sum() * 2)
    return {
        "mode": mode,
        "unique_loads": unique_loads,
        "worst_case_loads": unique_loads if mode == "software" else task_loads,
    }
