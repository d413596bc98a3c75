"""EP-scheduled SpMV kernels for Hopper (paper §5.2), with their plain twins.

The host-side edge partitioner assigns every non-zero (task) to one of k
clusters; ``core.reorder.build_pack_plan`` packs each cluster's tasks and the
unique x/y entries it touches into padded tiles.  Each CUDA block plays one
cluster, the paper's thread block:

* ``spmv_software_cache`` stages the cluster's packed x tile in shared memory
  once; every task reads x through a local index (the paper's ``__shared__``
  design);
* ``spmv_streaming`` / ``spmv_streaming_batched`` gather straight from the
  whole x through the read-only path (the paper's texture-cache variant);
* ``ep_combine`` sums the per-cluster partial y tiles into y.

The kernels live in ``csrc/ep_spmv.cu`` and are launched through ctypes on
PyTorch's current stream.  A wrapper given CUDA tensors launches its kernel
(or raises); given CPU tensors it runs its plain PyTorch twin, an
``index_add_`` over a zero accumulator in ascending task order, which is the
order the kernels sum in.

Determinism: every y slot and every row of y is summed by one thread in
ascending input order, with no atomics, so results do not depend on the
launch shape.  ``build_pack_plan`` already packs each cluster's tasks first,
sorted by ``y_lidx``, so the kernels need only the run of task slots of each
y slot (:func:`tile_order`); the combine walks a row-pointer table of
ascending flat partial indices per output row (:func:`combine_table`).  Both
are built once per plan by the callers in ``ops`` and ``runtime.request``; a
wrapper given no runs sorts its tasks stably by ``y_lidx`` itself
(:func:`sort_by_y_slot`).

Each wrapper counts its kernel launches in its ``launches`` attribute.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = [
    "SMEM_LIMIT_BYTES",
    "combine_plain",
    "combine_table",
    "ep_combine",
    "launch_counts",
    "reset_launch_counts",
    "software_cache_plain",
    "sort_by_y_slot",
    "spmv_software_cache",
    "spmv_streaming",
    "spmv_streaming_batched",
    "streaming_batched_plain",
    "streaming_plain",
    "tile_order",
]

# Shared memory one block may use on Hopper (227 KB, opt-in above 48 KB).
SMEM_LIMIT_BYTES = 232_448

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "ep_spmv_smem": [_P] * 5 + [_I] * 4 + [_P],
    "ep_spmv_stream": [_P] * 5 + [_I] * 5 + [_P],
    "ep_combine": [_P] * 4 + [_I] + [_P],
}


def _launch(entry: str, dtype: torch.dtype, device: torch.device, *args) -> None:
    _build.launch("ep_spmv", f"{entry}_{_SUFFIX[dtype]}", _ARGTYPES[entry], device, *args)


def _check_cuda(floats: dict, ints: dict) -> tuple[torch.dtype, torch.device]:
    """Device, type and layout checks before pointers go to a kernel."""
    first = next(iter(floats.values()))
    dtype, device = first.dtype, first.device
    if dtype not in _SUFFIX:
        raise TypeError(f"kernels take float32 or float64, got {dtype}")
    for name, t in {**floats, **ints}.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in floats.items():
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, expected {dtype}")
    for name, t in ints.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    return dtype, device


def _check_int32(n: int, what: str) -> None:
    if n >= 2**31:
        raise ValueError(f"{what} ({n}) exceeds the kernels' int32 indexing")


# ---------------------------------------------------------------------------
# Summation orders (built once per plan by the callers)
# ---------------------------------------------------------------------------


def _runs(y: torch.Tensor, y_max: int) -> torch.Tensor:
    """``seg (R, y_max + 1)`` of ``y (R, E)`` sorted per row; ``y_max`` marks no slot."""
    counts = torch.zeros((y.shape[0], y_max + 2), dtype=torch.long, device=y.device)
    counts.scatter_add_(1, y + 1, torch.ones_like(y))
    return counts[:, : y_max + 1].cumsum(1).to(torch.int32)


def tile_order(y_lidx: torch.Tensor, y_max: int, valid=None) -> torch.Tensor:
    """Per-tile summation runs of tasks packed in y order.

    Returns ``seg (..., y_max + 1)`` int32: task slots ``seg[j]:seg[j + 1]``
    of a tile are the tasks of its y slot ``j``, summed in that order.

    ``valid (..., E)`` (bool) marks the slots that hold tasks (all, if
    ``None``).  They must come first in each tile, sorted by ``y_lidx``, as
    ``build_pack_plan`` packs them; the rest -- a plan's zero-valued
    padding -- lie from ``seg[..., -1]`` on, in no run, so no thread walks
    them.  Raises ``ValueError`` when the tasks are not so packed.
    """
    e_max = y_lidx.shape[-1]
    y = y_lidx.reshape(-1, e_max).long()
    v = torch.ones_like(y, dtype=torch.bool) if valid is None else valid.reshape(-1, e_max)
    if bool((v[:, 1:] & ~v[:, :-1]).any()) or bool(((y[:, 1:] < y[:, :-1]) & v[:, 1:]).any()):
        raise ValueError("each tile's tasks must come first, sorted by y_lidx "
                         "(as build_pack_plan packs them); see sort_by_y_slot")
    seg = _runs(torch.where(v, y, y_max), y_max)
    return seg.reshape(tuple(y_lidx.shape[:-1]) + (y_max + 1,))


def sort_by_y_slot(y_lidx: torch.Tensor, y_max: int, *tasks: torch.Tensor):
    """``(seg, *tasks)`` with each tile's task arrays sorted stably by ``y_lidx``.

    What a wrapper given no runs does: every slot, padding included, is
    summed on its y slot in ascending slot order.
    """
    idx = torch.sort(y_lidx.long(), dim=-1, stable=True).indices
    y = torch.gather(y_lidx.long(), -1, idx)
    seg = _runs(y.reshape(-1, y.shape[-1]), y_max)
    return (seg.reshape(tuple(y_lidx.shape[:-1]) + (y_max + 1,)),
            *(torch.gather(t, -1, idx) for t in tasks))


def combine_table(y_gidx: torch.Tensor, n_rows: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Row-pointer table that sums partial tiles into y, sentinel dropped.

    ``y_gidx`` is ``(k, Y)`` for one request or ``(B, k, Y)`` for a stacked
    batch; entries equal to ``n_rows`` (the sentinel) are left out.  Output
    row ``b * n_rows + r`` sums the partials at flat positions
    ``src[row_ptr[i]:row_ptr[i + 1]]`` of the ``(B, k, Y)`` partials, in
    ascending order.  Returns int32 ``row_ptr (B * n_rows + 1,)`` and ``src``.
    """
    batch = y_gidx.shape[0] if y_gidx.dim() == 3 else 1
    yg = y_gidx.reshape(batch, -1).long()
    _check_int32(yg.numel(), "partials size")
    valid = yg < n_rows
    offs = torch.arange(batch, device=yg.device).unsqueeze(1) * n_rows
    rows = (yg + offs)[valid]
    src = torch.nonzero(valid.reshape(-1)).squeeze(1)
    src = src[torch.sort(rows, stable=True).indices]
    counts = torch.bincount(rows, minlength=batch * n_rows)
    row_ptr = torch.zeros(batch * n_rows + 1, dtype=torch.long, device=yg.device)
    row_ptr[1:] = counts.cumsum(0)
    return row_ptr.to(torch.int32), src.to(torch.int32)


# ---------------------------------------------------------------------------
# Plain PyTorch twins (the CPU path, and the yardstick the kernels are held to)
# ---------------------------------------------------------------------------


def _scatter_tiles(contrib, y_lidx, y_max: int, seg) -> torch.Tensor:
    rows, e_max = contrib.shape
    if seg is not None:  # slots outside every run add nothing, as in the kernels
        slots = torch.arange(e_max, device=contrib.device)
        contrib = contrib.masked_fill(slots >= seg.reshape(rows, y_max + 1)[:, -1:], 0)
    out = torch.zeros(rows * y_max, dtype=contrib.dtype, device=contrib.device)
    offs = torch.arange(rows, device=contrib.device).unsqueeze(1) * y_max
    out.index_add_(0, (y_lidx.long() + offs).reshape(-1), contrib.reshape(-1))
    return out.view(rows, y_max)


def software_cache_plain(vals, x_lidx, y_lidx, x_packed, y_max: int, seg=None):
    """Twin of :func:`spmv_software_cache`: ``(R, E)`` tasks -> ``(R, y_max)``."""
    contrib = vals * torch.gather(x_packed, 1, x_lidx.long())
    return _scatter_tiles(contrib, y_lidx, y_max, seg)


def streaming_plain(vals, x_gidx_task, y_lidx, x, y_max: int, seg=None):
    """Twin of :func:`spmv_streaming`: ``(k, E)`` tasks, ``x (n_cols,)``."""
    contrib = vals * x[x_gidx_task.long()]
    return _scatter_tiles(contrib, y_lidx, y_max, seg)


def streaming_batched_plain(vals, x_gidx_task, y_lidx, x, y_max: int, seg=None):
    """Twin of :func:`spmv_streaming_batched`: ``(B, k, E)`` tasks, ``x (B, n_cols)``."""
    b, k, e_max = vals.shape
    xv = torch.gather(x, 1, x_gidx_task.reshape(b, k * e_max).long()).view(b, k, e_max)
    out = _scatter_tiles((vals * xv).view(b * k, e_max), y_lidx.reshape(b * k, e_max), y_max,
                         seg)
    return out.view(b, k, y_max)


def combine_plain(partials, row_ptr, src, n_out: int) -> torch.Tensor:
    """Twin of :func:`ep_combine`."""
    counts = (row_ptr[1:] - row_ptr[:-1]).long()
    rows = torch.repeat_interleave(torch.arange(n_out, device=partials.device), counts)
    y = torch.zeros(n_out, dtype=partials.dtype, device=partials.device)
    return y.index_add_(0, rows, partials.reshape(-1)[src.long()])


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def spmv_software_cache(vals, x_lidx, y_lidx, x_packed, y_max: int, *, seg=None):
    """Per-cluster partial y tiles with the x tile staged in shared memory.

    ``vals/x_lidx/y_lidx (R, E)``, ``x_packed (R, X)`` -> ``(R, y_max)``;
    ``seg`` is :func:`tile_order` of ``y_lidx`` (task slots outside its
    runs add nothing).

    Replaces ``src/repro/kernels/ep_spmv.py::spmv_software_cache``
    (``_smem_kernel``, grid ``(k,)``).  Bound by device-memory bytes: each
    row reads 8 bytes per f32 task (value and x index), its runs and its x
    tile once and writes its y tile; the x gathers stay in shared memory.  One CTA per row stages
    ``x_packed[r]`` with coalesced loads, then each thread sums its y slots
    in task order.  The x tile must fit in one block's shared memory.
    """
    rows, e_max = vals.shape
    x_max = x_packed.shape[1]
    if x_lidx.shape != vals.shape or y_lidx.shape != vals.shape or x_packed.shape[0] != rows:
        raise ValueError("vals/x_lidx/y_lidx must be (R, E) and x_packed (R, X)")
    if x_max * vals.element_size() > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"x tile of {x_max} x {vals.element_size()} bytes exceeds the "
            f"{SMEM_LIMIT_BYTES}-byte shared-memory limit of one block; "
            "use mode='streaming' or a smaller pad"
        )
    if not vals.is_cuda:
        return software_cache_plain(vals, x_lidx, y_lidx, x_packed, y_max, seg)
    if seg is None:
        seg, vals, x_lidx = sort_by_y_slot(y_lidx, y_max, vals, x_lidx)
    dtype, device = _check_cuda({"vals": vals, "x_packed": x_packed},
                                {"x_lidx": x_lidx, "seg": seg})
    if seg.shape != (rows, y_max + 1):
        raise ValueError("seg does not match (R, E) tasks and y_max")
    _check_int32(rows * max(e_max, x_max, y_max + 1), "tile size")
    out = torch.empty((rows, y_max), dtype=dtype, device=device)
    _launch("ep_spmv_smem", dtype, device, vals, x_lidx, seg, x_packed, out,
            rows, e_max, x_max, y_max)
    spmv_software_cache.launches += 1
    return out


def _streaming_launch(vals, x_gidx_task, y_lidx, x, y_max, seg):
    """Shared body of both streaming wrappers: ``(B, k, E)`` tasks, ``x (B, n)``."""
    b, k, e_max = vals.shape
    n_cols = x.shape[1]
    if seg is None:
        seg, vals, x_gidx_task = sort_by_y_slot(y_lidx, y_max, vals, x_gidx_task)
    dtype, device = _check_cuda({"vals": vals, "x": x},
                                {"x_gidx_task": x_gidx_task, "seg": seg})
    if seg.shape != (b, k, y_max + 1):
        raise ValueError("seg does not match the tasks and y_max")
    _check_int32(b * k * max(e_max, y_max + 1), "tile size")
    _check_int32(b * n_cols, "x size")
    out = torch.empty((b, k, y_max), dtype=dtype, device=device)
    _launch("ep_spmv_stream", dtype, device, vals, x_gidx_task, seg, x, out,
            b, k, e_max, n_cols, y_max)
    return out


def spmv_streaming(vals, x_gidx_task, y_lidx, x, y_max: int, *, seg=None):
    """Per-cluster partial y tiles gathered from the whole x, no staging.

    ``vals/x_gidx_task/y_lidx (k, E)``, ``x (n_cols,)`` -> ``(k, y_max)``.

    Replaces ``src/repro/kernels/ep_spmv.py::spmv_streaming``
    (``_stream_kernel``, grid ``(k,)``).  Bound by device-memory bytes: 12
    bytes per f32 task plus the runs, x and the y tiles; the x gathers are
    irregular, so they go through the read-only path (``__ldg``) and rely on
    L1/L2 for reuse.  One CTA per 1,024 y slots of a tile streams the
    window's tasks with 16-byte loads, all lanes on consecutive tasks, and
    stages the rounded products in shared memory; each slot then sums its
    run from there in task order, so the bits are the twin's.  Same kernel
    body as the batched variant with B = 1.
    """
    if (vals.dim() != 2 or x_gidx_task.shape != vals.shape or y_lidx.shape != vals.shape
            or x.dim() != 1):
        raise ValueError("vals/x_gidx_task/y_lidx must be (k, E) and x (n_cols,)")
    if not vals.is_cuda:
        return streaming_plain(vals, x_gidx_task, y_lidx, x, y_max, seg)
    out = _streaming_launch(vals.unsqueeze(0), x_gidx_task.unsqueeze(0), y_lidx.unsqueeze(0),
                            x.unsqueeze(0), y_max, None if seg is None else seg.unsqueeze(0))
    spmv_streaming.launches += 1
    return out[0]


def spmv_streaming_batched(vals, x_gidx_task, y_lidx, x, y_max: int, *, seg=None):
    """Streaming partials for B same-bucket requests in one launch.

    ``vals/x_gidx_task/y_lidx (B, k, E)``, ``x (B, n_cols)`` ->
    ``(B, k, y_max)``.  Zero-valued tails and all-zero batch slots add
    exactly 0.

    Replaces ``src/repro/kernels/ep_spmv.py::spmv_streaming_batched``
    (``_stream_kernel_batched``, grid ``(B, k)``).  Bound by device-memory
    bytes as :func:`spmv_streaming`; grid ``(k, B)``, request b reading its
    own row of x.
    """
    if vals.dim() != 3 or x_gidx_task.shape != vals.shape or y_lidx.shape != vals.shape:
        raise ValueError("vals/x_gidx_task/y_lidx must be (B, k, E)")
    if x.dim() != 2 or x.shape[0] != vals.shape[0]:
        raise ValueError("x must be (B, n_cols)")
    if not vals.is_cuda:
        return streaming_batched_plain(vals, x_gidx_task, y_lidx, x, y_max, seg)
    out = _streaming_launch(vals, x_gidx_task, y_lidx, x, y_max, seg)
    spmv_streaming_batched.launches += 1
    return out


def ep_combine(partials, row_ptr, src, n_out: int):
    """Deterministic combine: ``y[i] = sum(partials.flat[src[row_ptr[i]:row_ptr[i+1]]])``.

    Takes the place of the reference's scatter-add
    ``y.at[y_gidx].add(partials)`` (``src/repro/kernels/ops.py``), which is
    not a Pallas kernel; with atomics its sums would depend on the order the
    card runs them in.  Bound by device-memory bytes: the partials and the
    table read once, y written once.  One thread per output row walks its
    run of :func:`combine_table` in ascending order.
    """
    if row_ptr.shape != (n_out + 1,):
        raise ValueError(f"row_ptr must have {n_out + 1} entries")
    if not partials.is_cuda:
        return combine_plain(partials, row_ptr, src, n_out)
    dtype, device = _check_cuda({"partials": partials}, {"row_ptr": row_ptr, "src": src})
    _check_int32(partials.numel(), "partials size")
    y = torch.empty(n_out, dtype=dtype, device=device)
    _launch("ep_combine", dtype, device, partials, row_ptr, src, y, n_out)
    ep_combine.launches += 1
    return y


_KERNELS = (spmv_software_cache, spmv_streaming, spmv_streaming_batched, ep_combine)


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    for fn in _KERNELS:
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`, by wrapper name."""
    return {fn.__name__: fn.launches for fn in _KERNELS}


reset_launch_counts()
