"""AdamW's global norm and update on the card, in two hand-written passes.

``adamw_norm(grads, clip_norm)`` returns the L2 norm over every gradient leaf
and the clip scale ``min(clip_norm / max(norm, 1e-9), 1)`` (1 when
``clip_norm`` is None), both 0-d float32 device tensors (on a mesh, of the
rank's shards' sum of squares added over the ranks by ``reduce``);
``adamw_update(p, g, m, v, scale, lr, bc1, bc2, ...)`` updates one leaf's
weights and moments in place, in the float32 arithmetic and order of
``optim/adamw.py``'s loop, which is their plain twin (the CPU's and meta's
path).

The kernels live in ``csrc/adamw.cu``: one launch a leaf for its partial sums
of squares and one for the fixed-order sum of all partials (two on a mesh:
the rank's sum, then the norm of the ranks' total); one launch a leaf for the
update, which reads p, g, m and v once and writes p, m and v once.  Each
takes float32 or bf16 tensors (the moments both of one type) and raises on
anything else: CUDA tensors only, contiguous, on one device.  Nothing waits
for the device: ``scale``, ``lr``, ``bc1`` and ``bc2`` stay on it.  Each
call that launches adds one to the wrapper's ``launches`` attribute.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["adamw_norm", "adamw_update"]

_BLOCK_ELEMENTS = 256 * 8  # a block's 256 threads, 8 elements each
_MAX_BLOCKS = 1024  # 8 blocks on each of the H100's 132 SMs, rounded; more loop over the grid
_DTYPES = (torch.float32, torch.bfloat16)

_NORM_PARTIAL_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                          ctypes.c_int, ctypes.c_void_p]
_NORM_FINISH_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float, ctypes.c_int,
                         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
_NORM_SUM_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
_UPDATE_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 3
                    + [ctypes.c_void_p] * 4 + [ctypes.c_float] * 6
                    + [ctypes.c_int, ctypes.c_void_p])


def _blocks(n: int) -> int:
    return min(-(-n // _BLOCK_ELEMENTS), _MAX_BLOCKS)


def _check(name: str, device: torch.device, **tensors) -> None:
    for what, x in tensors.items():
        if not x.is_cuda or x.device != device:
            raise ValueError(f"{name}: {what} is on {x.device}; expected {device} (the CPU "
                             "and meta take optim/adamw.py's loop)")
        if x.dtype not in _DTYPES:
            raise TypeError(f"{name}: {what} is {x.dtype}; the kernels take float32 or bfloat16")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")


def adamw_norm(grads, clip_norm: float | None, *, device=None, reduce=None):
    """``(grad_norm, scale)`` over the plain CUDA tensors ``grads``: each
    leaf's blocks write their partial sums of squares (float32) at the
    leaf's offset of one scratch buffer, then one block sums them all in
    index order.  On a mesh, ``grads`` are the rank's part of the tree
    (maybe none, then ``device`` says where to work) and ``reduce`` maps
    their sum, a float32 tensor of one element, to the total over the ranks;
    the norm and scale are the total's."""
    grads = list(grads)
    if device is None:
        if not grads:
            raise ValueError("adamw_norm: no gradients")
        device = grads[0].device
    for i, g in enumerate(grads):
        _check("adamw_norm", device, **{f"grads[{i}]": g})
    blocks = [_blocks(g.numel()) for g in grads]
    partial = torch.empty(max(sum(blocks), 1), dtype=torch.float32, device=device)
    out = torch.empty(3, dtype=torch.float32, device=device)  # norm, scale, rank's sum
    _build.build_train()
    at = partial.data_ptr()
    for g, nb in zip(grads, blocks):
        if nb:
            _build.launch("adamw", "adamw_norm_partial", _NORM_PARTIAL_ARGTYPES, device,
                          g, g.numel(), int(g.dtype == torch.bfloat16), at, nb)
        at += 4 * nb
    count = sum(blocks)
    if reduce is not None:
        _build.launch("adamw", "adamw_norm_sum", _NORM_SUM_ARGTYPES, device, partial, count,
                      out[2])
        partial, count = reduce(out[2:]), 1
        if partial.dtype != torch.float32 or partial.numel() != 1 or partial.device != device:
            raise ValueError(f"adamw_norm: reduce gave {partial.dtype} {tuple(partial.shape)} on "
                             f"{partial.device}; expected one float32 value on {device}")
    _build.launch("adamw", "adamw_norm_finish", _NORM_FINISH_ARGTYPES, device, partial,
                  count, 0.0 if clip_norm is None else float(clip_norm),
                  int(clip_norm is not None), out[0], out[1])
    adamw_norm.launches += 1
    return out[0], out[1]


adamw_norm.launches = 0


def adamw_update(p, g, m, v, scale, lr, bc1, bc2, *, b1: float, b2: float, eps: float,
                 weight_decay: float) -> None:
    """One leaf's AdamW step in place: ``p`` (the master) and the moments
    ``m``, ``v`` from the gradient ``g``, with the clip ``scale``, ``lr`` and
    the bias corrections ``bc1``, ``bc2`` given as 0-d float32 tensors on the
    leaf's device."""
    device = p.device
    _check("adamw_update", device, p=p, g=g, m=m, v=v)
    if not p.shape == g.shape == m.shape == v.shape:
        raise ValueError(f"adamw_update: p {tuple(p.shape)}, g {tuple(g.shape)}, m "
                         f"{tuple(m.shape)} and v {tuple(v.shape)} differ")
    if m.dtype != v.dtype:
        raise TypeError(f"adamw_update: m is {m.dtype} and v {v.dtype}")
    for what, x in (("scale", scale), ("lr", lr), ("bc1", bc1), ("bc2", bc2)):
        if x.dtype != torch.float32 or x.numel() != 1 or x.device != device:
            raise ValueError(f"adamw_update: {what} must be one float32 value on {device}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
    n = p.numel()
    if n:
        _build.build_train()
        bf = lambda x: int(x.dtype == torch.bfloat16)
        _build.launch("adamw", "adamw_update", _UPDATE_ARGTYPES, device, p, g, m, v, n, bf(p),
                      bf(g), bf(m), scale, lr, bc1, bc2, b1, b2, 1 - b1, 1 - b2, eps,
                      weight_decay, _blocks(n))
        adamw_update.launches += 1


adamw_update.launches = 0
