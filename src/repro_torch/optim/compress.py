"""Gradient compression (port of ``repro.optim.compress``): int8 with error feedback.

Symmetric per-tensor int8 quantization with a float32 scale, rounding half
to even as the reference does; ``compress_grads`` carries each
quantization's residual to the next step.  ``compressed_psum`` is the
reference's ``shard_map`` collective as a ``torch.distributed`` all-reduce:
the MAX of the per-rank amax first (one scalar), so every rank quantizes
with one scale, then the SUM of the int8 payloads as int32 (no overflow for
up to 2^23 ranks), then the rescale.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from ..models.params import tree_leaves, tree_map

__all__ = ["quantize_int8", "dequantize_int8", "compress_grads", "compressed_psum"]


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization; returns (q, scale)."""
    xf = x.float()
    scale = torch.clamp(xf.abs().max(), min=1e-12) / 127.0
    return _quantize(xf, scale), scale


def _quantize(xf: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def compress_grads(grads: Any, error_buf: Any) -> tuple[Any, Any]:
    """Quantize grads+error with feedback; returns (dequantized, new_error).

    new_error = (g + e) - dequant(quant(g + e)).
    """
    def one(g, e):
        target = g.float() + e
        q, s = quantize_int8(target)
        d = dequantize_int8(q, s)
        return d.to(g.dtype), target - d

    out = [one(g, e) for g, e in zip(tree_leaves(grads), tree_leaves(error_buf))]
    deq, err = iter([d for d, _ in out]), iter([r for _, r in out])
    return tree_map(lambda _: next(deq), grads), tree_map(lambda _: next(err), grads)


def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """int8-payload all-reduce over ``group`` (the default process group if None).

    The int8 payloads are summed as int32, as the reference sums them (no
    overflow for up to 2^23 ranks), so the sum moves 4 bytes an element, as
    a float32 all-reduce does, plus one float32 scalar for the shared scale.
    """
    xf = x.float()
    amax = xf.abs().max()
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    total = _quantize(xf, scale).to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return (total.float() * scale).to(x.dtype)
