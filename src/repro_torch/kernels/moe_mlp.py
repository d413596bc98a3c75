"""Grouped expert SwiGLU for Hopper over packed capacity slabs, with its twin.

``moe_mlp(x_packed, w_gate, w_up, w_down)`` computes what the Pallas kernel of
``src/repro/kernels/moe_mlp.py`` computes, ``(silu(x Wg) * x Wu) Wd`` per
expert over ``(E, C, D)`` slabs with f32 accumulation and output in the input
type, the expert FFN of the serving path's ``moe_ffn``.  For bf16 inputs the
hidden ``h (E, C, F)`` is rounded to bf16 before the down product (what
``moe_ffn`` does); for float32 it stays float32.  Any capacity is taken.

The kernels live in ``csrc/moe_mlp.cu`` (two launches: gate/up with the
SwiGLU in its epilogue, then down; bf16 on the tensor cores through TMA and
``wgmma``, float32 on the CUDA cores) and are launched through ctypes on
PyTorch's current stream.  Given CUDA tensors the wrapper launches them or
raises; given CPU tensors it runs the twin
:func:`~repro_torch.kernels.ref.moe_mlp_ref`; given meta tensors (the
dry-run) it returns an empty output and reports every slab row's three
products and the bytes of the slab, the output and every expert's weights
to :func:`~repro_torch.kernels._build.count_meta`.  Each call adds one to the
wrapper's ``launches`` attribute (one call, two kernels).  It is forward
only, on either device: with grad mode on, an input that requires grad
raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import moe_mlp_ref

__all__ = ["moe_mlp"]

_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def moe_mlp(x_packed, w_gate, w_up, w_down) -> torch.Tensor:
    """SwiGLU expert FFN: ``x_packed (E, C, D)``, ``w_gate, w_up (E, D, F)``,
    ``w_down (E, F, D)`` -> ``(E, C, D)``.

    Replaces ``src/repro/kernels/moe_mlp.py::moe_mlp`` (``_moe_mlp_kernel``,
    grid ``(expert, token tile)``).  Bound by the tensor cores at prefill
    capacities and by reading the experts' weights at decode.  Above a
    capacity of 64, one CTA per (expert, 128-row token tile, output tile)
    streams 64-wide K-stages through a TMA ring into ``wgmma``; at 64 or less
    the operands swap (weights as the 64-row operand, tokens as its N), and
    a CTA whose expert's input rows are all zero writes +0 without reading
    that expert's weights.
    """
    _build.check_forward_only("moe_mlp", x_packed, w_gate, w_up, w_down)
    if x_packed.dim() != 3:
        raise ValueError("x_packed must be (E, C, D)")
    e, c, d = x_packed.shape
    f = w_gate.shape[-1]
    if (w_gate.shape != (e, d, f) or w_up.shape != (e, d, f)
            or w_down.shape != (e, f, d)):
        raise ValueError(f"weights {tuple(w_gate.shape)}, {tuple(w_up.shape)}, "
                         f"{tuple(w_down.shape)} do not match x_packed {tuple(x_packed.shape)}")
    if x_packed.is_meta:  # the dry-run: counted by its formula, every slab row and expert
        _build.count_meta("moe_mlp", 6 * e * c * d * f,
                          x_packed.element_size() * (2 * e * c * d + 3 * e * d * f))
        return torch.empty_like(x_packed)
    if not x_packed.is_cuda:
        return moe_mlp_ref(x_packed, w_gate, w_up, w_down)
    dtype, device = x_packed.dtype, x_packed.device
    if dtype not in _SUFFIX:
        raise TypeError(f"moe_mlp takes bfloat16 or float32, got {dtype}")
    for name, x in (("x_packed", x_packed), ("w_gate", w_gate), ("w_up", w_up),
                    ("w_down", w_down)):
        if x.dtype != dtype or x.device != device:
            raise ValueError(f"{name} is {x.dtype} on {x.device}; expected {dtype} on {device}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if d % 8 or f % 8:
        raise ValueError(f"d_model {d} and d_ff {f} must be multiples of 8")
    if e >= 2**16 or c >= 64 * 2**16:
        raise ValueError(f"{e} experts of capacity {c} exceed the kernels' grid")
    h = torch.empty((e, c, f), dtype=dtype, device=device)
    out = torch.empty_like(x_packed)
    _build.launch("moe_mlp", f"moe_mlp_{_SUFFIX[dtype]}", _ARGTYPES, device,
                  x_packed, w_gate, w_up, w_down, h, out, e, c, d, f)
    moe_mlp.launches += 1
    return out


moe_mlp.launches = 0
