"""Flash attention for Hopper (prefill), with its plain twin.

``flash_attention(q, k, v, causal)`` computes what the Pallas kernel of
``src/repro/kernels/flash_attention.py`` computes: online-softmax attention
over ``(B, H, S, Dh)`` queries and ``(B, Hkv, T, Dh)`` keys and values, f32
running max/sum/accumulator, ``p`` rounded to V's type before the ``p v``
product, ``l`` clamped at 1e-20, and a top-left causal mask ``qpos >= kpos``.
Grouped-query attention is taken as it is: ``Hkv`` divides ``H`` and q head
``h`` reads kv head ``h // (H // Hkv)``, so nothing is head-repeated;
``Hkv = H`` is the reference's head-repeated input.  Any S and T are taken
(the kernel masks the ragged edge).

The kernel lives in ``csrc/flash_attention.cu`` (bf16 on the tensor cores
through TMA and ``wgmma``, float32 on the CUDA cores) and is launched through
ctypes on PyTorch's current stream.  Given CUDA tensors the wrapper launches
it or raises; given CPU tensors it runs the twin
:func:`~repro_torch.kernels.ref.flash_attention_ref`.  The wrapper counts its
launches in its ``launches`` attribute.  It is forward only, on either
device: with grad mode on, an input that requires grad raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .ref import flash_attention_ref

__all__ = ["MAX_HEAD_DIM", "flash_attention"]

#: Largest head size the kernel takes (a multiple of 16 up to this).
MAX_HEAD_DIM = 256

_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]


def flash_attention(q, k, v, causal: bool = True) -> torch.Tensor:
    """Attention of ``q (B, H, S, Dh)`` over ``k, v (B, Hkv, T, Dh)`` -> ``(B, H, S, Dh)``.

    Replaces ``src/repro/kernels/flash_attention.py::flash_attention``
    (``_flash_kernel``, grid ``(B*H, S/q_block)``).  At the serving path's
    prefill the tensor cores bound it (the two products), not device memory.
    One CTA per (b*h, 128-row q tile): a producer warp streams K/V tiles
    through a TMA ring, two consumer warpgroups run both products on
    ``wgmma``; causal CTAs stop at the diagonal tile.
    """
    _build.check_forward_only("flash_attention", q, k, v)
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError("q must be (B, H, S, Dh) and k, v (B, Hkv, T, Dh)")
    b, h, s, dh = q.shape
    hkv = k.shape[1]
    if k.shape[0] != b or k.shape[3] != dh or hkv == 0 or h % hkv:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if not q.is_cuda:
        return flash_attention_ref(q, k, v, causal)
    if q.dtype not in _SUFFIX:
        raise TypeError(f"flash_attention takes bfloat16 or float32, got {q.dtype}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{name} is {x.dtype} on {x.device}; expected {q.dtype} on {q.device}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if dh % 16 or dh > MAX_HEAD_DIM:
        raise ValueError(f"head size {dh} must be a multiple of 16 up to {MAX_HEAD_DIM}")
    t = k.shape[2]
    if b * h >= 2**16:
        raise ValueError(f"B * H = {b * h} exceeds the kernel's grid (65,535)")
    out = torch.empty_like(q)
    _build.launch("flash_attention", f"flash_attention_{_SUFFIX[q.dtype]}", _ARGTYPES,
                  q.device, q, k, v, out, b * h, b * hkv, s, t, dh, int(causal),
                  1.0 / math.sqrt(dh))
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
