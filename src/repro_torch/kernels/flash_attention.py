"""Flash attention for Hopper (prefill, and training's forward and backward), with plain twins.

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
:func:`~repro_torch.kernels.ref.flash_attention_ref`; given meta tensors
(the dry-run) it returns an empty output and reports the causal pairs'
products and the bytes of q, k, v and the output to
:func:`~repro_torch.kernels._build.count_meta`.  The wrapper counts its
launches in its ``launches`` attribute.  It is forward only, on either
device: with grad mode on, an input that requires grad raises.

Training differentiates :func:`~repro_torch.models.layers.chunked_attention`,
whose bf16 inputs on a card take :func:`flash_attention_train` (the same
forward kernel, with values ``(B, Hkv, T, Dv)`` at most as wide as the q/k
heads, keeping each row's log-sum-exp) and :func:`flash_attention_backward`
(``csrc/flash_attention_bwd.cu``: dq, dk and dv on the tensor cores, from the
saved output and log-sum-exp).  Those two are called by an autograd function,
not differentiated themselves; on CPU tensors they run their twins
(:func:`~repro_torch.kernels.ref.flash_attention_train_ref` and
:func:`~repro_torch.kernels.ref.flash_attention_backward_ref`), and each
counts its launches as ``flash_attention`` does.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .ref import flash_attention_backward_ref, flash_attention_ref, flash_attention_train_ref

__all__ = ["MAX_HEAD_DIM", "flash_attention", "flash_attention_backward", "flash_attention_train"]

#: Largest head size the kernel takes (a multiple of 16 up to this).
MAX_HEAD_DIM = 256

_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
_TRAIN_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
_BACKWARD_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_float,
                                                                   ctypes.c_void_p]


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
    if q.is_meta:  # the dry-run: nothing runs, the kernel is counted by its formula
        t = k.shape[2]
        pairs = sum(min(i + 1, t) for i in range(s)) if causal else s * t
        _build.count_meta("flash_attention", 4 * b * h * dh * pairs,
                          q.element_size() * (2 * q.numel() + k.numel() + v.numel()))
        return torch.empty_like(q)
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


def _check_train(q, k, v, **more) -> None:
    """The training kernels' contract: ``q (B, H, S, Dh)``, ``k (B, Hkv, T,
    Dh)``, ``v (B, Hkv, T, Dv)``, ``Hkv | H``, Dh and ``Dv <= Dh`` multiples
    of 16 up to :data:`MAX_HEAD_DIM`; on a card, bf16 q, k and v, and they
    and ``more`` (the backward pass's tensors, by name) contiguous, 16-byte
    aligned and on q's device."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q must be (B, H, S, Dh), k (B, Hkv, T, Dh) and v (B, Hkv, T, Dv)")
    b, h, _, dh = q.shape
    hkv, t, dv = k.shape[1], k.shape[2], v.shape[3]
    if (k.shape[0] != b or k.shape[3] != dh or tuple(v.shape[:3]) != (b, hkv, t) or hkv == 0
            or h % hkv):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match q {tuple(q.shape)}")
    if dh % 16 or dh > MAX_HEAD_DIM or dv % 16 or dv == 0 or dv > dh:
        raise ValueError(f"head sizes Dh {dh} and Dv {dv} must be multiples of 16 with "
                         f"Dv <= Dh <= {MAX_HEAD_DIM}")
    if not q.is_cuda:
        return
    if not q.dtype == k.dtype == v.dtype == torch.bfloat16:
        raise TypeError(f"the training kernels take bfloat16 q, k and v, got {q.dtype}, "
                        f"{k.dtype} and {v.dtype}")
    for name, x in (("q", q), ("k", k), ("v", v), *more.items()):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}; expected {q.device}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if b * h >= 2**16:
        raise ValueError(f"B * H = {b * h} exceeds the kernels' grid (65,535)")


def flash_attention_train(q, k, v, causal: bool = True):
    """The training forward: ``(out (B, H, S, Dv), lse (B, H, S) float32)``.

    ``out`` is what :func:`flash_attention` computes, with values ``v (B,
    Hkv, T, Dv)`` at most as wide as the q/k heads (latent attention's are
    narrower); ``lse`` each row's natural log-sum-exp of its scaled scores,
    from which :func:`flash_attention_backward` recomputes the
    probabilities.  The same kernel as the prefill (``flash_bf16_kernel``,
    the value heads padded to a multiple of 64 in shared memory), bf16
    only.  Not differentiable itself: the training path calls it from an
    autograd function."""
    _check_train(q, k, v)
    if not q.is_cuda:
        return flash_attention_train_ref(q, k, v, causal)
    _build.build_train()
    b, h, s, dh = q.shape
    hkv, t, dv = k.shape[1], k.shape[2], v.shape[3]
    out = q.new_empty((b, h, s, dv))
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    _build.launch("flash_attention", "flash_attention_train_bf16", _TRAIN_ARGTYPES, q.device,
                  q, k, v, out, lse, b * h, b * hkv, s, t, dh, dv, int(causal),
                  1.0 / math.sqrt(dh))
    flash_attention_train.launches += 1
    return out, lse


flash_attention_train.launches = 0


def flash_attention_backward(q, k, v, out, lse, dout, causal: bool = True):
    """``(dq, dk, dv)`` of :func:`flash_attention_train` given the gradient
    ``dout`` of its output, from its saved ``out`` and ``lse``.

    Three kernels (``csrc/flash_attention_bwd.cu``): ``D = rowsum(dout *
    out)`` in float32; dk and dv, one CTA per (b, kv head, 128 keys), the
    group's q heads summed inside it and causal q tiles wholly above the
    diagonal skipped; dq, one CTA per (b, q head, 128 rows).  Scores,
    probabilities, ``dP`` and ``dS`` in float32; bf16 operands with float32
    sums on the tensor cores; ``p`` rounded to v's type before its product
    with ``dout``; ``dS`` as two bf16 halves.  No atomics: two calls give the
    same bits."""
    _check_train(q, k, v, out=out, lse=lse, dout=dout)
    if not q.is_cuda:
        return flash_attention_backward_ref(q, k, v, out, lse, dout, causal)
    if out.shape != dout.shape or out.shape != (*q.shape[:3], v.shape[3]) or (
            lse.shape != q.shape[:3]):
        raise ValueError(f"out {tuple(out.shape)}, lse {tuple(lse.shape)} and dout "
                         f"{tuple(dout.shape)} do not match q {tuple(q.shape)} and v "
                         f"{tuple(v.shape)}")
    if out.dtype != torch.bfloat16 or dout.dtype != torch.bfloat16 or lse.dtype != torch.float32:
        raise TypeError("out and dout must be bfloat16 and lse float32")
    b, h, s, dh = q.shape
    hkv, t, dv = k.shape[1], k.shape[2], v.shape[3]
    dq, dk, dvv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dsum = torch.empty_like(lse)
    _build.launch("flash_attention_bwd", "flash_attention_backward_bf16", _BACKWARD_ARGTYPES,
                  q.device, q, k, v, out, lse, dout, dsum, dq, dk, dvv, b * h, b * hkv, s, t,
                  dh, dv, int(causal), 1.0 / math.sqrt(dh))
    flash_attention_backward.launches += 1
    return dq, dk, dvv


flash_attention_backward.launches = 0
