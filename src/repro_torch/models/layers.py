"""Shared neural-net primitives of the serving path (port of ``repro.models.layers``).

Conventions as in the reference: activations ``(B, S, D)``; attention in the
flat-head layout ``(B, H, S, Dh)`` (K/V ``(B, Hkv, S, Dh)``, not repeated:
the prefill kernel reads kv head ``h // (H // Hkv)`` for q head ``h``), and
the cache in its native ``(B, T, Hkv, Dh)`` layout for decode; norms, RoPE
and softmax in float32 whatever the activation type; weights in
``(d_in, d_out)`` layout (``x @ w``).  The pure-JAX ``chunked_attention``
stays in the reference: prefill attention goes through
:func:`repro_torch.kernels.flash_attention`.
"""
from __future__ import annotations

import itertools
import math

import torch
import torch.nn.functional as F

__all__ = [
    "apply_mrope",
    "apply_rope",
    "decode_attention",
    "dot_f32",
    "init_embedding",
    "init_linear",
    "init_rms_norm",
    "make_rope_cache",
    "rms_norm",
    "swiglu",
]


# ---------------------------------------------------------------------------
# Init helpers (float32 normal draws from a torch.Generator, then cast)
# ---------------------------------------------------------------------------


def init_linear(gen: torch.Generator, d_in: int, d_out: int, dtype) -> torch.Tensor:
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device, dtype=torch.float32)
    return w.mul_(1.0 / math.sqrt(d_in)).to(dtype)


def init_rms_norm(d: int, dtype, device) -> torch.Tensor:
    return torch.ones((d,), dtype=dtype, device=device)


def init_embedding(gen: torch.Generator, vocab: int, d: int, dtype) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, device=gen.device, dtype=torch.float32)
    return w.mul_(0.02).to(dtype)


# ---------------------------------------------------------------------------
# Products, norms and rotary embeddings
# ---------------------------------------------------------------------------


def dot_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` accumulated and returned in float32 (the reference's
    ``preferred_element_type=float32`` product)."""
    if x.dtype == w.dtype == torch.float32:
        return x @ w
    return x.float() @ w.float()


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def make_rope_cache(positions: torch.Tensor, d_head: int, theta: float):
    """cos/sin tables ``(..., S, d_head // 2)`` for positions ``(..., S)``."""
    half = d_head // 2
    exponent = -torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32, device=positions.device),
                      exponent)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate pairs (x[..., :half], x[..., half:]) by cos/sin (rotate-half)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: ``(B, H, S, Dh)``; positions: ``(B, S)``."""
    cos, sin = make_rope_cache(positions, x.shape[-1], theta)  # (B, S, half)
    shape = (cos.shape[0],) + (1,) * (x.dim() - 3) + tuple(cos.shape[1:])
    return _rotate(x, cos.reshape(shape), sin.reshape(shape))


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, sections, theta: float) -> torch.Tensor:
    """Multimodal RoPE (qwen2-vl §2): three position streams (t, h, w).

    x: ``(B, ..., S, Dh)``; positions3: ``(3, B, S)``.  ``sections`` gives how
    many of the ``Dh // 2`` frequency pairs take their position from each
    stream, in order (``sum(sections) == Dh // 2``).
    """
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to {half}")
    cos3, sin3 = make_rope_cache(positions3, x.shape[-1], theta)  # (3, B, S, half)
    # Pair i's angle from the stream whose section holds it: each stream's
    # slice of its own table, side by side -> (B, S, half).  Slices, not an
    # index tensor, so no host-to-device copy per call.
    ends = list(itertools.accumulate(sections))
    spans = list(zip([0] + ends[:-1], ends))
    cos = torch.cat([cos3[i, ..., lo:hi] for i, (lo, hi) in enumerate(spans)], dim=-1)
    sin = torch.cat([sin3[i, ..., lo:hi] for i, (lo, hi) in enumerate(spans)], dim=-1)
    shape = (cos.shape[0],) + (1,) * (x.dim() - 3) + tuple(cos.shape[1:])
    return _rotate(x, cos.reshape(shape), sin.reshape(shape))


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------


def swiglu(x, w_gate, w_up, w_down) -> torch.Tensor:
    """SwiGLU feed-forward: gate and up in float32, ``h`` and the down
    product in the activation type."""
    h = (F.silu(dot_f32(x, w_gate)) * dot_f32(x, w_up)).to(x.dtype)
    return h @ w_down


# ---------------------------------------------------------------------------
# Attention helpers
# ---------------------------------------------------------------------------


def decode_attention(q, k_cache, v_cache, pos) -> torch.Tensor:
    """One-token attention over the cache in its native layout.

    q: ``(B, H, 1, Dh)``; caches ``(B, T, Hkv, Dh)``; keys ``t < pos`` are
    valid (``pos`` an int or a ``(B,)`` tensor).  Scores and the ``p v``
    product in float32, ``p`` rounded to the cache's type first; no head
    repeat (q head h reads kv head h // G).  No kernel: the reference has none.
    """
    b, t, hkv = k_cache.shape[:3]
    h, dh = q.shape[1], q.shape[-1]
    g = h // hkv
    qg = q[:, :, 0, :].reshape(b, hkv, g, dh).float()
    s = torch.einsum("bhgd,bthd->bhgt", qg, k_cache.float()) / math.sqrt(dh)
    tpos = torch.arange(t, device=q.device)
    if isinstance(pos, torch.Tensor) and pos.dim() == 1:
        valid = tpos[None, :] < pos[:, None].to(q.device)  # (B, T)
        s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    else:
        s = s.masked_fill(tpos >= int(pos), float("-inf"))
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bhgt,bthd->bhgd", p.float(), v_cache.float())
    return out.reshape(b, h, 1, dh).to(q.dtype)
