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
from torch.utils.checkpoint import checkpoint

__all__ = [
    "apply_mrope",
    "apply_rope",
    "chunked_attention",
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
    product in the activation type.  Leading axes batch, so the training
    path runs every expert at once over ``(E, C, D)`` slabs and ``(E, D, F)``
    weights."""
    h = (F.silu(dot_f32(x, w_gate)) * dot_f32(x, w_up)).to(x.dtype)
    return h @ w_down


# ---------------------------------------------------------------------------
# Attention helpers
# ---------------------------------------------------------------------------


def _kv_step(qf, kb, vb, m_prev, l_prev, acc, k0: int, t: int, causal: bool, pad: bool):
    """One KV chunk of :func:`chunked_attention`: the running max ``m``, sum
    ``l`` and accumulator ``acc`` after keys ``k0 .. k0 + kc``.  ``qf`` is
    ``(B, Hkv, G, S, Dh)`` float32, ``kb``/``vb`` ``(B, Hkv, kc, Dh)``."""
    s_len, kc = qf.shape[3], kb.shape[2]
    sblk = (qf @ kb.float().unsqueeze(2).transpose(-1, -2)) * (1.0 / math.sqrt(qf.shape[-1]))
    kpos = k0 + torch.arange(kc, device=qf.device)
    if causal or pad:
        mask = (kpos < t).expand(s_len, kc)
        if causal:
            mask = mask & (torch.arange(s_len, device=qf.device)[:, None] >= kpos[None, :])
        sblk = sblk.masked_fill(~mask, float("-inf"))
    m_new = torch.maximum(m_prev, sblk.amax(dim=-1))
    safe_m = torch.where(torch.isfinite(m_new), m_new, 0.0)
    p = torch.exp(sblk - safe_m[..., None])
    p = torch.where(torch.isfinite(sblk), p, 0.0)
    alpha = torch.where(torch.isfinite(m_prev), torch.exp(m_prev - safe_m), 0.0)
    l_new = l_prev * alpha + p.sum(dim=-1)
    pv = p.to(vb.dtype).float() @ vb.float().unsqueeze(2)
    return m_new, l_new, acc * alpha[..., None] + pv


def chunked_attention(q, k, v, *, causal: bool = True, kv_chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention over KV chunks; never builds the (S, T) scores.

    q: ``(B, H, S, Dh)``; k, v: ``(B, Hkv, T, Dh)`` with ``Hkv | H`` (q head
    h reads kv head ``h // (H // Hkv)``; ``Hkv = H`` is the reference's
    head-repeated input).  Returns ``(B, H, S, Dh)`` in q's type.  The
    reference's arithmetic: scores, ``m``, ``l`` and ``acc`` in float32, ``p``
    rounded to V's type before the ``p v`` product, ``l`` clamped at 1e-20;
    a ragged T is padded and masked; causality by absolute offsets
    (``qpos >= kpos``), so cross-attention (``causal=False``) shares it.
    Each KV step runs under ``torch.utils.checkpoint`` (the reference's
    ``jax.checkpoint``): its ``(B, H, S, kc)`` probabilities are recomputed
    in the backward pass, not kept for every step.
    """
    b, h, s, dh = q.shape
    hkv, t = k.shape[1], k.shape[2]
    kv_chunk = min(kv_chunk, t)
    pad = (-t) % kv_chunk
    if pad:
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
    qf = q.float().reshape(b, hkv, h // hkv, s, dh)
    m = torch.full(qf.shape[:-1], float("-inf"), device=q.device)
    l = torch.zeros(qf.shape[:-1], device=q.device)
    acc = torch.zeros(qf.shape, device=q.device)
    for k0 in range(0, t + pad, kv_chunk):
        m, l, acc = checkpoint(_kv_step, qf, k[:, :, k0:k0 + kv_chunk], v[:, :, k0:k0 + kv_chunk],
                               m, l, acc, k0, t, causal, bool(pad), use_reentrant=False)
    out = acc / l.clamp(min=1e-20)[..., None]
    return out.reshape(b, h, s, dh).to(q.dtype)


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
