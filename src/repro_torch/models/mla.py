"""Multi-head latent attention (DeepSeek-V2/V3, MLA) for training.

A layer's weights (``cfg.mla``: latent ``R``, query/key heads of ``Dn + Dr``
split into a part without RoPE and a RoPE part, value heads ``Dv``):
``wq (D, H (Dn + Dr))``, ``wkv_a (D, R + Dr)``, ``kv_norm (R,)``, ``wkv_b
(R, H (Dn + Dv))`` and ``wo (H Dv, D)``, with the pre-norm ``norm (D,)``.
From the normed ``x``:

  1. ``q = x wq``, each head split into ``q_nope`` (Dn) and ``q_rope`` (Dr);
  2. ``x wkv_a`` split into the latent ``c`` (R) and one ``k_rope`` head (Dr)
     that every head shares;
  3. ``RMSNorm(c) wkv_b``, each head split into ``k_nope`` (Dn) and ``v`` (Dv);
  4. RoPE of ``q_rope`` and ``k_rope``, their pairs read as DeepSeek-V3's
     modeling code reads them: it de-interleaves the RoPE part (even entries
     first, then the odd) before its rotate-half, so pair ``i`` is entries
     ``2i`` and ``2i + 1`` (:func:`deinterleave`);
  5. ``q = [q_nope, q_rope]``, ``k = [k_nope, k_rope]`` (``k_rope`` broadcast to
     every head), causal attention with the softmax scale ``(Dn + Dr) ** -0.5``
     through :func:`~repro_torch.models.layers.chunked_attention`.

Steps 1-5 up to the attention run under the span ``repro_torch.mla.project``;
the attention under its own, ``repro_torch.attention``; the output projection
from ``H Dv`` is the caller's.  Serving would keep the latent as its cache
(and absorb ``wkv_b`` into q and the output for decode); the port has no such
cache yet, and refuses to serve MLA.
"""
from __future__ import annotations

import torch

from ..runtime import spans
from .layers import apply_rope, chunked_attention, init_linear, init_rms_norm, linear, rms_norm

__all__ = ["attend", "deinterleave", "init_mla_params", "project"]


def init_mla_params(gen, cfg, dtype) -> dict:
    d, h, a = cfg.d_model, cfg.n_heads, cfg.mla
    return {
        "norm": init_rms_norm(d, dtype, gen.device),
        "wq": init_linear(gen, d, h * (a.qk_nope_head_dim + a.qk_rope_head_dim), dtype),
        "wkv_a": init_linear(gen, d, a.kv_lora_rank + a.qk_rope_head_dim, dtype),
        "kv_norm": init_rms_norm(a.kv_lora_rank, dtype, gen.device),
        "wkv_b": init_linear(gen, a.kv_lora_rank, h * (a.qk_nope_head_dim + a.v_head_dim), dtype),
        "wo": init_linear(gen, h * a.v_head_dim, d, dtype),
    }


def deinterleave(x: torch.Tensor) -> torch.Tensor:
    """The last dim's even entries, then its odd ones: the pair ``(x[2i],
    x[2i + 1])`` moves to rotate-half's places ``(i, i + Dr / 2)``."""
    return x.unflatten(-1, (x.shape[-1] // 2, 2)).transpose(-1, -2).flatten(-2)


@spans.traced("repro_torch.mla.project")
def project(cfg, x, positions, wq, wkv_a, kv_norm, wkv_b):
    """``(q, k, v)`` of the normed ``x (B, S, D)`` at ``positions (B, S)``
    under the layer's weights: q and k ``(B, H, S, Dn + Dr)`` roped, v
    ``(B, H, S, Dv)``."""
    a = cfg.mla
    b, s, _ = x.shape
    h, dn, dr = cfg.n_heads, a.qk_nope_head_dim, a.qk_rope_head_dim
    q_nope, q_rope = linear(x, wq).view(b, s, h, dn + dr).transpose(1, 2).split([dn, dr], -1)
    latent, k_rope = linear(x, wkv_a).split([a.kv_lora_rank, dr], -1)
    kv = linear(rms_norm(latent, kv_norm, cfg.norm_eps), wkv_b)
    k_nope, v = kv.view(b, s, h, dn + a.v_head_dim).transpose(1, 2).split([dn, a.v_head_dim], -1)
    q_rope = apply_rope(deinterleave(q_rope), positions, cfg.rope_theta)
    k_rope = apply_rope(deinterleave(k_rope[:, None]), positions, cfg.rope_theta)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(b, h, s, dr)], dim=-1)
    return q, k, v


def attend(p, cfg, x, positions) -> torch.Tensor:
    """Causal latent attention of the normed ``x (B, S, D)``: ``(B, H, S, Dv)``."""
    q, k, v = project(cfg, x, positions, p["wq"], p["wkv_a"], p["kv_norm"], p["wkv_b"])
    return chunked_attention(q, k, v, causal=True, kv_chunk=cfg.attn_chunk_kv)
