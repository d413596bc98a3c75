"""Dense and MoE transformer stacks for serving (port of ``repro.models.transformer``).

The reference scans one stacked layer body with ``lax.scan``; here each layer
is its own :class:`~repro_torch.models.params.Params` module in
``params.blocks`` and a Python loop walks them.  Only the ``dense`` and
``moe`` families are ported, without M-RoPE or modality front ends; the
``ssm``, ``hybrid`` and ``encdec`` families raise ``NotImplementedError``.
Prefill attention runs the flash kernel on the un-repeated (GQA) K/V; decode
attention is plain PyTorch over the cache, which ``forward_decode`` updates
in place (the reference returns a new cache; the port saves the copy).
"""
from __future__ import annotations

import torch

from ..kernels import flash_attention
from .layers import (
    apply_rope,
    decode_attention,
    dot_f32,
    init_embedding,
    init_linear,
    init_rms_norm,
    rms_norm,
    swiglu,
)
from .moe import init_moe_params, moe_ffn
from .params import Params

__all__ = [
    "attn_block_decode",
    "attn_block_prefill",
    "cast_params_for_compute",
    "check_supported",
    "forward_decode",
    "forward_prefill",
    "init_cache",
    "init_params",
    "lm_head",
    "mlp_block",
    "moe_block",
    "moe_capacity",
]


def _dtype(cfg):
    return torch.bfloat16 if cfg.param_dtype == "bfloat16" else torch.float32


def _cdtype(cfg):
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` naming what of ``cfg`` the port lacks."""
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported to repro_torch yet "
            "(dense and moe are)")
    if cfg.mrope or cfg.frontend:
        what = "M-RoPE" if cfg.mrope else f"the {cfg.frontend} front end"
        raise NotImplementedError(f"{cfg.name}: {what} is not ported to repro_torch yet")


#: Param leaves that stay float32 under mixed precision (routing decisions,
#: SSD decay rates — small, numerically sensitive).
_KEEP_F32 = ("router", "gate", "dt_bias", "A_log", "D")


def cast_params_for_compute(params: Params, cfg) -> Params:
    """Mixed precision: compute-type copies of the (f32 master) weights.

    Leaves named in ``_KEEP_F32`` and leaves already of the compute type are
    shared with ``params``, not copied.
    """
    cd = _cdtype(cfg)

    def one(name, p):
        if name in _KEEP_F32 or not p.is_floating_point():
            return p
        return p.to(cd)

    return params.map(one)


def moe_capacity(cfg, n_tokens: int) -> int:
    """Static per-expert capacity for a microbatch of ``n_tokens``.

    Rounded to a multiple of 128 above 128 tokens (8 below), as the reference
    rounds it.
    """
    e = cfg.moe
    cap = int(n_tokens * e.top_k / e.n_experts * e.capacity_factor)
    cap = max(cap, e.top_k, 8)
    if cap > 128:
        return ((cap + 127) // 128) * 128
    return ((cap + 7) // 8) * 8


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------


def _init_attn(gen, cfg) -> dict:
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    dt = _dtype(cfg)
    p = {
        "norm": init_rms_norm(d, dt, gen.device),
        "wq": init_linear(gen, d, hq * dh, dt),
        "wk": init_linear(gen, d, hkv * dh, dt),
        "wv": init_linear(gen, d, hkv * dh, dt),
        "wo": init_linear(gen, hq * dh, d, dt),
    }
    if cfg.qk_norm:
        p["q_norm"] = init_rms_norm(dh, dt, gen.device)
        p["k_norm"] = init_rms_norm(dh, dt, gen.device)
    return p


def _init_ffn(gen, cfg) -> dict:
    dt = _dtype(cfg)
    norm = init_rms_norm(cfg.d_model, dt, gen.device)
    if cfg.ffn_kinds()[0] == "moe":
        return {"norm": norm, "moe": init_moe_params(gen, cfg.d_model, cfg.moe, dt)}
    d, f = cfg.d_model, cfg.d_ff
    return {
        "norm": norm,
        "w_gate": init_linear(gen, d, f, dt),
        "w_up": init_linear(gen, d, f, dt),
        "w_down": init_linear(gen, f, d, dt),
    }


def init_params(cfg, seed: int, device) -> Params:
    """Random weights for the dense and moe families, drawn on ``device``
    from a ``torch.Generator`` seeded with ``seed`` (not the reference's
    numbers: carry those across with ``params_from_reference``)."""
    check_supported(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = _dtype(cfg)
    tree = {
        "embed": init_embedding(gen, cfg.vocab_size, cfg.d_model, dt),
        "final_norm": init_rms_norm(cfg.d_model, dt, gen.device),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = init_linear(gen, cfg.d_model, cfg.vocab_size, dt)
    tree["blocks"] = [{"attn": _init_attn(gen, cfg), "ffn": _init_ffn(gen, cfg)}
                      for _ in range(cfg.n_layers)]
    return Params(tree)


# ---------------------------------------------------------------------------
# Attention block
# ---------------------------------------------------------------------------


def _project_qkv(p, cfg, x):
    """q in flat-head layout (B, H, S, Dh); k/v in cache layout (B, S, Hkv, Dh)."""
    b, s = x.shape[:2]
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = (x @ p["wq"]).reshape(b, s, hq, dh).transpose(1, 2)
    k = (x @ p["wk"]).reshape(b, s, hkv, dh)
    v = (x @ p["wv"]).reshape(b, s, hkv, dh)
    if cfg.qk_norm:  # before RoPE, as the reference
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _rope_k(cfg, k, positions):
    """RoPE over T of k in cache layout (B, T, Hkv, Dh)."""
    return apply_rope(k.transpose(1, 2), positions, cfg.rope_theta).transpose(1, 2)


def attn_block_prefill(p, cfg, h, positions):
    """Causal self-attention over the prompt, residual included.

    Returns ``(h, k, v)`` with k/v ``(B, S, Hkv, Dh)`` for the cache.
    """
    x = rms_norm(h, p["norm"], cfg.norm_eps)
    q, k, v = _project_qkv(p, cfg, x)
    q = apply_rope(q, positions, cfg.rope_theta).contiguous()
    k = _rope_k(cfg, k, positions)
    # Un-repeated (B, Hkv, S, Dh) K/V: q head h reads kv head h // (H // Hkv).
    out = flash_attention(q, k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous(),
                          causal=True)
    b, hq, s, dh = out.shape
    out = out.transpose(1, 2).reshape(b, s, hq * dh)
    return h + out @ p["wo"], k, v


def attn_block_decode(p, cfg, h, k_cache, v_cache, pos: int):
    """One-token attention.  h: (B, 1, D); caches (B, T, Hkv, Dh), written at
    ``pos`` in place; keys ``t < pos + 1`` are attended."""
    x = rms_norm(h, p["norm"], cfg.norm_eps)
    q, k_new, v_new = _project_qkv(p, cfg, x)
    positions = torch.full((h.shape[0], 1), pos, dtype=torch.int32, device=h.device)
    q = apply_rope(q, positions, cfg.rope_theta)
    k_cache[:, pos] = _rope_k(cfg, k_new, positions)[:, 0].to(k_cache.dtype)
    v_cache[:, pos] = v_new[:, 0].to(v_cache.dtype)
    out = decode_attention(q, k_cache, v_cache, pos + 1)  # (B, H, 1, Dh)
    b, hq, _, dh = out.shape
    out = out.transpose(1, 2).reshape(b, 1, hq * dh)
    return h + out @ p["wo"], k_cache, v_cache


# ---------------------------------------------------------------------------
# FFN blocks
# ---------------------------------------------------------------------------


def mlp_block(p, cfg, h):
    x = rms_norm(h, p["norm"], cfg.norm_eps)
    return h + swiglu(x, p["w_gate"], p["w_up"], p["w_down"])


def moe_block(p, cfg, h, capacity: int):
    b, s, d = h.shape
    x = rms_norm(h, p["norm"], cfg.norm_eps).reshape(b * s, d)
    y, aux = moe_ffn(x, p["moe"], cfg.moe.n_experts, cfg.moe.top_k, capacity)
    return h + y.reshape(b, s, d), aux


def _ffn(p, cfg, h, capacity: int):
    if cfg.ffn_kinds()[0] == "moe":
        return moe_block(p, cfg, h, capacity)[0]
    return mlp_block(p, cfg, h)


# ---------------------------------------------------------------------------
# KV cache, prefill and decode
# ---------------------------------------------------------------------------


def init_cache(cfg, batch_size: int, max_len: int, device) -> dict:
    """Decode-time KV cache (zeros; prefill fills it): k/v ``(L, B, T, Hkv, Dh)``."""
    check_supported(cfg)
    shape = (cfg.n_layers, batch_size, max_len, cfg.n_kv_heads, cfg.d_head)
    dt = _cdtype(cfg)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def _embed(params, cfg, tokens):
    return params["embed"][tokens].to(_cdtype(cfg))


def forward_prefill(params, cfg, batch: dict, max_len: int):
    """Returns (last-position hidden (B, D), cache with the prompt's k/v)."""
    check_supported(cfg)
    tokens = batch["tokens"]
    h = _embed(params, cfg, tokens)
    b, s, _ = h.shape
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=h.device).expand(b, s)
    cap = moe_capacity(cfg, b * s) if cfg.ffn_kinds()[0] == "moe" else 0
    cache = init_cache(cfg, b, max_len, h.device)
    for i, blk in enumerate(params["blocks"]):
        h, k, v = attn_block_prefill(blk["attn"], cfg, h, positions)
        h = _ffn(blk["ffn"], cfg, h, cap)
        cache["k"][i, :, :s] = k
        cache["v"][i, :, :s] = v
    return rms_norm(h[:, -1, :], params["final_norm"], cfg.norm_eps), cache


def forward_decode(params, cfg, cache: dict, batch: dict, pos: int):
    """One decode step.  batch: ``{'tokens': (B, 1)}``; ``pos`` is the write
    position (current sequence length).  Returns (logits (B, vocab) in
    float32, cache updated in place)."""
    check_supported(cfg)
    h = _embed(params, cfg, batch["tokens"])
    pos = int(pos)
    cap = moe_capacity(cfg, h.shape[0]) if cfg.ffn_kinds()[0] == "moe" else 0
    for i, blk in enumerate(params["blocks"]):
        h, _, _ = attn_block_decode(blk["attn"], cfg, h, cache["k"][i], cache["v"][i], pos)
        h = _ffn(blk["ffn"], cfg, h, cap)
    h = rms_norm(h[:, 0, :], params["final_norm"], cfg.norm_eps)
    return dot_f32(h, lm_head(params, cfg)), cache


def lm_head(params, cfg) -> torch.Tensor:
    """The (D, vocab) output projection (the embedding's transpose when tied)."""
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]
