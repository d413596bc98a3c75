"""Dense, MoE, SSM, hybrid and encoder-decoder stacks for serving (port of
``repro.models.transformer``).

The reference scans one stacked layer body with ``lax.scan``; here each layer
is its own :class:`~repro_torch.models.params.Params` module and a Python
loop walks them: ``params.blocks`` for the ``dense``, ``moe``, ``ssm`` and
``encdec`` (decoder) stacks, ``params.encoder`` for the encoder, and
``params.periods`` for the ``hybrid`` family, one module per attn:mamba
period holding its ``attn`` layer and lists ``mamba``, ``moe`` and ``mlp`` of
the period's other layers in order.  Every family of the reference is ported,
with M-RoPE (``positions3``) and the modality stubs (``embeds`` in place of
``tokens``, ``enc_embeds`` for the encoder).

Prefill attention runs the flash kernel on the un-repeated (GQA) K/V: causal
self-attention, the encoder's bidirectional attention and the decoder's
cross-attention over the encoder's output (non-causal, ``S != T``).  Decode
attention is plain PyTorch over the cache, as the reference's is plain JAX.
The cache holds per-layer K/V (``dense``, ``moe``), conv and SSD states
(``ssm``), both per period (``hybrid``), or K/V beside the cross-attention's
``cross_k``/``cross_v`` (``encdec``).  ``forward_decode`` updates the cache in
place (the reference returns a new cache; the port saves the copy).
"""
from __future__ import annotations

import torch

from ..kernels import flash_attention
from . import mamba2 as m2
from .layers import (
    apply_mrope,
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
    "encode",
    "forward_decode",
    "forward_prefill",
    "init_cache",
    "init_params",
    "lm_head",
    "mlp_block",
    "moe_block",
    "moe_capacity",
    "period_layers",
]

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec")


def _dtype(cfg):
    return torch.bfloat16 if cfg.param_dtype == "bfloat16" else torch.float32


def _cdtype(cfg):
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` for a family the port does not know."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported to repro_torch "
            f"({', '.join(FAMILIES)} are)")


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


def period_layers(cfg) -> list[tuple[str, int, str, int]]:
    """The layers of one ``hybrid`` period: ``(mixer, i, ffn, j)`` per layer,
    where ``i`` indexes the period's ``mamba`` list (0 for its ``attn``) and
    ``j`` its ``moe`` or ``mlp`` list, the reference's ``mi``/``mo``/``ml``
    counters."""
    period = cfg.attn_every
    seen = {"attn": 0, "mamba": 0, "moe": 0, "mlp": 0, "none": 0}
    out = []
    for mixer, ffn in zip(cfg.layer_kinds()[:period], cfg.ffn_kinds()[:period]):
        out.append((mixer, seen[mixer], ffn, seen[ffn]))
        seen[mixer] += 1
        seen[ffn] += 1
    return out


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


def _init_mlp(gen, cfg) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    dt = _dtype(cfg)
    return {
        "norm": init_rms_norm(d, dt, gen.device),
        "w_gate": init_linear(gen, d, f, dt),
        "w_up": init_linear(gen, d, f, dt),
        "w_down": init_linear(gen, f, d, dt),
    }


def _init_moe(gen, cfg) -> dict:
    return {
        "norm": init_rms_norm(cfg.d_model, _dtype(cfg), gen.device),
        "moe": init_moe_params(gen, cfg.d_model, cfg.moe, _dtype(cfg)),
    }


def _init_mamba(gen, cfg) -> dict:
    return {
        "norm": init_rms_norm(cfg.d_model, _dtype(cfg), gen.device),
        "mamba": m2.init_mamba_params(gen, cfg.d_model, cfg.ssm, _dtype(cfg)),
    }


def _init_period(gen, cfg) -> dict:
    layers = period_layers(cfg)
    p = {"attn": _init_attn(gen, cfg),
         "mamba": [_init_mamba(gen, cfg) for m, *_ in layers if m == "mamba"]}
    for kind, init in (("moe", _init_moe), ("mlp", _init_mlp)):
        n = sum(f == kind for _, _, f, _ in layers)
        if n:
            p[kind] = [init(gen, cfg) for _ in range(n)]
    return p


def init_params(cfg, seed: int, device) -> Params:
    """Random weights for any family, drawn on ``device`` from a
    ``torch.Generator`` seeded with ``seed`` (not the reference's numbers:
    carry those across with ``params_from_reference``).  ``dense``/``moe``
    take the FFN kind of layer 0 for every layer, as the reference does."""
    check_supported(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = _dtype(cfg)
    tree = {
        "embed": init_embedding(gen, cfg.vocab_size, cfg.d_model, dt),
        "final_norm": init_rms_norm(cfg.d_model, dt, gen.device),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = init_linear(gen, cfg.d_model, cfg.vocab_size, dt)
    if cfg.family == "ssm":
        tree["blocks"] = [_init_mamba(gen, cfg) for _ in range(cfg.n_layers)]
    elif cfg.family == "hybrid":
        tree["periods"] = [_init_period(gen, cfg)
                           for _ in range(cfg.n_layers // cfg.attn_every)]
    elif cfg.family == "encdec":
        tree["encoder"] = [{"attn": _init_attn(gen, cfg), "ffn": _init_mlp(gen, cfg)}
                           for _ in range(cfg.n_encoder_layers)]
        tree["blocks"] = [{"attn": _init_attn(gen, cfg), "cross": _init_attn(gen, cfg),
                           "ffn": _init_mlp(gen, cfg)} for _ in range(cfg.n_layers)]
        tree["enc_final_norm"] = init_rms_norm(cfg.d_model, dt, gen.device)
    else:
        init_ffn = _init_moe if cfg.ffn_kinds()[0] == "moe" else _init_mlp
        tree["blocks"] = [{"attn": _init_attn(gen, cfg), "ffn": init_ffn(gen, cfg)}
                          for _ in range(cfg.n_layers)]
    return Params(tree)


# ---------------------------------------------------------------------------
# Attention block
# ---------------------------------------------------------------------------


def _project_q(p, cfg, x):
    """q in flat-head layout (B, H, S, Dh)."""
    b, s = x.shape[:2]
    q = (x @ p["wq"]).reshape(b, s, cfg.n_heads, cfg.d_head).transpose(1, 2)
    return rms_norm(q, p["q_norm"], cfg.norm_eps) if cfg.qk_norm else q


def _project_kv(p, cfg, x):
    """k/v in cache layout (B, T, Hkv, Dh); qk_norm before RoPE, as the reference."""
    b, t = x.shape[:2]
    k = (x @ p["wk"]).reshape(b, t, cfg.n_kv_heads, cfg.d_head)
    v = (x @ p["wv"]).reshape(b, t, cfg.n_kv_heads, cfg.d_head)
    if cfg.qk_norm:
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return k, v


def _rope_q(cfg, q, positions, positions3=None):
    """RoPE of ``(B, H, S, Dh)``: M-RoPE where the config has it and the
    three position streams are given, plain RoPE over ``positions`` else."""
    if cfg.mrope and positions3 is not None:
        return apply_mrope(q, positions3, cfg.mrope_sections, cfg.rope_theta)
    return apply_rope(q, positions, cfg.rope_theta)


def _rope_k(cfg, k, positions, positions3=None):
    """RoPE over T of k in cache layout (B, T, Hkv, Dh)."""
    return _rope_q(cfg, k.transpose(1, 2), positions, positions3).transpose(1, 2)


def _attend(p, h, q, k, v, causal: bool):
    """Flash attention of q ``(B, H, S, Dh)`` over cache-layout k/v
    ``(B, T, Hkv, Dh)``, un-repeated (q head h reads kv head h // (H // Hkv)),
    then the output projection and the residual."""
    out = flash_attention(q.contiguous(), k.transpose(1, 2).contiguous(),
                          v.transpose(1, 2).contiguous(), causal=causal)
    b, hq, s, dh = out.shape
    return h + out.transpose(1, 2).reshape(b, s, hq * dh) @ p["wo"]


def attn_block_prefill(p, cfg, h, positions, positions3=None, causal: bool = True):
    """Self-attention over the prompt (causal, or bidirectional for the
    encoder), residual included.

    Returns ``(h, k, v)`` with roped k and v ``(B, S, Hkv, Dh)`` for the cache.
    """
    x = rms_norm(h, p["norm"], cfg.norm_eps)
    q = _rope_q(cfg, _project_q(p, cfg, x), positions, positions3)
    k, v = _project_kv(p, cfg, x)
    k = _rope_k(cfg, k, positions, positions3)
    return _attend(p, h, q, k, v, causal), k, v


def attn_block_decode(p, cfg, h, k_cache, v_cache, pos: int, *, positions3=None,
                      update_cache: bool = True):
    """One-token attention.  h: (B, 1, D); caches (B, T, Hkv, Dh).

    With ``update_cache`` the new token's k/v are written at ``pos`` in place
    and keys ``t < pos + 1`` attended; without it (cross-attention) the
    caches are only read and all T keys attended.  With M-RoPE and no
    ``positions3``, all three streams sit at ``pos``.
    """
    x = rms_norm(h, p["norm"], cfg.norm_eps)
    b = h.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=h.device)
    if cfg.mrope and positions3 is None:
        positions3 = torch.full((3, b, 1), pos, dtype=torch.int32, device=h.device)
    q = _rope_q(cfg, _project_q(p, cfg, x), positions, positions3)
    if update_cache:
        k_new, v_new = _project_kv(p, cfg, x)
        k_cache[:, pos] = _rope_k(cfg, k_new, positions, positions3)[:, 0].to(k_cache.dtype)
        v_cache[:, pos] = v_new[:, 0].to(v_cache.dtype)
        valid_len = pos + 1
    else:
        valid_len = k_cache.shape[1]
    out = decode_attention(q, k_cache, v_cache, valid_len)  # (B, H, 1, Dh)
    b, hq, _, dh = out.shape
    out = out.transpose(1, 2).reshape(b, 1, hq * dh)
    return h + out @ p["wo"], k_cache, v_cache


def _cross_prefill(p, cfg, h, positions, memory, memory_positions):
    """Cross-attention of the decoder over the encoder's output, residual
    included: q roped at the decoder positions, k at the memory positions
    (plain RoPE), non-causal.  Returns ``(h, k, v)`` of the memory for the
    ``cross_k``/``cross_v`` cache."""
    x = rms_norm(h, p["norm"], cfg.norm_eps)
    q = apply_rope(_project_q(p, cfg, x), positions, cfg.rope_theta)
    k, v = _project_kv(p, cfg, memory)
    k = _rope_k(cfg, k, memory_positions)
    return _attend(p, h, q, k, v, causal=False), k, v


# ---------------------------------------------------------------------------
# FFN and Mamba blocks
# ---------------------------------------------------------------------------


def mlp_block(p, cfg, h):
    x = rms_norm(h, p["norm"], cfg.norm_eps)
    return h + swiglu(x, p["w_gate"], p["w_up"], p["w_down"])


def moe_block(p, cfg, h, capacity: int):
    b, s, d = h.shape
    x = rms_norm(h, p["norm"], cfg.norm_eps).reshape(b * s, d)
    y, aux = moe_ffn(x, p["moe"], cfg.moe.n_experts, cfg.moe.top_k, capacity)
    return h + y.reshape(b, s, d), aux


def _ffn(p, cfg, h, kind: str, capacity: int):
    if kind == "moe":
        return moe_block(p, cfg, h, capacity)[0]
    return mlp_block(p, cfg, h) if kind == "mlp" else h


def _mamba_prefill(p, cfg, h):
    """A Mamba layer over the prompt: ``(h, conv state, SSD state)``."""
    x = rms_norm(h, p["norm"], cfg.norm_eps)
    y, (conv, ssm) = m2.mamba_mixer(p["mamba"], x, cfg.ssm, return_state=True)
    return h + y, conv, ssm


def _mamba_decode(p, cfg, h, conv, ssm):
    """A Mamba layer's one-token step; writes the new states into ``conv``
    and ``ssm`` (cache views) in place."""
    x = rms_norm(h, p["norm"], cfg.norm_eps)
    y, conv_new, ssm_new = m2.mamba_decode_step(p["mamba"], x[:, 0, :], conv, ssm, cfg.ssm)
    conv.copy_(conv_new)
    ssm.copy_(ssm_new)
    return h + y[:, None, :]


# ---------------------------------------------------------------------------
# Caches, encoder, prefill and decode
# ---------------------------------------------------------------------------


def init_cache(cfg, batch_size: int, max_len: int, device, enc_len: int = 0) -> dict:
    """Decode-time cache (zeros; prefill fills it).

    ``dense``/``moe``: k/v ``(L, B, T, Hkv, Dh)``.  ``ssm``: the conv state
    ``(L, B, W-1, conv_dim)`` in the compute type and the float32 SSD state
    ``(L, B, H, P, N)``; ``max_len`` does not size them.  ``hybrid``: k/v
    ``(P, B, T, Hkv, Dh)`` for each period's attention layer, conv
    ``(P, n_mamba, B, W-1, conv_dim)`` and SSD ``(P, n_mamba, B, H, P_h, N)``.
    ``encdec``: k/v and the cross-attention's ``cross_k``/``cross_v``
    ``(L, B, enc_len, Hkv, Dh)``.
    """
    check_supported(cfg)
    dt = _cdtype(cfg)

    def zeros(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)

    lead = (cfg.n_layers,)
    cache = {}
    if cfg.family in ("ssm", "hybrid"):
        s = cfg.ssm
        d_inner = s.expand * cfg.d_model
        conv_dim = d_inner + 2 * s.n_groups * s.d_state
        if cfg.family == "hybrid":
            lead = (cfg.n_layers // cfg.attn_every,)
            n_mamba = cfg.layer_kinds()[: cfg.attn_every].count("mamba")
            state = lead + (n_mamba,)
        else:
            state = lead
        cache["conv"] = zeros(*state, batch_size, s.d_conv - 1, conv_dim)
        cache["ssm"] = zeros(*state, batch_size, d_inner // s.head_dim, s.head_dim, s.d_state,
                             dtype=torch.float32)
    if cfg.family != "ssm":
        kv = lead + (batch_size, max_len, cfg.n_kv_heads, cfg.d_head)
        cache["k"], cache["v"] = zeros(*kv), zeros(*kv)
    if cfg.family == "encdec":
        cross = lead + (batch_size, enc_len, cfg.n_kv_heads, cfg.d_head)
        cache["cross_k"], cache["cross_v"] = zeros(*cross), zeros(*cross)
    return cache


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def _embed_in(params, cfg, batch: dict):
    """``(h, positions, positions3)``: ``embeds`` win over ``tokens``, and the
    positions default to ``arange(S)``."""
    if "embeds" in batch:
        h = batch["embeds"]
    else:
        h = params["embed"][batch["tokens"]]
    h = h.to(_cdtype(cfg))
    positions = batch.get("positions")
    if positions is None:
        positions = _positions(h.shape[0], h.shape[1], h.device)
    return h, positions, batch.get("positions3")


def encode(params, cfg, enc_embeds):
    """The bidirectional encoder stack (``encdec``): ``(memory, positions)``."""
    b, s, _ = enc_embeds.shape
    positions = _positions(b, s, enc_embeds.device)
    h = enc_embeds.to(_cdtype(cfg))
    for blk in params["encoder"]:
        h = attn_block_prefill(blk["attn"], cfg, h, positions, causal=False)[0]
        h = mlp_block(blk["ffn"], cfg, h)
    return rms_norm(h, params["enc_final_norm"], cfg.norm_eps), positions


def forward_prefill(params, cfg, batch: dict, max_len: int):
    """Returns (last-position hidden (B, D), cache filled from the prompt).

    ``batch`` holds ``tokens`` (B, S) or ``embeds`` (B, S, D) (which win),
    optionally ``positions`` (B, S) and ``positions3`` (3, B, S) (M-RoPE), and
    for ``encdec`` the encoder's ``enc_embeds`` (B, S_enc, D).
    """
    check_supported(cfg)
    h, positions, positions3 = _embed_in(params, cfg, batch)
    b, s, _ = h.shape
    cap = moe_capacity(cfg, b * s) if cfg.moe is not None else 0

    if cfg.family == "ssm":
        cache = init_cache(cfg, b, max_len, h.device)
        # The conv state comes back in the param type, as the reference returns it.
        cache["conv"] = cache["conv"].to(_dtype(cfg))
        for i, blk in enumerate(params["blocks"]):
            h, cache["conv"][i], cache["ssm"][i] = _mamba_prefill(blk, cfg, h)

    elif cfg.family == "hybrid":
        cache = init_cache(cfg, b, max_len, h.device)
        cache["conv"] = cache["conv"].to(_dtype(cfg))
        for p, pp in enumerate(params["periods"]):
            for mixer, i, ffn, j in period_layers(cfg):
                if mixer == "attn":
                    h, k, v = attn_block_prefill(pp["attn"], cfg, h, positions)
                    cache["k"][p, :, :s] = k
                    cache["v"][p, :, :s] = v
                else:
                    h, cache["conv"][p, i], cache["ssm"][p, i] = _mamba_prefill(
                        pp["mamba"][i], cfg, h)
                if ffn != "none":
                    h = _ffn(pp[ffn][j], cfg, h, ffn, cap)

    elif cfg.family == "encdec":
        memory, mem_pos = encode(params, cfg, batch["enc_embeds"])
        cache = init_cache(cfg, b, max_len, h.device, enc_len=memory.shape[1])
        for i, blk in enumerate(params["blocks"]):
            h, k, v = attn_block_prefill(blk["attn"], cfg, h, positions)
            cache["k"][i, :, :s] = k
            cache["v"][i, :, :s] = v
            h, cache["cross_k"][i], cache["cross_v"][i] = _cross_prefill(
                blk["cross"], cfg, h, positions, memory, mem_pos)
            h = mlp_block(blk["ffn"], cfg, h)

    else:
        ffn = cfg.ffn_kinds()[0]
        cache = init_cache(cfg, b, max_len, h.device)
        for i, blk in enumerate(params["blocks"]):
            h, k, v = attn_block_prefill(blk["attn"], cfg, h, positions, positions3)
            h = _ffn(blk["ffn"], cfg, h, ffn, cap)
            cache["k"][i, :, :s] = k
            cache["v"][i, :, :s] = v
    return rms_norm(h[:, -1, :], params["final_norm"], cfg.norm_eps), cache


def forward_decode(params, cfg, cache: dict, batch: dict, pos: int):
    """One decode step.  batch: ``{'tokens': (B, 1)}`` or ``{'embeds': (B, 1, D)}``;
    ``pos`` is the write position (current sequence length; the SSD state
    carries it for the Mamba layers).  Returns (logits (B, vocab) in float32,
    cache updated in place)."""
    check_supported(cfg)
    h = batch["embeds"] if "embeds" in batch else params["embed"][batch["tokens"]]
    h = h.to(_cdtype(cfg))
    pos = int(pos)
    cap = moe_capacity(cfg, h.shape[0]) if cfg.moe is not None else 0

    if cfg.family == "ssm":
        for i, blk in enumerate(params["blocks"]):
            h = _mamba_decode(blk, cfg, h, cache["conv"][i], cache["ssm"][i])

    elif cfg.family == "hybrid":
        for p, pp in enumerate(params["periods"]):
            for mixer, i, ffn, j in period_layers(cfg):
                if mixer == "attn":
                    h, _, _ = attn_block_decode(pp["attn"], cfg, h, cache["k"][p],
                                                cache["v"][p], pos)
                else:
                    h = _mamba_decode(pp["mamba"][i], cfg, h, cache["conv"][p, i],
                                      cache["ssm"][p, i])
                if ffn != "none":
                    h = _ffn(pp[ffn][j], cfg, h, ffn, cap)

    elif cfg.family == "encdec":
        for i, blk in enumerate(params["blocks"]):
            h, _, _ = attn_block_decode(blk["attn"], cfg, h, cache["k"][i], cache["v"][i], pos)
            h, _, _ = attn_block_decode(blk["cross"], cfg, h, cache["cross_k"][i],
                                        cache["cross_v"][i], pos, update_cache=False)
            h = mlp_block(blk["ffn"], cfg, h)

    else:
        ffn = cfg.ffn_kinds()[0]
        for i, blk in enumerate(params["blocks"]):
            h, _, _ = attn_block_decode(blk["attn"], cfg, h, cache["k"][i], cache["v"][i], pos)
            h = _ffn(blk["ffn"], cfg, h, ffn, cap)
    h = rms_norm(h[:, 0, :], params["final_norm"], cfg.norm_eps)
    return dot_f32(h, lm_head(params, cfg)), cache


def lm_head(params, cfg) -> torch.Tensor:
    """The (D, vocab) output projection (the embedding's transpose when tied)."""
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]
