"""Dense, MoE, SSM, hybrid and encoder-decoder stacks for serving and
training (port of ``repro.models.transformer``).

The reference scans one stacked layer body with ``lax.scan``; here each layer
is its own :class:`~repro_torch.models.params.Params` module and a Python
loop walks them: ``params.blocks`` for the ``dense``, ``moe``, ``ssm`` and
``encdec`` (decoder) stacks, ``params.encoder`` for the encoder, and
``params.periods`` for the ``hybrid`` family, one module per attn:mamba
period holding its ``attn`` layer and lists ``mamba``, ``moe`` and ``mlp`` of
the period's other layers in order.  Every family of the reference is ported,
with M-RoPE (``positions3``) and the modality stubs (``embeds`` in place of
``tokens``, ``enc_embeds`` for the encoder).  The port's own ``pattern``
family (Nemotron-H, :class:`~repro_torch.archs.PatternArchConfig`) is one
mixer a layer, ``params.blocks`` holding each layer's Mamba2 (``norm``,
``mamba``), MoE (``norm``, ``moe``) or attention (``attn``) in the order of
its pattern; it trains and is not served.

Prefill attention runs the flash kernel on the un-repeated (GQA) K/V: causal
self-attention, the encoder's bidirectional attention and the decoder's
cross-attention over the encoder's output (non-causal, ``S != T``).  Decode
attention is plain PyTorch over the cache, as the reference's is plain JAX.
The cache holds per-layer K/V (``dense``, ``moe``), conv and SSD states
(``ssm``), both per period (``hybrid``), or K/V beside the cross-attention's
``cross_k``/``cross_v`` (``encdec``).  ``forward_decode`` updates the cache in
place (the reference returns a new cache; the port saves the copy).

Training (``forward_train``, every family) runs no serving kernel:
attention is the differentiable :func:`~repro_torch.models.layers.chunked_attention`
(the flash training kernels for bf16 on a card, the reference's chunked loop
elsewhere), the experts :func:`~repro_torch.models.layers.swiglu` over the
slabs (gate and up through :func:`~repro_torch.models.layers.dot_f32`).  With
``cfg.remat`` each block (each period for ``hybrid``) runs under
``torch.utils.checkpoint``, the reference's ``_maybe_remat``.  Its compute
copies come from :func:`cast_params_for_train`, which casts inside
autograd's graph so that gradients reach the float32 masters.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..archs import mamba_width
from ..kernels import flash_attention
from ..runtime import spans
from . import mamba2 as m2
from . import mla
from .layers import (
    apply_mrope,
    apply_rope,
    chunked_attention,
    decode_attention,
    dot_f32,
    generator,
    init_embedding,
    init_linear,
    init_rms_norm,
    linear,
    rms_norm,
    swiglu,
)
from ..runtime.axes import get_activation_sharding, hint
from .moe import init_moe_params, moe_ffn
from .params import Params, map_named
from .spmd import (col, col_linear, grad_layout, is_dtensor, local_index, place, placements, row,
                   shard_map, splits, zeros)

__all__ = [
    "attn_block",
    "attn_block_decode",
    "attn_block_prefill",
    "cache_shapes",
    "cast_params_for_compute",
    "cast_params_for_train",
    "check_supported",
    "encode",
    "forward_decode",
    "forward_prefill",
    "forward_train",
    "init_cache",
    "init_params",
    "lm_head",
    "mamba_block",
    "mlp_block",
    "moe_block",
    "moe_capacity",
    "period_layers",
]

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "pattern")


def _dtype(cfg):
    return torch.bfloat16 if cfg.param_dtype == "bfloat16" else torch.float32


def _cdtype(cfg):
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def check_supported(cfg, serving: bool = False) -> None:
    """Raise ``NotImplementedError`` for a family the port does not know,
    and with ``serving`` for latent attention (MLA) and the ``pattern``
    family, which the port trains but does not serve: those need a latent
    cache, and a cache of Mamba states beside K/V laid out by the pattern."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported to repro_torch "
            f"({', '.join(FAMILIES)} are)")
    if serving and _mla(cfg) is not None:
        raise NotImplementedError(
            f"{cfg.name}: latent attention (MLA) is trained but not served: prefill and decode "
            "need a latent cache, which repro_torch does not have yet")
    if serving and cfg.family == "pattern":
        raise NotImplementedError(
            f"{cfg.name}: the pattern family is trained but not served: prefill and decode need "
            "a Mamba conv and SSD state for each M layer beside the KV cache of the * layers, "
            "which repro_torch does not lay out yet")


def _mla(cfg):
    """The config's latent-attention settings, or None."""
    return getattr(cfg, "mla", None)


#: Param leaves that stay float32 under mixed precision (routing decisions,
#: SSD decay rates — small, numerically sensitive; a bf16 copy of the
#: router's correction bias would move which experts are chosen).
_KEEP_F32 = ("router", "router_bias", "gate", "dt_bias", "A_log", "D")


def _compute_cast(cfg):
    cd = _cdtype(cfg)

    def one(name, p):
        if name in _KEEP_F32 or not p.is_floating_point():
            return p
        return p.to(cd)

    return one


def cast_params_for_compute(params: Params, cfg) -> Params:
    """Mixed precision: compute-type copies of the (f32 master) weights.

    Leaves named in ``_KEEP_F32`` and leaves already of the compute type are
    shared with ``params``, not copied.  The copies are frozen, cut from
    the masters' graph: serving's.
    """
    return params.map(_compute_cast(cfg))


def cast_params_for_train(params: Params, cfg) -> dict:
    """The same compute-type copies as a nested dict cast inside autograd's
    graph, so that the gradients of the copies reach trainable masters (the
    reference casts inside ``loss_fn``).  Leaves kept as they are are the
    masters themselves."""
    return map_named(params.graph_tree(), _compute_cast(cfg))


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
    if _mla(cfg) is not None:
        return mla.init_mla_params(gen, cfg, dt)
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
    carry those across with ``params_from_reference``).  On the meta device
    nothing is drawn: the tree has the shapes and dtypes and no storage.
    ``dense``/``moe`` give each layer of ``params["blocks"]`` its FFN kind
    (``cfg.ffn_kinds()``: one kind for every layer of the reference's
    configs, leading dense layers before the MoE ones for DeepSeek-V3's);
    ``pattern`` gives each its mixer (``cfg.layer_kinds()``)."""
    check_supported(cfg)
    gen = generator(seed, device)
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
    elif cfg.family == "pattern":
        init = {"mamba": _init_mamba, "moe": _init_moe,
                "attn": lambda gen, cfg: {"attn": _init_attn(gen, cfg)}}
        tree["blocks"] = [init[kind](gen, cfg) for kind in cfg.layer_kinds()]
    elif cfg.family == "encdec":
        tree["encoder"] = [{"attn": _init_attn(gen, cfg), "ffn": _init_mlp(gen, cfg)}
                           for _ in range(cfg.n_encoder_layers)]
        tree["blocks"] = [{"attn": _init_attn(gen, cfg), "cross": _init_attn(gen, cfg),
                           "ffn": _init_mlp(gen, cfg)} for _ in range(cfg.n_layers)]
        tree["enc_final_norm"] = init_rms_norm(cfg.d_model, dt, gen.device)
    else:
        tree["blocks"] = [{"attn": _init_attn(gen, cfg),
                           "ffn": (_init_moe if kind == "moe" else _init_mlp)(gen, cfg)}
                          for kind in cfg.ffn_kinds()]
    return Params(tree)


# ---------------------------------------------------------------------------
# Attention block
# ---------------------------------------------------------------------------


def _heads(y, n_heads: int, d_head: int):
    """A projection ``(B, S, n_heads * Dh)`` as ``(B, S, n_heads, Dh)``.  On a
    mesh the flat dim is first laid out over 'model' by whole heads, or
    replicated where the heads do not divide the axis (the view cannot split
    a head across ranks)."""
    b, s = y.shape[:2]
    if is_dtensor(y):
        y = y.redistribute(y.device_mesh,
                           placements((b, s, n_heads, d_head), ("batch", None, "model", None)))
    return y.reshape(b, s, n_heads, d_head)


def _project_q(p, cfg, x):
    """q in flat-head layout (B, H, S, Dh)."""
    q = _heads(linear(x, col(p["wq"])), cfg.n_heads, cfg.d_head).transpose(1, 2)
    return rms_norm(q, p["q_norm"], cfg.norm_eps) if cfg.qk_norm else q


def _project_kv(p, cfg, x):
    """k/v in cache layout (B, T, Hkv, Dh); qk_norm before RoPE, as the reference."""
    k = _heads(linear(x, col(p["wk"])), cfg.n_kv_heads, cfg.d_head)
    v = _heads(linear(x, col(p["wv"])), cfg.n_kv_heads, cfg.d_head)
    if cfg.qk_norm:
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return k, v


def _rope_q(cfg, q, positions, positions3=None):
    """RoPE of ``(B, H, S, Dh)``: M-RoPE where the config has it and the
    three position streams are given, none in the ``pattern`` family
    (Nemotron-H's attention takes no positions), plain RoPE over
    ``positions`` else."""
    if cfg.family == "pattern":
        return q
    if cfg.mrope and positions3 is not None:
        return apply_mrope(q, positions3, cfg.mrope_sections, cfg.rope_theta)
    return apply_rope(q, positions, cfg.rope_theta)


def _rope_k(cfg, k, positions, positions3=None):
    """RoPE over T of k in cache layout (B, T, Hkv, Dh)."""
    return _rope_q(cfg, k.transpose(1, 2), positions, positions3).transpose(1, 2)


def _kv_heads(kv, h0: int, n: int, group: int):
    """The kv heads (dim 1 of ``(B, Hkv, T, Dh)``) that q heads ``h0 .. h0 + n - 1``
    read, in a layout the attention takes (q head h reads kv head h // (n // Hkv')):
    a slice of whole groups, or the one kv head a part of a group reads.
    Every registered arch's heads fall so on a 'model' axis of 2 or 16;
    heads that straddle groups raise."""
    if n % group == 0:
        return kv[:, h0 // group: h0 // group + n // group]
    if group % n == 0:
        return kv[:, h0 // group: h0 // group + 1]
    raise ValueError(f"{n} q heads a rank fall across kv-head groups of {group}")


def _flash(q, k, v, causal: bool):
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=causal)


def _attention(cfg, q, k, v, qpos, qpos3, kpos, kpos3, causal: bool, attend):
    """RoPE of q ``(B, H, S, Dh)`` and of k ``(B, T, Hkv, Dh)`` (cache layout),
    then ``attend(q, k, v, causal)`` on un-repeated GQA K/V.  Returns
    ``(out (B, H, S, Dh), roped k)``.

    On DTensors it runs on each rank's shards (batch over the data axes,
    q heads over 'model' where they divide, K/V whole): the rank's q heads
    ``h0 ..`` read the kv heads :func:`_kv_heads` picks, so the kernel gets
    a local GQA input it takes."""
    def core(q, k, v, qpos, qpos3, kpos, kpos3):
        q = _rope_q(cfg, q, qpos, qpos3)
        k = _rope_k(cfg, k, kpos, kpos3)
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)
        n = q.shape[1]
        if n != cfg.n_heads:
            h0 = local_index("model", True) * n
            group = cfg.n_heads // cfg.n_kv_heads
            kt, vt = _kv_heads(kt, h0, n, group), _kv_heads(vt, h0, n, group)
        return attend(q, kt, vt, causal), k

    args = (q, k, v, qpos, qpos3, kpos, kpos3)
    if not is_dtensor(q):
        return core(*args)
    q_pl = placements(q.shape, ("batch", "model", None, None))
    kv_pl = placements(k.shape, ("batch", None, None, None))
    pos_pl = lambda x, spec: None if x is None else placements(x.shape, spec)
    in_pl = (q_pl, kv_pl, kv_pl, pos_pl(qpos, ("batch", None)), pos_pl(qpos3, (None, "batch", None)),
             pos_pl(kpos, ("batch", None)), pos_pl(kpos3, (None, "batch", None)))
    return shard_map(core, args, in_pl, (q_pl, kv_pl))


def _out_proj(p, h, out):
    """The output projection of attention ``out (B, H, S, Dh)``, plus the
    residual (pinned to the batch layout on a mesh)."""
    b, hq, s, dh = out.shape
    out = linear(out.transpose(1, 2).reshape(b, s, hq * dh), row(p["wo"]))
    return hint(h + out, "batch", None, None)


def _write_prefix(cache, x):
    """``cache[:, :S] = x`` for a cache ``(B, T, Hkv, Dh)`` and ``x (B, S, Hkv, Dh)``;
    on DTensors each rank writes the part of its sequence shard below S."""
    def write(cache, x):
        t_l = cache.shape[1]
        t0 = local_index("model", t_l != cache_t) * t_l
        n = max(0, min(t_l, x.shape[1] - t0))
        cache[:, :n] = x[:, t0:t0 + n].to(cache.dtype)
        return cache

    if not is_dtensor(cache):
        cache[:, :x.shape[1]] = x
        return
    cache_t = cache.shape[1]
    c_pl = placements(cache.shape, ("batch", "model", None, None))
    shard_map(write, (cache, x), (c_pl, placements(x.shape, ("batch", None, None, None))), c_pl)


def _store(dst, src):
    """``dst[...] = src``; a DTensor ``src`` first takes ``dst``'s placements."""
    if is_dtensor(dst):
        src = src.redistribute(dst.device_mesh, dst.placements)
    dst.copy_(src)


def attn_block_prefill(p, cfg, h, positions, positions3=None, causal: bool = True):
    """Self-attention over the prompt (causal, or bidirectional for the
    encoder), residual included.

    Returns ``(h, k, v)`` with roped k and v ``(B, S, Hkv, Dh)`` for the cache.
    """
    x = rms_norm(h, p["norm"], cfg.norm_eps)
    k, v = _project_kv(p, cfg, x)
    out, k = _attention(cfg, _project_q(p, cfg, x), k, v, positions, positions3, positions,
                        positions3, causal, _flash)
    return _out_proj(p, h, out), k, v


def _decode_attend(cfg, q, k_new, v_new, k_cache, v_cache, pos: int, valid_len: int,
                   positions3=None):
    """One-token attention of ``q (B, H, 1, Dh)`` (roped here at ``pos``) over
    the cache ``(B, T, Hkv, Dh)``, keys ``t < valid_len``, after writing the
    new token's roped k and v at ``pos`` (when given).  On DTensors whose
    cache sequence is sharded over 'model', each rank scores its own slice
    (only the rank holding ``pos`` writes), the softmax combines the slices
    (a max and a sum over 'model') and the ``p v`` products sum over it;
    with the sequence whole, each rank runs the single-device code on its
    batch shard."""
    split = False
    if is_dtensor(q):
        c_pl = placements(k_cache.shape, ("batch", "model", None, None))
        split = splits(k_cache.shape, ("batch", "model", None, None), 1)

    def local(q, k_new, v_new, k_cache, v_cache):
        b, t_l = q.shape[0], k_cache.shape[1]
        t0 = local_index("model", split) * t_l
        positions = torch.full((b, 1), pos, dtype=torch.int32, device=q.device)
        p3 = positions3
        if cfg.mrope and p3 is None:
            p3 = torch.full((3, b, 1), pos, dtype=torch.int32, device=q.device)
        q = _rope_q(cfg, q, positions, p3)
        if k_new is not None and t0 <= pos < t0 + t_l:
            k_cache[:, pos - t0] = _rope_k(cfg, k_new, positions, p3)[:, 0].to(k_cache.dtype)
            v_cache[:, pos - t0] = v_new[:, 0].to(v_cache.dtype)
        if not split:
            return decode_attention(q, k_cache, v_cache, valid_len)  # (B, H, 1, Dh)
        hkv, dh = k_cache.shape[2], q.shape[-1]
        qg = q[:, :, 0, :].reshape(b, hkv, q.shape[1] // hkv, dh).float()
        s = torch.einsum("bhgd,bthd->bhgt", qg, k_cache.float()) / math.sqrt(dh)
        tpos = t0 + torch.arange(t_l, device=q.device)
        return s.masked_fill(tpos >= valid_len, float("-inf"))

    args = (q, k_new, v_new, k_cache, v_cache)
    if not is_dtensor(q):
        return local(*args)
    q_pl = placements(q.shape, ("batch", None, None, None))
    new_pl = None if k_new is None else placements(k_new.shape, ("batch", None, None, None))
    in_pl = (q_pl, new_pl, new_pl, c_pl, c_pl)
    if not split:
        return shard_map(local, args, in_pl, q_pl)
    b, hq, _, dh = q.shape
    hkv = k_cache.shape[2]
    s = shard_map(local, args, in_pl,
                  placements((b, hkv, hq // hkv, k_cache.shape[1]), ("batch", None, None, "model")))
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    pr = (e / e.sum(dim=-1, keepdim=True)).to(v_cache.dtype)
    out = torch.einsum("bhgt,bthd->bhgd", pr.float(), v_cache.float())
    return out.reshape(b, hq, 1, dh).to(q.dtype)


def attn_block_decode(p, cfg, h, k_cache, v_cache, pos: int, *, positions3=None,
                      update_cache: bool = True):
    """One-token attention.  h: (B, 1, D); caches (B, T, Hkv, Dh).

    With ``update_cache`` the new token's k/v are written at ``pos`` in place
    and keys ``t < pos + 1`` attended; without it (cross-attention) the
    caches are only read and all T keys attended.  With M-RoPE and no
    ``positions3``, all three streams sit at ``pos``.
    """
    x = rms_norm(h, p["norm"], cfg.norm_eps)
    q = _project_q(p, cfg, x)
    k_new, v_new = _project_kv(p, cfg, x) if update_cache else (None, None)
    valid_len = pos + 1 if update_cache else k_cache.shape[1]
    out = _decode_attend(cfg, q, k_new, v_new, k_cache, v_cache, pos, valid_len, positions3)
    return _out_proj(p, h, out), k_cache, v_cache


def _chunked(cfg):
    return lambda q, k, v, causal: chunked_attention(q, k, v, causal=causal,
                                                     kv_chunk=cfg.attn_chunk_kv)


def attn_block(p, cfg, h, positions, *, causal: bool = True, memory=None,
               memory_positions=None, positions3=None):
    """Full-sequence attention of the training path, residual included:
    self-attention over ``h``, or cross-attention over ``memory`` (keys roped
    at ``memory_positions``, plain RoPE, non-causal), through the
    differentiable :func:`chunked_attention` on un-repeated GQA K/V; latent
    attention (causal self-attention only) through :func:`mla.attend`."""
    x = rms_norm(h, p["norm"], cfg.norm_eps)
    if _mla(cfg) is not None:
        return _out_proj(p, h, mla.attend(p, cfg, x, positions))
    q = _project_q(p, cfg, x)
    if memory is None:
        k, v = _project_kv(p, cfg, x)
        out, _ = _attention(cfg, q, k, v, positions, positions3, positions, positions3, causal,
                            _chunked(cfg))
    else:
        k, v = _project_kv(p, cfg, memory)
        out, _ = _attention(cfg, q, k, v, positions, positions3, memory_positions, None, False,
                            _chunked(cfg))
    return _out_proj(p, h, out)


def _cross_prefill(p, cfg, h, positions, memory, memory_positions):
    """Cross-attention of the decoder over the encoder's output, residual
    included: q roped at the decoder positions, k at the memory positions
    (plain RoPE), non-causal.  Returns ``(h, k, v)`` of the memory for the
    ``cross_k``/``cross_v`` cache."""
    x = rms_norm(h, p["norm"], cfg.norm_eps)
    k, v = _project_kv(p, cfg, memory)
    out, k = _attention(cfg, _project_q(p, cfg, x), k, v, positions, None, memory_positions,
                        None, False, _flash)
    return _out_proj(p, h, out), k, v


# ---------------------------------------------------------------------------
# FFN and Mamba blocks
# ---------------------------------------------------------------------------


def mlp_block(p, cfg, h):
    x = rms_norm(h, p["norm"], cfg.norm_eps)
    return hint(h + swiglu(x, p["w_gate"], p["w_up"], p["w_down"]), "batch", None, None)


def moe_block(p, cfg, h, capacity: int, train: bool = False):
    b, s, d = h.shape
    x = rms_norm(h, p["norm"], cfg.norm_eps).reshape(b * s, d)
    # Dispatch-shard count = the data-parallel degree under a profile (see
    # moe_ffn): the per-shard capacity slices keep the scatter shard-local.
    prof = get_activation_sharding()
    ways = prof.axis_size(prof.logical.get("batch", ())) if prof is not None else 1
    ns = 1 if b % ways or (b * s) % ways else ways
    split = b % ways  # the tokens split over the batch axes where the batch does not:
    if split:  # whole again before the view back to (B, S, D), both ways
        x = grad_layout(x, None, None)
    e = cfg.moe
    y, aux = moe_ffn(x, p["moe"], e.n_experts, e.top_k, capacity, n_dispatch_shards=ns,
                     train=train, routing=e, rows=b)
    if split:
        y = hint(y, None, None)
    return hint(h + y.reshape(b, s, d), "batch", None, None), aux


def mamba_block(p, cfg, h):
    x = rms_norm(h, p["norm"], cfg.norm_eps)
    return hint(h + m2.mamba_mixer(p["mamba"], x, cfg.ssm), "batch", None, None)


def _ffn(p, cfg, h, kind: str, capacity: int):
    if kind == "moe":
        return moe_block(p, cfg, h, capacity)[0]
    return mlp_block(p, cfg, h) if kind == "mlp" else h


def _mamba_prefill(p, cfg, h):
    """A Mamba layer over the prompt: ``(h, conv state, SSD state)``."""
    x = rms_norm(h, p["norm"], cfg.norm_eps)
    y, (conv, ssm) = m2.mamba_mixer(p["mamba"], x, cfg.ssm, return_state=True)
    return hint(h + y, "batch", None, None), conv, ssm


def _mamba_decode(p, cfg, h, conv, ssm):
    """A Mamba layer's one-token step; writes the new states into ``conv``
    and ``ssm`` (cache views) in place."""
    x = rms_norm(h, p["norm"], cfg.norm_eps)
    y, conv_new, ssm_new = m2.mamba_decode_step(p["mamba"], x[:, 0, :], conv, ssm, cfg.ssm)
    _store(conv, conv_new)
    _store(ssm, ssm_new)
    return hint(h + y[:, None, :], "batch", None, None)


# ---------------------------------------------------------------------------
# Caches, encoder, prefill and decode
# ---------------------------------------------------------------------------


def cache_shapes(cfg, batch_size: int, max_len: int, enc_len: int = 0) -> dict:
    """``{name: (shape, dtype)}`` of the decode cache :func:`init_cache` makes."""
    check_supported(cfg, serving=True)
    dt = _cdtype(cfg)
    lead = (cfg.n_layers,)
    out = {}
    if cfg.family in ("ssm", "hybrid"):
        s = cfg.ssm
        d_inner = mamba_width(s, cfg.d_model)
        conv_dim = d_inner + 2 * s.n_groups * s.d_state
        if cfg.family == "hybrid":
            lead = (cfg.n_layers // cfg.attn_every,)
            n_mamba = cfg.layer_kinds()[: cfg.attn_every].count("mamba")
            state = lead + (n_mamba,)
        else:
            state = lead
        out["conv"] = (state + (batch_size, s.d_conv - 1, conv_dim), dt)
        out["ssm"] = (state + (batch_size, d_inner // s.head_dim, s.head_dim, s.d_state),
                      torch.float32)
    if cfg.family != "ssm":
        kv = lead + (batch_size, max_len, cfg.n_kv_heads, cfg.d_head)
        out["k"] = out["v"] = (kv, dt)
    if cfg.family == "encdec":
        cross = lead + (batch_size, enc_len, cfg.n_kv_heads, cfg.d_head)
        out["cross_k"] = out["cross_v"] = (cross, dt)
    return out


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
    return {k: torch.zeros(shape, dtype=dt, device=device)
            for k, (shape, dt) in cache_shapes(cfg, batch_size, max_len, enc_len).items()}


def _cache_logical(key: str, ndim: int) -> tuple:
    """The logical layout of a cache entry, the serve rules' ``cache_spec_tree``:
    K/V batch over the data axes and sequence over 'model', SSD states heads
    over 'model', conv states channels over 'model'."""
    tail = {"conv": ("batch", None, "model")}.get(key, ("batch", "model", None, None))
    return (None,) * (ndim - len(tail)) + tail


def _new_cache(cfg, b: int, max_len: int, like, enc_len: int = 0) -> dict:
    """:func:`init_cache` on ``like``'s device; DTensors laid out by
    :func:`_cache_logical` when ``like`` is one (each rank allocates only its
    shard)."""
    if not is_dtensor(like):
        return init_cache(cfg, b, max_len, like.device, enc_len)
    return {k: zeros(shape, dt, like.device, _cache_logical(k, len(shape)))
            for k, (shape, dt) in cache_shapes(cfg, b, max_len, enc_len).items()}


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def _embed_in(params, cfg, batch: dict):
    """``(h, positions, positions3)``: ``embeds`` win over ``tokens``, and the
    positions default to ``arange(S)``."""
    if "embeds" in batch:
        h = _tokens(params, batch["embeds"])
    else:
        h = _embed(params, batch["tokens"])
    h = hint(h.to(_cdtype(cfg)), "batch", None, None)
    positions = batch.get("positions")
    if positions is None:
        positions = _positions(h.shape[0], h.shape[1], h.device)
    positions3 = batch.get("positions3")
    if is_dtensor(h):
        positions, positions3 = place(positions, "batch", None), place(positions3, None, "batch", None)
    return h, positions, positions3


def _embed(params, tokens):
    """The embedding lookup.  On a mesh each rank looks up the tokens of its
    data shard in its slice of the vocabulary (over 'model'; the table is
    first gathered over train's FSDP axis) and the lookups sum over 'model'."""
    w = params["embed"]
    if not is_dtensor(w):
        return F.embedding(tokens, w)
    w_pl = placements(w.shape, ("model", None))
    tokens = _tokens(params, tokens)
    t_pl = placements(tokens.shape, ("batch", None))
    out = (*tokens.shape, w.shape[1])
    if not splits(w.shape, ("model", None), 0):  # the vocabulary is whole on every rank
        return shard_map(F.embedding, (tokens, w), (t_pl, w_pl),
                         placements(out, ("batch", None, None)))

    def local(tok, w):
        v = w.shape[0]
        rel = tok.long() - local_index("model", True) * v
        ok = (rel >= 0) & (rel < v)
        return torch.where(ok[..., None], F.embedding(rel.clamp(0, v - 1), w), 0.0)

    h = shard_map(local, (tokens, w), (t_pl, w_pl),
                  placements(out, ("batch", None, None), ("model",)))
    return h.redistribute(h.device_mesh, placements(out, ("batch", None, None)))


def _tokens(params, x):
    """Input ``x`` (tokens or embeddings) placed over the data axes when the
    embedding is a DTensor."""
    if not is_dtensor(params["embed"]):
        return x
    return place(x, "batch", *(None,) * (x.dim() - 1))


def encode(params, cfg, enc_embeds, train: bool = False):
    """The bidirectional encoder stack (``encdec``): ``(memory, positions)``.

    Serving's attention is the flash kernel; ``train`` runs the training
    path's differentiable attention, each layer rematerialised with
    ``cfg.remat``."""
    b, s, _ = enc_embeds.shape
    enc_embeds = _tokens(params, enc_embeds)
    positions = _positions(b, s, enc_embeds.device)
    if is_dtensor(enc_embeds):
        positions = place(positions, "batch", None)
    h = hint(enc_embeds.to(_cdtype(cfg)), "batch", None, None)
    for blk in params["encoder"]:
        if train:
            h = _remat(cfg, _encoder_layer, blk, cfg, h, positions)
        else:
            h = attn_block_prefill(blk["attn"], cfg, h, positions, causal=False)[0]
            h = hint(mlp_block(blk["ffn"], cfg, h), "batch", None, None)
    return rms_norm(h, params["enc_final_norm"], cfg.norm_eps), positions


def _encoder_layer(blk, cfg, h, positions):
    h = attn_block(blk["attn"], cfg, h, positions, causal=False)
    return hint(mlp_block(blk["ffn"], cfg, h), "batch", None, None)


# ---------------------------------------------------------------------------
# Full-sequence forward (training) per family
# ---------------------------------------------------------------------------


def _remat(cfg, fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` when ``cfg.remat``: its
    activations are recomputed in the backward pass, not kept.  The block
    runs under the span ``repro_torch.block``, in the recompute too."""
    if cfg.remat:
        return checkpoint(_block, fn, *args, use_reentrant=False)
    return _block(fn, *args)


def _block(fn, *args):
    with spans.span(spans.BLOCK):
        return fn(*args)


def _decoder_layer(lp, cfg, h, positions, positions3, ffn, cap):
    """One ``dense``/``moe`` layer: ``(h, aux)``."""
    h = attn_block(lp["attn"], cfg, h, positions, positions3=positions3)
    if ffn == "moe":
        h, aux = moe_block(lp["ffn"], cfg, h, cap, train=True)
    else:
        h, aux = mlp_block(lp["ffn"], cfg, h), h.new_zeros((), dtype=torch.float32)
    return hint(h, "batch", None, None), aux


def _period(pp, cfg, h, positions, cap):
    """One ``hybrid`` period: ``(h, aux summed over its MoE layers)``."""
    aux = h.new_zeros((), dtype=torch.float32)
    for mixer, i, ffn, j in period_layers(cfg):
        if mixer == "attn":
            h = attn_block(pp["attn"], cfg, h, positions)
        else:
            h = mamba_block(pp["mamba"][i], cfg, h)
        if ffn == "moe":
            h, a = moe_block(pp["moe"][j], cfg, h, cap, train=True)
            aux = aux + a
        elif ffn == "mlp":
            h = mlp_block(pp["mlp"][j], cfg, h)
        h = hint(h, "batch", None, None)
    return h, aux


def _pattern_layer(lp, cfg, h, positions, kind: str, cap):
    """One ``pattern`` layer, its one mixer: ``(h, aux)``."""
    if kind == "moe":
        return moe_block(lp, cfg, h, cap, train=True)
    if kind == "mamba":
        h = mamba_block(lp, cfg, h)
    else:
        h = attn_block(lp["attn"], cfg, h, positions)
    return h, h.new_zeros((), dtype=torch.float32)


def _encdec_layer(lp, cfg, h, positions, memory, mem_pos):
    h = attn_block(lp["attn"], cfg, h, positions)
    h = attn_block(lp["cross"], cfg, h, positions, memory=memory, memory_positions=mem_pos,
                   causal=False)
    return hint(mlp_block(lp["ffn"], cfg, h), "batch", None, None)


def forward_train(params, cfg, batch: dict):
    """Returns (final-normed hidden states (B, S, D), aux loss (a float32 scalar)).

    ``params`` are compute copies from :func:`cast_params_for_train` (or any
    tree of the same names); ``batch`` as for :func:`forward_prefill`.  The
    aux loss sums the MoE layers' load-balancing losses (0 without MoE).
    """
    check_supported(cfg)
    h, positions, positions3 = _embed_in(params, cfg, batch)
    b, s, _ = h.shape
    cap = moe_capacity(cfg, b * s) if cfg.moe is not None else 0
    aux = h.new_zeros((), dtype=torch.float32)

    if cfg.family == "ssm":
        for lp in params["blocks"]:
            h = hint(_remat(cfg, mamba_block, lp, cfg, h), "batch", None, None)
    elif cfg.family == "hybrid":
        for pp in params["periods"]:
            h, a = _remat(cfg, _period, pp, cfg, h, positions, cap)
            aux = aux + a
    elif cfg.family == "pattern":
        for lp, kind in zip(params["blocks"], cfg.layer_kinds()):
            h, a = _remat(cfg, _pattern_layer, lp, cfg, h, positions, kind, cap)
            aux = aux + a
    elif cfg.family == "encdec":
        memory, mem_pos = encode(params, cfg, batch["enc_embeds"], train=True)
        for lp in params["blocks"]:
            h = _remat(cfg, _encdec_layer, lp, cfg, h, positions, memory, mem_pos)
    else:
        for lp, ffn in zip(params["blocks"], cfg.ffn_kinds()):
            h, a = _remat(cfg, _decoder_layer, lp, cfg, h, positions, positions3, ffn, cap)
            aux = aux + a
    return rms_norm(h, params["final_norm"], cfg.norm_eps), aux


def forward_prefill(params, cfg, batch: dict, max_len: int):
    """Returns (last-position hidden (B, D), cache filled from the prompt).

    ``batch`` holds ``tokens`` (B, S) or ``embeds`` (B, S, D) (which win),
    optionally ``positions`` (B, S) and ``positions3`` (3, B, S) (M-RoPE), and
    for ``encdec`` the encoder's ``enc_embeds`` (B, S_enc, D).
    """
    check_supported(cfg, serving=True)
    h, positions, positions3 = _embed_in(params, cfg, batch)
    b, s, _ = h.shape
    cap = moe_capacity(cfg, b * s) if cfg.moe is not None else 0
    pin = lambda h: hint(h, "batch", None, None)

    if cfg.family == "ssm":
        cache = _new_cache(cfg, b, max_len, h)
        # The conv state comes back in the param type, as the reference returns it.
        cache["conv"] = cache["conv"].to(_dtype(cfg))
        for i, blk in enumerate(params["blocks"]):
            h, conv, ssm = _mamba_prefill(blk, cfg, h)
            _store(cache["conv"][i], conv)
            _store(cache["ssm"][i], ssm)
            h = pin(h)

    elif cfg.family == "hybrid":
        cache = _new_cache(cfg, b, max_len, h)
        cache["conv"] = cache["conv"].to(_dtype(cfg))
        for p, pp in enumerate(params["periods"]):
            for mixer, i, ffn, j in period_layers(cfg):
                if mixer == "attn":
                    h, k, v = attn_block_prefill(pp["attn"], cfg, h, positions)
                    _write_prefix(cache["k"][p], k)
                    _write_prefix(cache["v"][p], v)
                else:
                    h, conv, ssm = _mamba_prefill(pp["mamba"][i], cfg, h)
                    _store(cache["conv"][p, i], conv)
                    _store(cache["ssm"][p, i], ssm)
                if ffn != "none":
                    h = _ffn(pp[ffn][j], cfg, h, ffn, cap)
                h = pin(h)

    elif cfg.family == "encdec":
        memory, mem_pos = encode(params, cfg, batch["enc_embeds"])
        cache = _new_cache(cfg, b, max_len, h, enc_len=memory.shape[1])
        for i, blk in enumerate(params["blocks"]):
            h, k, v = attn_block_prefill(blk["attn"], cfg, h, positions)
            _write_prefix(cache["k"][i], k)
            _write_prefix(cache["v"][i], v)
            h, k, v = _cross_prefill(blk["cross"], cfg, h, positions, memory, mem_pos)
            _write_prefix(cache["cross_k"][i], k)
            _write_prefix(cache["cross_v"][i], v)
            h = pin(mlp_block(blk["ffn"], cfg, h))

    else:
        cache = _new_cache(cfg, b, max_len, h)
        for i, (blk, ffn) in enumerate(zip(params["blocks"], cfg.ffn_kinds())):
            h, k, v = attn_block_prefill(blk["attn"], cfg, h, positions, positions3)
            h = pin(_ffn(blk["ffn"], cfg, h, ffn, cap))
            _write_prefix(cache["k"][i], k)
            _write_prefix(cache["v"][i], v)
    return rms_norm(h[:, -1, :], params["final_norm"], cfg.norm_eps), cache


def forward_decode(params, cfg, cache: dict, batch: dict, pos: int):
    """One decode step.  batch: ``{'tokens': (B, 1)}`` or ``{'embeds': (B, 1, D)}``;
    ``pos`` is the write position (current sequence length; the SSD state
    carries it for the Mamba layers).  Returns (logits (B, vocab) in float32,
    cache updated in place)."""
    check_supported(cfg, serving=True)
    if "embeds" in batch:
        h = _tokens(params, batch["embeds"])
    else:
        h = _embed(params, batch["tokens"])
    h = hint(h.to(_cdtype(cfg)), "batch", None, None)
    pos = int(pos)
    cap = moe_capacity(cfg, h.shape[0]) if cfg.moe is not None else 0
    pin = lambda h: hint(h, "batch", None, None)

    if cfg.family == "ssm":
        for i, blk in enumerate(params["blocks"]):
            h = pin(_mamba_decode(blk, cfg, h, cache["conv"][i], cache["ssm"][i]))

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
                h = pin(h)

    elif cfg.family == "encdec":
        for i, blk in enumerate(params["blocks"]):
            h, _, _ = attn_block_decode(blk["attn"], cfg, h, cache["k"][i], cache["v"][i], pos)
            h, _, _ = attn_block_decode(blk["cross"], cfg, h, cache["cross_k"][i],
                                        cache["cross_v"][i], pos, update_cache=False)
            h = pin(mlp_block(blk["ffn"], cfg, h))

    else:
        for i, (blk, ffn) in enumerate(zip(params["blocks"], cfg.ffn_kinds())):
            h, _, _ = attn_block_decode(blk["attn"], cfg, h, cache["k"][i], cache["v"][i], pos)
            h = pin(_ffn(blk["ffn"], cfg, h, ffn, cap))
    h = rms_norm(h[:, 0, :], params["final_norm"], cfg.norm_eps)
    return col_linear(h, lm_head(params, cfg), dot_f32), cache


def lm_head(params, cfg) -> torch.Tensor:
    """The (D, vocab) output projection (the embedding's transpose when tied)."""
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]
