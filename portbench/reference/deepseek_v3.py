"""Plain float32 DeepSeek-V3 (Moonlight-16B-A3B's ``deepseek_v3``): the training loss.

The layer equations (``hf:moonshotai/Moonlight-16B-A3B`` ``config.json`` and
DeepSeek-V3's published modeling code), with ``x`` the RMSNorm of the
residual ``h`` (``rms_norm_eps``) before each half of a layer:

  * **Latent attention (MLA)**, no q-LoRA: ``q = x Wq``, each of the H heads
    split into ``q_nope`` (``qk_nope_head_dim``) and ``q_rope``
    (``qk_rope_head_dim``); ``x Wkv_a`` split into the latent ``c``
    (``kv_lora_rank``) and one ``k_rope`` head shared by every head;
    ``RMSNorm(c) Wkv_b``, each head split into ``k_nope`` and ``v``
    (``v_head_dim``).  RoPE (``rope_theta``, positions ``0 .. S-1``) of
    ``q_rope`` and ``k_rope``: the modeling code's ``apply_rotary_pos_emb``
    first de-interleaves them (the even entries, then the odd) and then
    rotates halves, so the entries ``2i`` and ``2i + 1`` form pair ``i``
    (:func:`rope`).  ``k = [k_nope, k_rope]``; causal softmax attention
    with the scale ``(qk_nope_head_dim + qk_rope_head_dim) ** -0.5``; the
    heads' outputs (``H v_head_dim``) times ``Wo`` into the residual.
  * **Layers ``< first_k_dense_replace``**: a SwiGLU ``(silu(x Wg) * x Wu) Wd``
    of width ``intermediate_size``.
  * **The other layers, MoE**: a float32 router, scores ``s = sigmoid(x Wr)``;
    the experts are the top ``num_experts_per_tok`` of ``s + b`` (``b`` the
    correction bias of ``topk_method`` ``noaux_tc``, which only picks: no
    gradient reaches it); their weights are ``s`` at those experts over
    its sum (plus 1e-20, ``norm_topk_prob``), times
    ``routed_scaling_factor``; each chosen expert's SwiGLU of width
    ``moe_intermediate_size`` weighted and summed, plus the
    ``n_shared_experts`` shared experts as one SwiGLU of their summed width,
    added without a gate.  ``n_group = topk_group = 1``: no group choice.
  * **The loss**: the mean token cross-entropy plus ``alpha`` times the sum
    over the MoE layers of the sequence-wise balance loss (``seq_aux``): the
    mean over the packed rows of ``sum_e f_e P_e``, with ``f_e = E / (k S)``
    times the row's pairs routed to ``e`` and ``P_e`` the row's mean of
    ``s_e / sum(s)``.

Departures from the published model, which the program shares:

  * **capacity**: each expert keeps at most ``capacity`` routed pairs,
    counted over the pairs in token-major, k-minor order, and drops the
    rest (factor ``assumed.capacity_factor``); the published model drops none;
  * **no bias update**: auxiliary-loss-free balancing moves ``b`` after each
    step by its expert's load; that update is not run.  ``b`` gets a zero
    gradient, so AdamW moves it by its weight decay alone, as any leaf;
  * **alpha** is ``assumed.aux_loss_alpha`` (DeepSeek-V3's ``aux_loss_alpha``);
    the config gives none;
  * no rope scaling: the catalog's row of the config has none.

Each expert runs on the rows routed to it, one at a time; the attention
builds its ``(S, S)`` scores one head at a time, each head recomputed in
the backward pass.  Every product that the configuration states in bf16
goes through ``Prec.mm``.  Nothing here imports the program.
"""
from __future__ import annotations

import math
from types import SimpleNamespace

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import counts
from .common import Prec, rms_norm, silu, top_layout


def dims(conf: dict) -> SimpleNamespace:
    """The sizes of a DeepSeek-V3-style configuration file (its hf keys)."""
    a = conf["assumed"]
    return SimpleNamespace(
        family="deepseek_v3", d=conf["hidden_size"], layers=conf["num_hidden_layers"],
        heads=conf["num_attention_heads"], nope=conf["qk_nope_head_dim"],
        rope_dim=conf["qk_rope_head_dim"], v_dim=conf["v_head_dim"], latent=conf["kv_lora_rank"],
        ff=conf["intermediate_size"], dense_layers=conf["first_k_dense_replace"],
        experts=conf["n_routed_experts"], top_k=conf["num_experts_per_tok"],
        ffe=conf["moe_intermediate_size"], shared=conf["n_shared_experts"],
        vocab=conf["vocab_size"], rows=conf["vocab_size"], eps=conf["rms_norm_eps"],
        theta=conf["rope_theta"], tied=conf["tie_word_embeddings"],
        routed_scale=conf["routed_scaling_factor"], capacity_factor=a["capacity_factor"],
        aux_weight=a["aux_loss_alpha"], param_dtype=a["param_dtype"])


def _attn_layout(m) -> list:
    d, h, qk = m.d, m.heads, m.nope + m.rope_dim
    return [(("attn", "norm"), (d,), "norm"), (("attn", "wq"), (d, h * qk), "linear"),
            (("attn", "wkv_a"), (d, m.latent + m.rope_dim), "linear"),
            (("attn", "kv_norm"), (m.latent,), "norm"),
            (("attn", "wkv_b"), (m.latent, h * (m.nope + m.v_dim)), "linear"),
            (("attn", "wo"), (h * m.v_dim, d), "linear")]


def layout(conf: dict, group) -> list[tuple[tuple, tuple, str]]:
    """``(path, shape, kind)`` of each weight of ``group`` (``"top"`` or a
    layer).  The correction bias is drawn as a norm, ``1 + 0.1 N(0, 1)``:
    the common 1 moves no choice, the spread does."""
    m = dims(conf)
    if group == "top":
        return top_layout(m)
    d = m.d
    if group < m.dense_layers:
        return _attn_layout(m) + [
            (("ffn", "norm"), (d,), "norm"), (("ffn", "w_gate"), (d, m.ff), "linear"),
            (("ffn", "w_up"), (d, m.ff), "linear"), (("ffn", "w_down"), (m.ff, d), "linear")]
    e, f, fs = m.experts, m.ffe, m.shared * m.ffe
    return _attn_layout(m) + [
        (("ffn", "norm"), (d,), "norm"), (("ffn", "moe", "router"), (d, e), "linear"),
        (("ffn", "moe", "router_bias"), (e,), "norm"),
        (("ffn", "moe", "w_gate"), (e, d, f), "linear"),
        (("ffn", "moe", "w_up"), (e, d, f), "linear"),
        (("ffn", "moe", "w_down"), (e, f, d), "linear"),
        (("ffn", "moe", "shared", "w_gate"), (d, fs), "linear"),
        (("ffn", "moe", "shared", "w_up"), (d, fs), "linear"),
        (("ffn", "moe", "shared", "w_down"), (fs, d), "linear")]


_PUBLISHED = {"scoring_func": "sigmoid", "topk_method": "noaux_tc", "n_group": 1, "topk_group": 1,
              "q_lora_rank": None, "norm_topk_prob": True, "seq_aux": True, "moe_layer_freq": 1,
              "num_nextn_predict_layers": 0, "attention_bias": False, "hidden_act": "silu"}


def port_fields(conf: dict) -> dict:
    """The program's config fields for this file (a dict stands for a
    nested settings object, whose other fields the program's own keep)."""
    m = dims(conf)
    off = {k: conf.get(k) for k, v in _PUBLISHED.items() if conf.get(k) != v}
    if off or conf["num_key_value_heads"] != m.heads:
        raise ValueError(f"the program runs DeepSeek-V3 as {_PUBLISHED}, one kv head a head; "
                         f"this file has {off}")
    return {"n_layers": m.layers, "d_model": m.d, "vocab_size": m.rows, "norm_eps": m.eps,
            "tie_embeddings": m.tied, "n_heads": m.heads, "n_kv_heads": m.heads,
            "d_head": m.nope + m.rope_dim, "d_ff": m.ff, "rope_theta": m.theta,
            "first_k_dense": m.dense_layers,
            "mla": {"kv_lora_rank": m.latent, "qk_nope_head_dim": m.nope,
                    "qk_rope_head_dim": m.rope_dim, "v_head_dim": m.v_dim},
            "moe": {"n_experts": m.experts, "top_k": m.top_k, "d_ff_expert": m.ffe,
                    "n_shared_experts": m.shared, "every": 1,
                    "capacity_factor": m.capacity_factor, "aux_loss_weight": m.aux_weight,
                    "scoring": "sigmoid", "correction_bias": True,
                    "routed_scale": m.routed_scale, "shared_gate": False, "balance": "sequence"}}


def _attn_params(m) -> int:
    h = m.heads
    return (m.d * h * (m.nope + m.rope_dim) + m.d * (m.latent + m.rope_dim)
            + m.latent * h * (m.nope + m.v_dim) + h * m.v_dim * m.d)


def product_params(m) -> int:
    """The weights each token is multiplied by: attention's four
    projections in each layer, the dense SwiGLU or the router, the top-k
    experts and the shared experts, and the head."""
    moe = m.d * m.experts + (m.top_k + m.shared) * 3 * m.d * m.ffe
    ffn = m.dense_layers * 3 * m.d * m.ff + (m.layers - m.dense_layers) * moe
    return m.layers * _attn_params(m) + ffn + m.d * m.rows


def n_params(m) -> int:
    d = m.d
    attn = _attn_params(m) + m.latent + d
    moe = d * m.experts + m.experts + (m.experts + m.shared) * 3 * d * m.ffe + d
    dense = 3 * d * m.ff + d
    return (m.layers * attn + m.dense_layers * dense + (m.layers - m.dense_layers) * moe
            + m.rows * d + (0 if m.tied else d * m.rows) + d)


def train_flops(m, batch: int, seq: int) -> int:
    """A step's products: 6 x the weights a token is multiplied by x tokens,
    plus causal attention's two products forward and backward,
    ``3 B H S^2 (Dn + Dr + Dv)`` a layer; recomputation under remat not
    counted."""
    attn = 3 * batch * m.heads * seq * seq * (m.nope + m.rope_dim + m.v_dim) * m.layers
    return 6 * product_params(m) * batch * seq + attn


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """RoPE of ``x (B, H, S, Dr)`` at positions ``0 .. S-1``, DeepSeek-V3's
    order: the entries de-interleaved (``x[..., 0::2]``, then ``x[..., 1::2]``),
    then the halves rotated."""
    s, dr = x.shape[2], x.shape[3]
    x = torch.cat([x[..., 0::2], x[..., 1::2]], dim=-1)
    half = dr // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _head(q, k, v, mask, prec: Prec):
    scores = prec.mm(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    p = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    return prec.mm(p, v)


def attention(q, k, v, prec: Prec) -> torch.Tensor:
    """Causal softmax attention, one head at a time (each recomputed in the
    backward pass): q, k ``(B, H, S, Dqk)``, v ``(B, H, S, Dv)``."""
    s = q.shape[2]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril_()
    return torch.cat([checkpoint(_head, q[:, j:j + 1], k[:, j:j + 1], v[:, j:j + 1], mask, prec,
                                 use_reentrant=False) for j in range(q.shape[1])], dim=1)


def mla(h: torch.Tensor, w: dict, m, prec: Prec) -> torch.Tensor:
    """The attention half of a layer, residual included."""
    b, s, _ = h.shape
    x = rms_norm(h, w["attn", "norm"], m.eps)
    q = prec.mm(x, w["attn", "wq"]).view(b, s, m.heads, m.nope + m.rope_dim).transpose(1, 2)
    kv_a = prec.mm(x, w["attn", "wkv_a"])
    c, k_rope = kv_a[..., :m.latent], kv_a[..., m.latent:]
    kv = prec.mm(rms_norm(c, w["attn", "kv_norm"], m.eps), w["attn", "wkv_b"])
    kv = kv.view(b, s, m.heads, m.nope + m.v_dim).transpose(1, 2)
    k_rope = rope(k_rope[:, None], m.theta).expand(b, m.heads, s, m.rope_dim)
    q = torch.cat([q[..., :m.nope], rope(q[..., m.nope:], m.theta)], dim=-1)
    k = torch.cat([kv[..., :m.nope], k_rope], dim=-1)
    o = attention(q, k, kv[..., m.nope:], prec)
    return h + prec.mm(o.transpose(1, 2).reshape(b, s, m.heads * m.v_dim), w["attn", "wo"])


def _swiglu(x, gate, up, down, prec: Prec):
    return prec.mm(silu(prec.mm(x, gate)) * prec.mm(x, up), down)


def moe(x: torch.Tensor, w: dict, m, capacity: int, rows: int, prec: Prec):
    """The routed and shared experts of tokens ``x (T, D)`` (``rows`` packed
    rows one after another): ``(y (T, D), the sequence-wise balance loss)``."""
    t = x.shape[0]
    scores = torch.sigmoid(x @ w["ffn", "moe", "router"])  # the router is float32
    ids = torch.topk(scores + w["ffn", "moe", "router_bias"].detach(), m.top_k, dim=-1).indices
    top_w = scores.gather(-1, ids)
    top_w = top_w / (top_w.sum(dim=-1, keepdim=True) + 1e-20) * m.routed_scale
    flat = ids.reshape(-1)
    one_hot = F.one_hot(flat, m.experts)
    keep = (torch.cumsum(one_hot, dim=0) * one_hot).sum(dim=-1) - 1 < capacity
    y = torch.zeros_like(x)
    pair_w = top_w.reshape(-1)
    for e in range(m.experts):
        pairs = torch.nonzero((flat == e) & keep)[:, 0]
        if pairs.numel() == 0:
            continue
        tok = pairs // m.top_k
        ye = _swiglu(x[tok], *(w["ffn", "moe", k][e] for k in ("w_gate", "w_up", "w_down")), prec)
        y.index_add_(0, tok, ye * pair_w[pairs, None])
    y = y + _swiglu(x, *(w["ffn", "moe", "shared", k] for k in ("w_gate", "w_up", "w_down")), prec)
    s = t // rows
    f = one_hot.view(rows, s * m.top_k, m.experts).sum(dim=1).float() * (m.experts / (m.top_k * s))
    p = (scores / scores.sum(dim=-1, keepdim=True)).view(rows, s, m.experts).mean(dim=1)
    return y, torch.sum(f * p, dim=-1).mean()


def layer(h: torch.Tensor, w: dict, i: int, m, capacity: int, prec: Prec):
    """Decoder layer ``i``: ``(h, its balance loss)`` (0 for a dense layer)."""
    b, s, d = h.shape
    h = mla(h, w, m, prec)
    x = rms_norm(h, w["ffn", "norm"], m.eps)
    if i < m.dense_layers:
        return h + _swiglu(x, w["ffn", "w_gate"], w["ffn", "w_up"], w["ffn", "w_down"], prec), \
            h.new_zeros(())
    y, aux = moe(x.reshape(b * s, d), w, m, capacity, b, prec)
    return h + y.view(b, s, d), aux


def _ce_chunk(hc, head, yc, prec: Prec):
    logits = prec.mm(hc, head)
    gold = torch.gather(logits, -1, yc.long()[..., None])[..., 0]
    return torch.sum(torch.logsumexp(logits, dim=-1) - gold)


def loss(params: dict, tokens, labels, m, prec: Prec, chunk: int = 512):
    """The mean token cross-entropy plus ``alpha`` times the MoE layers'
    balance losses of one microbatch; each layer and each chunk of the head
    recomputed in the backward pass.  ``params[group][path]`` are float32
    leaves."""
    b, s = tokens.shape
    cap = counts.capacity(m, b * s)
    top = params["top"]
    h = top["embed",][tokens]
    aux = h.new_zeros(())
    for i in range(m.layers):
        h, a = checkpoint(lambda h, w, i=i: layer(h, w, i, m, cap, prec), h, params[i],
                          use_reentrant=False)
        aux = aux + a
    h = rms_norm(h, top["final_norm",], m.eps)
    head = top["embed",].T if m.tied else top["lm_head",]
    ce = sum(checkpoint(_ce_chunk, h[:, i:i + chunk], head, labels[:, i:i + chunk], prec,
                        use_reentrant=False) for i in range(0, s, chunk)) / (b * s)
    return ce + m.aux_weight * aux
