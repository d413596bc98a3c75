"""Plain float32 Qwen3-MoE: the training loss.

The layer equations (Qwen3-MoE, ``hf:Qwen/Qwen3-30B-A3B``): pre-norm RMSNorm;
q, k, v projections, RMSNorm of each q and k head (qk-norm), rotate-half RoPE
at positions ``0 .. S-1``; causal grouped-query softmax attention (q head h
reads kv head ``h // (H / Hkv)``); the output projection into the residual;
RMSNorm; a float32 router, softmax over the experts, the top-k renormalised
to sum to 1; each chosen expert's SwiGLU ``(silu(x Wg) * x Wu) Wd`` weighted
and summed into the residual.  As the program does, each expert keeps at
most ``capacity`` routed pairs, counted over the pairs in token-major,
k-minor order, and drops the rest (the published model has no capacity);
with ``shards`` dispatch shards (the program's data-parallel degree) the
pairs fall into ``shards`` equal runs and each keeps ``capacity / shards``
of an expert's pairs, counted in its own run.
The training loss adds ``router_aux_loss_coef`` times the sum over layers of
the Switch load-balancing loss ``E * sum_e f_e * mean_t p_e``.

Each expert runs on the rows routed to it, one at a time; the attention
builds its ``(S, S)`` scores one kv head at a time.  Every product that
the configuration states in bf16 goes through ``Prec.mm``.  Nothing here imports
the program.
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
    """The sizes of a Qwen3-MoE-style configuration file (its hf keys)."""
    a = conf["assumed"]
    return SimpleNamespace(
        family="moe", d=conf["hidden_size"], layers=conf["num_hidden_layers"],
        heads=conf["num_attention_heads"], kv_heads=conf["num_key_value_heads"],
        head_dim=conf["head_dim"], experts=conf["num_experts"], top_k=conf["num_experts_per_tok"],
        ffe=conf["moe_intermediate_size"], vocab=conf["vocab_size"], rows=conf["vocab_size"],
        eps=conf["rms_norm_eps"], theta=conf["rope_theta"], tied=conf["tie_word_embeddings"],
        capacity_factor=a["capacity_factor"], aux_weight=conf["router_aux_loss_coef"],
        param_dtype=a["param_dtype"])


def layout(conf: dict, group) -> list[tuple[tuple, tuple, str]]:
    """``(path, shape, kind)`` of each weight of ``group`` (``"top"`` or a layer)."""
    m = dims(conf)
    if group == "top":
        return top_layout(m)
    d, q, kv, e, f = m.d, m.heads * m.head_dim, m.kv_heads * m.head_dim, m.experts, m.ffe
    return [(("attn", "norm"), (d,), "norm"), (("attn", "wq"), (d, q), "linear"),
            (("attn", "wk"), (d, kv), "linear"), (("attn", "wv"), (d, kv), "linear"),
            (("attn", "wo"), (q, d), "linear"), (("attn", "q_norm"), (m.head_dim,), "norm"),
            (("attn", "k_norm"), (m.head_dim,), "norm"), (("ffn", "norm"), (d,), "norm"),
            (("ffn", "moe", "router"), (d, e), "linear"),
            (("ffn", "moe", "w_gate"), (e, d, f), "linear"),
            (("ffn", "moe", "w_up"), (e, d, f), "linear"),
            (("ffn", "moe", "w_down"), (e, f, d), "linear")]


def port_fields(conf: dict) -> dict:
    """The program's config fields for this file (a dict stands for a
    nested settings object, whose other fields the program's own keep)."""
    m = dims(conf)
    if not conf["norm_topk_prob"] or conf["decoder_sparse_step"] != 1:
        raise ValueError("the program renormalises the top-k weights, MoE in every layer")
    return {"n_layers": m.layers, "d_model": m.d, "vocab_size": m.rows, "norm_eps": m.eps,
            "tie_embeddings": m.tied, "n_heads": m.heads, "n_kv_heads": m.kv_heads,
            "d_head": m.head_dim, "d_ff": 0, "rope_theta": m.theta, "qk_norm": True,
            "moe": {"n_experts": m.experts, "top_k": m.top_k, "d_ff_expert": m.ffe, "every": 1,
                    "capacity_factor": m.capacity_factor, "aux_loss_weight": m.aux_weight}}


def product_params(m) -> int:
    """The weights each token is multiplied by: attention's four
    projections, the router and the top-k experts in each layer, the head."""
    attn = 2 * m.d * m.heads * m.head_dim + 2 * m.d * m.kv_heads * m.head_dim
    ffn = m.d * m.experts + m.top_k * 3 * m.d * m.ffe
    return m.layers * (attn + ffn) + m.d * m.rows


def n_params(m) -> int:
    d = m.d
    attn = 2 * d * m.heads * m.head_dim + 2 * d * m.kv_heads * m.head_dim + 2 * m.head_dim
    ffn = d * m.experts + m.experts * 3 * d * m.ffe
    return m.layers * (attn + ffn + 2 * d) + m.rows * d + (0 if m.tied else d * m.rows) + d


def train_flops(m, batch: int, seq: int) -> int:
    """A step's products (``chip_smoke.py``'s ``_train_bound``): 6 x the
    weights a token is multiplied by x tokens, plus causal attention's two
    products forward and backward; recomputation under remat not counted."""
    attn = 3 * 2 * batch * m.heads * seq * seq * m.head_dim * m.layers
    return 6 * product_params(m) * batch * seq + attn


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half RoPE of ``x (B, H, S, Dh)`` at positions ``0 .. S-1``."""
    s, dh = x.shape[2], x.shape[3]
    half = dh // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, prec: Prec) -> torch.Tensor:
    """Causal softmax attention: q ``(B, H, S, Dh)``, k, v ``(B, Hkv, S, Dh)``."""
    b, h, s, dh = q.shape
    hkv = k.shape[1]
    g = h // hkv
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril_()
    outs = []
    for j in range(hkv):
        qj, kj, vj = q[:, j * g:(j + 1) * g], k[:, j:j + 1], v[:, j:j + 1]
        scores = prec.mm(qj, kj.transpose(-1, -2)) / math.sqrt(dh)
        p = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
        outs.append(prec.mm(p, vj))
    return torch.cat(outs, dim=1)


def moe(x: torch.Tensor, w: dict, m, capacity: int, prec: Prec, shards: int = 1):
    """The routed experts of tokens ``x (T, D)``: ``(y (T, D), aux)``."""
    logits = x @ w["ffn", "moe", "router"]  # the router is float32
    probs = torch.softmax(logits, dim=-1)
    top_w, ids = torch.topk(probs, m.top_k, dim=-1)
    top_w = top_w / top_w.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    flat = ids.reshape(-1)
    one_hot = F.one_hot(flat, m.experts)
    if shards == 1:
        pos = (torch.cumsum(one_hot, dim=0) * one_hot).sum(dim=-1) - 1
    else:  # an expert's position among its pairs in the pair's own run
        run = torch.arange(flat.numel(), device=x.device) // (flat.numel() // shards)
        in_run = F.one_hot(flat * shards + run, m.experts * shards)
        pos = (torch.cumsum(in_run, dim=0) * in_run).sum(dim=-1) - 1
    keep = pos < capacity // shards
    y = torch.zeros_like(x)
    pair_w = top_w.reshape(-1)
    for e in range(m.experts):
        pairs = torch.nonzero((flat == e) & keep)[:, 0]
        if pairs.numel() == 0:
            continue
        tok = pairs // m.top_k
        xe = x[tok]
        gate, up, down = (w["ffn", "moe", k][e] for k in ("w_gate", "w_up", "w_down"))
        ye = prec.mm(silu(prec.mm(xe, gate)) * prec.mm(xe, up), down)
        y.index_add_(0, tok, ye * pair_w[pairs, None])
    frac = one_hot.sum(dim=0).float()
    frac = frac / frac.sum().clamp(min=1.0)
    aux = m.experts * torch.sum(frac * probs.mean(dim=0))
    return y, aux


def layer(h: torch.Tensor, w: dict, m, capacity: int, prec: Prec, shards: int = 1):
    """One decoder layer: ``(h, aux)``; ``shards``: the MoE's dispatch shards."""
    b, s, d = h.shape
    x = rms_norm(h, w["attn", "norm"], m.eps)
    q = prec.mm(x, w["attn", "wq"]).view(b, s, m.heads, m.head_dim)
    k = prec.mm(x, w["attn", "wk"]).view(b, s, m.kv_heads, m.head_dim)
    v = prec.mm(x, w["attn", "wv"]).view(b, s, m.kv_heads, m.head_dim)
    q = rope(rms_norm(q, w["attn", "q_norm"], m.eps).transpose(1, 2), m.theta)
    k = rope(rms_norm(k, w["attn", "k_norm"], m.eps).transpose(1, 2), m.theta)
    o = attention(q, k, v.transpose(1, 2), prec).transpose(1, 2).reshape(b, s, m.heads * m.head_dim)
    h = h + prec.mm(o, w["attn", "wo"])
    y, aux = moe(rms_norm(h, w["ffn", "norm"], m.eps).reshape(b * s, d), w, m, capacity, prec,
                 shards)
    return h + y.view(b, s, d), aux


def _ce_chunk(hc, head, yc, prec: Prec):
    logits = prec.mm(hc, head)
    gold = torch.gather(logits, -1, yc.long()[..., None])[..., 0]
    return torch.sum(torch.logsumexp(logits, dim=-1) - gold)


def loss(params: dict, tokens, labels, m, prec: Prec, chunk: int = 512):
    """The mean token cross-entropy plus the weighted aux loss of one
    microbatch; each layer and each chunk of the head recomputed in the
    backward pass.  ``params[group][path]`` are float32 leaves."""
    b, s = tokens.shape
    cap = counts.capacity(m, b * s)
    top = params["top"]
    h = top["embed",][tokens]
    aux = h.new_zeros(())
    for i in range(m.layers):
        h, a = checkpoint(lambda h, w: layer(h, w, m, cap, prec), h, params[i],
                          use_reentrant=False)
        aux = aux + a
    h = rms_norm(h, top["final_norm",], m.eps)
    head = top["embed",].T if m.tied else top["lm_head",]
    ce = sum(checkpoint(_ce_chunk, h[:, i:i + chunk], head, labels[:, i:i + chunk], prec,
                        use_reentrant=False) for i in range(0, s, chunk)) / (b * s)
    return ce + m.aux_weight * aux
