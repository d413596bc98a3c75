"""Plain float32 Nemotron-H (NVIDIA-Nemotron-3-Nano-30B-A3B's ``nemotron_h``): the training loss.

The layer equations (``hf:nvidia/NVIDIA-Nemotron-3-Nano-30B-A3B-BF16``
``config.json`` and the family's published modeling code).  Layer ``i`` is
one mixer and nothing else, ``h = h + mixer(RMSNorm(h))`` (``eps`` the
config's ``layer_norm_epsilon``), the mixer named by character ``i`` of
``hybrid_override_pattern``:

  * ``M``, **Mamba2**: ``[z, xBC, dt] = x W_in`` (no bias), with ``z`` and
    ``x`` of ``d_inner = mamba_num_heads * mamba_head_dim`` channels (the
    heads size the mixer; ``expand * d`` is not read), ``B`` and ``C`` of
    ``n_groups * ssm_state_size``, ``dt`` one a head;
    ``xBC = silu(conv(xBC) + b)``, a causal depthwise convolution of width
    ``conv_kernel`` with a bias; ``dt = softplus(dt + dt_bias)``,
    ``A = -exp(A_log)``; the SSD ``y_t = C_t . s_t``, ``s_t = exp(dt_t A)
    s_{t-1} + dt_t x_t B_t^T`` for each head, its group's ``B`` and ``C``
    (heads split evenly over the groups), computed in chunks of
    ``chunk_size`` by the Mamba2 paper's minimal discrete SSD
    (:func:`ssd`); ``y = y + D x``; the gated RMSNorm ``norm(y * silu(z))``
    taken over each group of ``d_inner / n_groups`` channels apart, times
    its weight; ``y W_out`` (no bias).
  * ``*``, **attention**: GQA, ``num_attention_heads`` q heads and
    ``num_key_value_heads`` k/v heads of ``head_dim`` (q head ``j`` reads kv
    head ``j // (H / Hkv)``), no bias, causal softmax with the scale
    ``head_dim ** -0.5``, and no positional embedding: the modeling code
    passes no positions to its attention layers, so ``rope_theta`` and
    ``partial_rotary_factor`` are read by nothing.
  * ``E``, **MoE**: a float32 router over the published ``n_routed_experts``
    experts (``router_experts`` in a configuration that holds a share),
    scores ``s = sigmoid(x Wr)``; the experts are the top
    ``num_experts_per_tok`` of ``s + b`` (``b`` the correction bias, which
    only picks: no gradient reaches it; ``n_group = topk_group = 1``);
    their weights ``s`` at those experts over its sum plus 1e-20
    (``norm_topk_prob``), times ``routed_scaling_factor``; each chosen
    expert a non-gated squared-ReLU MLP ``relu(x W_up)^2 W_down`` of width
    ``moe_intermediate_size`` (``mlp_hidden_act`` ``relu2``), weighted and
    summed, plus the one shared expert of the same form and width
    ``moe_shared_expert_intermediate_size``, added without a gate.
  * **The loss**: the mean token cross-entropy of the final RMSNorm under
    the untied head, plus ``alpha`` times the sum over the MoE layers of
    the sequence-wise balance loss: the mean over the packed rows of
    ``sum_e f_e P_e``, with ``f_e = E / (k S)`` times the row's pairs routed
    to ``e`` and ``P_e`` the row's mean of ``s_e / sum(s)``.

Departures from the published model, which the program shares:

  * **capacity**: each expert keeps at most ``capacity`` routed pairs,
    counted over the pairs in token-major, k-minor order over all the
    router's experts, and drops the rest (factor
    ``assumed.capacity_factor``); the published model drops none;
  * **the expert share**: the configuration holds the first
    ``n_routed_experts`` of the router's ``router_experts`` (its chip's
    share of an expert-parallel group); the router, its bias, the capacity
    and the balance loss keep all of them, and what a pair routed to an
    expert held elsewhere would add is left out;
  * **no bias update**: the correction bias gets a zero gradient and no
    balancing update, so AdamW moves it by its weight decay alone;
  * **alpha** is ``assumed.aux_loss_alpha``; the config gives none.

Each expert runs on the rows routed to it, one at a time; the attention
builds its ``(S, S)`` scores one head at a time, each head recomputed in
the backward pass; each layer is recomputed in the backward pass.  Every
product that the configuration states in bf16 goes through ``Prec.mm``:
the projections, experts and head; the SSD, the convolution and the
router stay float32, as the program takes them.  Nothing here imports the
program.
"""
from __future__ import annotations

from types import SimpleNamespace

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import counts
from .common import Prec, rms_norm, silu, top_layout
from .deepseek_v3 import _ce_chunk, _head  # one head's causal attention; a chunk's loss


def dims(conf: dict) -> SimpleNamespace:
    """The sizes of a Nemotron-H configuration file (its hf keys)."""
    a = conf["assumed"]
    layers = conf["num_hidden_layers"]
    heads, head_dim = conf["mamba_num_heads"], conf["mamba_head_dim"]
    return SimpleNamespace(
        family="nemotron_h", d=conf["hidden_size"], layers=layers,
        pattern=conf["hybrid_override_pattern"][:layers],
        heads=conf["num_attention_heads"], kv_heads=conf["num_key_value_heads"],
        head_dim=conf["head_dim"], m_heads=heads, m_head_dim=head_dim,
        d_inner=heads * head_dim, groups=conf["n_groups"], state=conf["ssm_state_size"],
        conv=conf["conv_kernel"], chunk=conf["chunk_size"],
        experts=conf["router_experts"], held=conf["n_routed_experts"],
        top_k=conf["num_experts_per_tok"], ffe=conf["moe_intermediate_size"],
        ffs=conf["moe_shared_expert_intermediate_size"], vocab=conf["vocab_size"],
        rows=conf["vocab_size"], eps=conf["layer_norm_epsilon"],
        tied=conf["tie_word_embeddings"], routed_scale=conf["routed_scaling_factor"],
        capacity_factor=a["capacity_factor"], aux_weight=a["aux_loss_alpha"],
        param_dtype=a["param_dtype"])


def _conv_dim(m) -> int:
    return m.d_inner + 2 * m.groups * m.state


def layout(conf: dict, group) -> list[tuple[tuple, tuple, str]]:
    """``(path, shape, kind)`` of each weight of ``group`` (``"top"`` or a
    layer).  Mamba's ``A_log``, ``dt_bias`` and the conv's bias are drawn
    as an embedding, ``0.02 N(0, 1)`` (``A`` near -1, ``dt`` the softplus of
    the projection, near 0.8), ``D`` and the gated norm as a norm, ``1 + 0.1
    N(0, 1)``; the correction bias as a norm too: the common 1 moves no
    choice, the spread does.  So a head keeps about ``exp(-0.8)`` of its
    state a token, about one token of memory, and the pass across chunks
    adds little after the first ~10 tokens of a chunk; published Mamba2's
    draws (``dt`` in [0.001, 0.1], ``A_log = log U[1, 16]``) keep state over
    many chunks (``assumed.ssd_memory``)."""
    m = dims(conf)
    if group == "top":
        return top_layout(m)
    d, kind = m.d, m.pattern[group]
    if kind == "M":
        di, h, cd = m.d_inner, m.m_heads, _conv_dim(m)
        return [(("norm",), (d,), "norm"),
                (("mamba", "in_proj"), (d, 2 * di + 2 * m.groups * m.state + h), "linear"),
                (("mamba", "conv_w"), (m.conv, cd), "linear"),
                (("mamba", "conv_b"), (cd,), "embed"),
                (("mamba", "dt_bias"), (h,), "embed"), (("mamba", "A_log"), (h,), "embed"),
                (("mamba", "D"), (h,), "norm"), (("mamba", "norm_w"), (di,), "norm"),
                (("mamba", "out_proj"), (di, d), "linear")]
    if kind == "E":
        return [(("norm",), (d,), "norm"), (("moe", "router"), (d, m.experts), "linear"),
                (("moe", "router_bias"), (m.experts,), "norm"),
                (("moe", "w_up"), (m.held, d, m.ffe), "linear"),
                (("moe", "w_down"), (m.held, m.ffe, d), "linear"),
                (("moe", "shared", "w_up"), (d, m.ffs), "linear"),
                (("moe", "shared", "w_down"), (m.ffs, d), "linear")]
    hd = m.head_dim
    return [(("attn", "norm"), (d,), "norm"), (("attn", "wq"), (d, m.heads * hd), "linear"),
            (("attn", "wk"), (d, m.kv_heads * hd), "linear"),
            (("attn", "wv"), (d, m.kv_heads * hd), "linear"),
            (("attn", "wo"), (m.heads * hd, d), "linear")]


_PUBLISHED = {"model_type": "nemotron_h", "mlp_hidden_act": "relu2", "mamba_hidden_act": "silu",
              "attention_bias": False, "mlp_bias": False, "use_bias": False,
              "mamba_proj_bias": False, "use_conv_bias": True, "n_group": 1, "topk_group": 1,
              "norm_topk_prob": True, "n_shared_experts": 1, "residual_in_fp32": False}


def port_fields(conf: dict) -> dict:
    """The program's config fields for this file (a dict stands for a
    nested settings object, whose other fields the program's own keep)."""
    m = dims(conf)
    off = {k: conf.get(k) for k, v in _PUBLISHED.items() if conf.get(k) != v}
    if off or set(m.pattern) - set("ME*"):
        raise ValueError(f"the program runs Nemotron-H as {_PUBLISHED} with layers M, E and *; "
                         f"this file has {off} and the pattern {m.pattern!r}")
    return {"n_layers": m.layers, "d_model": m.d, "vocab_size": m.rows, "norm_eps": m.eps,
            "tie_embeddings": m.tied, "n_heads": m.heads, "n_kv_heads": m.kv_heads,
            "d_head": m.head_dim, "d_ff": 0, "pattern": m.pattern,
            "ssm": {"d_state": m.state, "d_conv": m.conv, "head_dim": m.m_head_dim,
                    "n_groups": m.groups, "chunk": m.chunk, "n_heads": m.m_heads,
                    "norm_eps": m.eps},
            "moe": {"n_experts": m.experts, "top_k": m.top_k, "d_ff_expert": m.ffe,
                    "n_shared_experts": 1, "d_ff_shared": m.ffs, "every": 1,
                    "capacity_factor": m.capacity_factor, "aux_loss_weight": m.aux_weight,
                    "scoring": "sigmoid", "correction_bias": True,
                    "routed_scale": m.routed_scale, "shared_gate": False, "balance": "sequence",
                    "activation": "relu2", "held": m.held}}


def _mamba_params(m) -> int:
    """A Mamba2 layer's weights the tokens are multiplied by: the two
    projections and the convolution."""
    return m.d * (2 * m.d_inner + 2 * m.groups * m.state + m.m_heads) + m.d_inner * m.d \
        + m.conv * _conv_dim(m)


def _attn_params(m) -> int:
    return 2 * m.d * m.heads * m.head_dim + 2 * m.d * m.kv_heads * m.head_dim


def product_params(m) -> int:
    """The weights each token is multiplied by: each layer's mixer (the
    router, ``top_k * held / experts`` routed experts a token and the
    shared expert for MoE), and the head."""
    moe = m.d * m.experts + (m.top_k * m.held / m.experts) * 2 * m.d * m.ffe + 2 * m.d * m.ffs
    per = {"M": _mamba_params(m), "*": _attn_params(m), "E": moe}
    return sum(per[c] for c in m.pattern) + m.d * m.rows


def n_params(m) -> int:
    d = m.d
    mamba = _mamba_params(m) + _conv_dim(m) + 3 * m.m_heads + m.d_inner + d
    moe = d * m.experts + m.experts + m.held * 2 * d * m.ffe + 2 * d * m.ffs + d
    per = {"M": mamba, "*": _attn_params(m) + d, "E": moe}
    return (sum(per[c] for c in m.pattern) + m.rows * d + (0 if m.tied else d * m.rows) + d)


def ssd_flops(m, batch: int, seq: int) -> int:
    """The SSD's four products a chunk of ``L``, over a Mamba2 layer's
    chunks (``C B^T`` per group, the masked product with ``x``, the chunk
    states, ``C`` times the entering state), forward and backward."""
    n_chunks = batch * -(-seq // m.chunk)
    l, h, p, n = m.chunk, m.m_heads, m.m_head_dim, m.state
    per_chunk = 2 * m.groups * l * l * n + 2 * h * l * l * p + 4 * h * l * n * p
    return 3 * per_chunk * n_chunks * m.pattern.count("M")


def train_flops(m, batch: int, seq: int) -> int:
    """A step's products: 6 x the weights a token is multiplied by x tokens,
    plus causal attention's two products forward and backward,
    ``3 B H S^2 2 Dh`` an attention layer, plus the SSD's
    (:func:`ssd_flops`); recomputation under remat not counted."""
    attn = 3 * batch * m.heads * seq * seq * 2 * m.head_dim * m.pattern.count("*")
    return int(6 * product_params(m) * batch * seq) + attn + ssd_flops(m, batch, seq)


def segsum(a: torch.Tensor) -> torch.Tensor:
    """``out[..., i, j] = a[..., j+1] + ... + a[..., i]`` below the diagonal
    (0 on it), ``-inf`` above: the minimal SSD's stable segment sum."""
    t = a.shape[-1]
    a = a[..., None].expand(*a.shape, t)  # a[..., i, j] = a_i
    below = torch.ones(t, t, dtype=torch.bool, device=a.device).tril(-1)
    out = torch.cumsum(a.masked_fill(~below, 0.0), dim=-2)
    return out.masked_fill(~torch.ones(t, t, dtype=torch.bool, device=a.device).tril(),
                           float("-inf"))


def ssd(x, a, b, c, chunk: int):
    """The Mamba2 paper's minimal discrete SSD (``ssd_minimal_discrete``):
    ``x (B, S, H, P)`` already times ``dt``, ``a (B, S, H)`` the decays
    ``dt A``, ``b``, ``c (B, S, H, N)`` each head's; ``S`` a multiple of
    ``chunk``, the state zero at the start.  Returns ``y (B, S, H, P)``."""
    bsz, s = x.shape[:2]
    nc = s // chunk
    x, a, b, c = (t.reshape(bsz, nc, chunk, *t.shape[2:]) for t in (x, a, b, c))
    a = a.permute(0, 3, 1, 2)  # (B, H, c, l)
    a_cs = torch.cumsum(a, dim=-1)
    # 1. the diagonal blocks: within each chunk
    decay = torch.exp(segsum(a))  # (B, H, c, l, s)
    y_diag = torch.einsum("bclhn,bcshn,bhcls,bcshp->bclhp", c, b, decay, x)
    # 2. each chunk's end state
    decay_states = torch.exp(a_cs[..., -1:] - a_cs)
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", b, decay_states, x)
    # 3. the states entering each chunk, by the chunk-level recurrence
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    decay_chunk = torch.exp(segsum(F.pad(a_cs[..., -1], (1, 0))))  # (B, H, c+1, c+1)
    states = torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, states)[:, :-1]
    # 4. each entering state's part of the chunk's outputs
    y_off = torch.einsum("bclhn,bchpn,bhcl->bclhp", c, states, torch.exp(a_cs))
    return (y_diag + y_off).reshape(bsz, s, *y_diag.shape[3:])


def conv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The causal depthwise convolution of ``x (B, S, C)`` by ``w (W, C)``:
    ``out_t = sum_i w_i x_{t - W + 1 + i} + bias``."""
    width, s = w.shape[0], x.shape[1]
    out = F.conv1d(x.transpose(1, 2), w.T[:, None, :], bias, padding=width - 1,
                   groups=x.shape[2])
    return out[..., :s].transpose(1, 2)


def mamba(h: torch.Tensor, w: dict, m, prec: Prec) -> torch.Tensor:
    """A Mamba2 layer, residual included."""
    bsz, s, _ = h.shape
    di, gn, nh = m.d_inner, m.groups * m.state, m.m_heads
    x = rms_norm(h, w["norm",], m.eps)
    zxbcdt = prec.mm(x, w["mamba", "in_proj"])
    z, xbc, dt = zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * gn], zxbcdt[..., 2 * di + 2 * gn:]
    xbc = silu(conv(xbc, w["mamba", "conv_w"], w["mamba", "conv_b"]))
    xs = xbc[..., :di].reshape(bsz, s, nh, m.m_head_dim)
    per_group = nh // m.groups
    b, c = (t.reshape(bsz, s, m.groups, m.state).repeat_interleave(per_group, dim=2)
            for t in (xbc[..., di:di + gn], xbc[..., di + gn:]))
    dt = F.softplus(dt + w["mamba", "dt_bias"])
    a = -torch.exp(w["mamba", "A_log"])
    pad = -s % m.chunk
    xdt, adt = xs * dt[..., None], dt * a
    if pad:
        xdt, adt, b, c = (F.pad(t, (0,) * (2 * t.dim() - 4) + (0, pad)) for t in (xdt, adt, b, c))
    y = ssd(xdt, adt, b, c, m.chunk)[:, :s] + w["mamba", "D"][:, None] * xs
    g = (y.reshape(bsz, s, di) * silu(z)).reshape(bsz, s, m.groups, di // m.groups)
    g = (g * torch.rsqrt((g * g).mean(dim=-1, keepdim=True) + m.eps)).reshape(bsz, s, di)
    return h + prec.mm(g * w["mamba", "norm_w"], w["mamba", "out_proj"])


def attention(h: torch.Tensor, w: dict, m, prec: Prec) -> torch.Tensor:
    """A GQA attention layer without positions, residual included; one
    head at a time, each recomputed in the backward pass."""
    bsz, s, _ = h.shape
    x = rms_norm(h, w["attn", "norm"], m.eps)
    heads = lambda t, n: t.view(bsz, s, n, m.head_dim).transpose(1, 2)
    q = heads(prec.mm(x, w["attn", "wq"]), m.heads)
    k, v = (heads(prec.mm(x, w["attn", k]), m.kv_heads) for k in ("wk", "wv"))
    group = m.heads // m.kv_heads
    mask = torch.ones((s, s), dtype=torch.bool, device=h.device).tril_()
    o = torch.cat([checkpoint(_head, q[:, j:j + 1], k[:, j // group:j // group + 1],
                              v[:, j // group:j // group + 1], mask, prec, use_reentrant=False)
                   for j in range(m.heads)], dim=1)
    return h + prec.mm(o.transpose(1, 2).reshape(bsz, s, m.heads * m.head_dim), w["attn", "wo"])


def _relu2(x, up, down, prec: Prec):
    return prec.mm(torch.relu(prec.mm(x, up)) ** 2, down)


def moe(h: torch.Tensor, w: dict, m, capacity: int, prec: Prec):
    """An MoE layer over the held experts, residual included: ``(h, the
    sequence-wise balance loss)``."""
    bsz, s, d = h.shape
    x = rms_norm(h, w["norm",], m.eps).reshape(bsz * s, d)
    scores = torch.sigmoid(x @ w["moe", "router"])  # the router is float32
    ids = torch.topk(scores + w["moe", "router_bias"].detach(), m.top_k, dim=-1).indices
    top_w = scores.gather(-1, ids)
    top_w = top_w / (top_w.sum(dim=-1, keepdim=True) + 1e-20) * m.routed_scale
    flat = ids.reshape(-1)
    one_hot = F.one_hot(flat, m.experts)
    keep = (torch.cumsum(one_hot, dim=0) * one_hot).sum(dim=-1) - 1 < capacity
    y = torch.zeros_like(x)
    pair_w = top_w.reshape(-1)
    for e in range(m.held):  # the experts held elsewhere add nothing here
        pairs = torch.nonzero((flat == e) & keep)[:, 0]
        if pairs.numel() == 0:
            continue
        tok = pairs // m.top_k
        ye = _relu2(x[tok], w["moe", "w_up"][e], w["moe", "w_down"][e], prec)
        y.index_add_(0, tok, ye * pair_w[pairs, None])
    y = y + _relu2(x, w["moe", "shared", "w_up"], w["moe", "shared", "w_down"], prec)
    f = one_hot.view(bsz, s * m.top_k, m.experts).sum(dim=1).float() * (m.experts / (m.top_k * s))
    p = (scores / scores.sum(dim=-1, keepdim=True)).view(bsz, s, m.experts).mean(dim=1)
    return h + y.view(bsz, s, d), torch.sum(f * p, dim=-1).mean()


def layer(h: torch.Tensor, w: dict, i: int, m, capacity: int, prec: Prec):
    """Layer ``i``: ``(h, its balance loss)`` (0 but for an MoE layer)."""
    kind = m.pattern[i]
    if kind == "E":
        return moe(h, w, m, capacity, prec)
    h = mamba(h, w, m, prec) if kind == "M" else attention(h, w, m, prec)
    return h, h.new_zeros(())


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
