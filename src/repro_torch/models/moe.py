"""Mixture-of-Experts layer with scatter-based dispatch (port of ``repro.models.moe``).

The serving path's MoE FFN, for one device (the reference's
``n_dispatch_shards = 1``):

  1. router logits in float32 -> softmax -> top-k (weights, ids), weights
     renormalised over the k (``norm_topk``);
  2. position of each routed pair within its expert, counted over the
     flattened ``(T * k)`` pairs, token-major and k-minor (the reference's
     one-hot running count, computed here by a stable sort of the pairs by
     expert: the same integers without the ``(T * k, E)`` one-hot);
  3. pairs past the expert's capacity are dropped, the kept ones copied into
     per-expert capacity slabs ``(E, C, D)`` (one pair per slot, so the copy
     is exact in any order; dropped pairs go to a spare row that is cut off);
  4. the expert SwiGLU over the slabs through :func:`repro_torch.kernels.moe_mlp`;
  5. each kept pair's output gathered back and combined with its router
     weight in float32, plus the shared experts under their sigmoid gate.

``expert_perm`` (E,) maps a logical expert to the slab slot holding its
weights, as in the reference.  The reference's shard_map dispatch paths have
no counterpart here: there is no mesh.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels import moe_mlp
from .layers import dot_f32, init_linear

__all__ = ["dispatch", "expert_positions", "init_moe_params", "moe_ffn", "recorded_routing",
           "route", "router_load_balancing_loss"]

_routing: Optional[list] = None  # the active recorded_routing's list


@contextlib.contextmanager
def recorded_routing():
    """Collect, while active, the expert ids ``(T, k)`` that each
    :func:`moe_ffn` call routes to (slab slots, after ``expert_perm``), in
    call order.  Nothing is copied or waited for: the list holds the
    device tensors."""
    global _routing
    saved, _routing = _routing, []
    try:
        yield _routing
    finally:
        _routing = saved


def init_moe_params(gen: torch.Generator, d_model: int, cfg, dtype) -> dict:
    """cfg is a configs.base.MoESettings."""
    def experts(d_in, d_out):
        w = torch.randn((cfg.n_experts, d_in, d_out), generator=gen, device=gen.device,
                        dtype=torch.float32)
        return w.mul_(d_in ** -0.5).to(dtype)

    p = {
        "router": init_linear(gen, d_model, cfg.n_experts, torch.float32),
        "w_gate": experts(d_model, cfg.d_ff_expert),
        "w_up": experts(d_model, cfg.d_ff_expert),
        "w_down": experts(cfg.d_ff_expert, d_model),
    }
    if cfg.n_shared_experts:
        f_shared = cfg.n_shared_experts * cfg.d_ff_expert
        p["shared"] = {
            "w_gate": init_linear(gen, d_model, f_shared, dtype),
            "w_up": init_linear(gen, d_model, f_shared, dtype),
            "w_down": init_linear(gen, f_shared, d_model, dtype),
            "gate": init_linear(gen, d_model, 1, torch.float32),
        }
    return p


def router_load_balancing_loss(router_probs, expert_ids, n_experts: int) -> torch.Tensor:
    """Switch-Transformer aux loss: E * sum_e f_e * p_e (1.0 at uniform)."""
    ids = expert_ids.reshape(-1)
    counts = torch.zeros(n_experts, device=ids.device).index_add_(
        0, ids, torch.ones(ids.shape, device=ids.device))  # whole numbers: exact in any order
    frac_tokens = counts / counts.sum().clamp(min=1.0)
    return n_experts * torch.sum(frac_tokens * router_probs.mean(dim=0))


def route(x, router, top_k: int, norm_topk: bool = True):
    """``(probs (T, E), weights (T, k), ids (T, k))`` of tokens ``x (T, D)``."""
    probs = torch.softmax(dot_f32(x, router), dim=-1)
    weights, ids = torch.topk(probs, top_k, dim=-1)
    if norm_topk:
        weights = weights / weights.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    return probs, weights, ids


def expert_positions(ids_flat: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Position of each routed pair among the earlier pairs of its expert.

    ``ids_flat (N,)`` in pair order; returns ``pos (N,)`` with ``pos[i]`` the
    number of ``j < i`` with ``ids_flat[j] == ids_flat[i]``, the reference's
    ``(cumsum(one_hot) * one_hot).sum(-1) - 1``.  A stable sort keeps each
    expert's pairs in pair order; no step waits for the device.
    """
    n = ids_flat.shape[0]
    order = torch.argsort(ids_flat, stable=True)
    counts = torch.zeros(n_experts, dtype=torch.long, device=ids_flat.device).index_add_(
        0, ids_flat, torch.ones_like(ids_flat))
    starts = torch.cumsum(counts, dim=0) - counts
    ranks = torch.arange(n, device=ids_flat.device) - starts[ids_flat[order]]
    return torch.empty_like(ids_flat).scatter_(0, order, ranks)


def dispatch(x: torch.Tensor, ids: torch.Tensor, n_experts: int, capacity: int):
    """Capacity slabs of the routed pairs of tokens ``x (T, D)`` with expert
    ids ``ids (T, k)``.

    Returns ``(slab (E, C, D), rows (T * k,), keep (T * k,))``: the slab row of
    each pair (token-major, k-minor) and whether it was kept.  A dropped
    pair's row is the spare row ``E * C`` past the slabs; unfilled slab rows,
    and so every row of an expert no pair chose, are zeros.
    """
    t, top_k = ids.shape
    ids_flat = ids.reshape(t * top_k)
    pos = expert_positions(ids_flat, n_experts)
    keep = pos < capacity
    rows = torch.where(keep, ids_flat * capacity + pos, n_experts * capacity)
    pair_token = torch.arange(t * top_k, device=x.device) // top_k
    slab = x.new_zeros((n_experts * capacity + 1, x.shape[1]))
    slab[rows] = x[pair_token]
    return slab[: n_experts * capacity].view(n_experts, capacity, x.shape[1]), rows, keep


def moe_ffn(
    x: torch.Tensor,  # (T, D) flattened tokens
    params,
    n_experts: int,
    top_k: int,
    capacity: int,
    *,
    norm_topk: bool = True,
    expert_perm: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (T, D), aux load-balancing loss)."""
    t, d = x.shape
    probs, weights, ids = route(x, params["router"], top_k, norm_topk)
    aux = router_load_balancing_loss(probs, ids, n_experts)
    if expert_perm is not None:
        ids = expert_perm.to(ids.device)[ids]  # logical -> physical slot
    if _routing is not None:
        _routing.append(ids)

    slab, rows, keep = dispatch(x, ids, n_experts, capacity)
    out_slab = moe_mlp(slab, params["w_gate"], params["w_up"], params["w_down"])

    y_pairs = out_slab.view(n_experts * capacity, d)[rows.clamp(max=n_experts * capacity - 1)]
    y_pairs = y_pairs.float().masked_fill(~keep[:, None], 0.0)  # (T * k, D)
    y = (y_pairs * weights.reshape(t * top_k, 1)).reshape(t, top_k, d).sum(dim=1)
    y = y.to(x.dtype)

    if "shared" in params:
        sp = params["shared"]
        hs = (F.silu(dot_f32(x, sp["w_gate"])) * dot_f32(x, sp["w_up"])).to(x.dtype)
        ys = hs @ sp["w_down"]
        sg = torch.sigmoid(dot_f32(x, sp["gate"]))  # (T, 1)
        y = y + (ys.float() * sg).to(x.dtype)
    return y, aux
