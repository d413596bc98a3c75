"""Mixture-of-Experts layer with scatter-based dispatch (port of ``repro.models.moe``).

The MoE FFN:

  1. router logits in float32 -> softmax -> top-k (weights, ids), weights
     renormalised over the k (``norm_topk``); or (DeepSeek-V3,
     ``scoring="sigmoid"``) sigmoid scores, the top-k of the scores plus
     the correction bias ``router_bias`` where the layer has one (the bias
     picks the experts and gets no gradient), the unbiased scores at those
     experts as the weights, renormalised and times ``routed_scale``;
  2. position of each routed pair within its expert, counted over the
     flattened ``(T * k)`` pairs, token-major and k-minor (the reference's
     one-hot running count, computed here by a stable sort of the pairs by
     expert: the same integers without the ``(T * k, E)`` one-hot); with
     ``n_dispatch_shards = ns`` the pairs split into ``ns`` runs and each
     expert's capacity into ``ns`` slices, counted per run (the reference's
     slab ``(E, ns, cap/ns, D)``);
  3. pairs past the expert's capacity are dropped, the kept ones copied into
     per-expert capacity slabs ``(E, C, D)`` (one pair per slot, so the copy
     is exact in any order; dropped pairs go to a spare row that is cut off);
  4. the expert FFN over the slabs, a SwiGLU (or, with
     ``activation="relu2"``, Nemotron-H's non-gated squared ReLU,
     :func:`~repro_torch.models.layers.relu2_mlp`, which has no kernel):
     the SwiGLU through the forward-only kernel
     :func:`repro_torch.kernels.moe_mlp` when serving, through
     :func:`~repro_torch.models.layers.swiglu` batched over the experts
     when training (``train=True``): the reference's three ``einsum``
     products (``src/repro/models/moe.py:269-272``; gate and up with
     float32 sums and output, through :func:`~repro_torch.models.layers.dot_f32`,
     whose bf16 operands run on the tensor cores of a CUDA device and whose
     backward pass splits the float32 gradient into two bf16 terms so that
     its products run there too; ``silu(gate) * up`` and the down product
     in the activation type) in differentiable PyTorch, as the reference
     trains through them and not through its kernel;
  5. each kept pair's output gathered back and combined with its router
     weight in float32, plus the shared experts (the same FFN over every
     token) under their sigmoid gate where they have one
     (``shared["gate"]``), added as they are where they have none.

The routing policy is the layer's settings, :class:`~repro_torch.archs.RoutedMoESettings`
(the reference's ``MoESettings`` read as its defaults): the scoring, the
bias, the scale, the balance loss, the activation and the experts held.
The aux loss is the Switch loss over the microbatch, or with
``balance="sequence"`` DeepSeek-V3's sequence-wise balance loss over each
packed row (:func:`sequence_balance_loss`).

**Experts held** (``held``): a layer told that it holds experts ``0 ..
held - 1`` of the router's ``n_experts`` (its chip's share of an
expert-parallel group) routes over all of them, as the router, its bias,
the capacity and the balance loss do, and computes only its own experts'
part of the result: a pair routed to an expert it does not hold is left
out, and no exchange stands in for the chips that hold the others.

Spans (:func:`~repro_torch.runtime.spans.traced`): ``repro_torch.moe.route``
(step 1 and the aux loss; the bias comes detached), ``.dispatch`` (2-3,
counting ``moe.kept_pairs`` and ``moe.slots`` of the experts held, and
``moe.foreign_pairs``, the pairs routed to experts held elsewhere),
``.experts``, ``.combine`` and ``.shared``.

``expert_perm`` (E,) maps a logical expert to the slab slot holding its
weights, as in the reference.  On DTensors (a mesh profile installed, see
:mod:`~repro_torch.models.spmd`) steps 2-5 run on each rank's shards, the
counterpart of the reference's ``_dispatch_shard_map``: the scatter and
gather are shard-local, and when E divides the 'model' axis each rank
builds and runs only its expert slice.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch

from ..archs import routed_settings
from ..configs.base import MoESettings
from ..kernels import moe_mlp
from ..runtime import spans
from ..runtime.axes import get_activation_sharding
from .layers import dot_f32, init_linear, normal, relu2_mlp, swiglu
from .spmd import (grad_layout, is_dtensor, local_index, placements, reduce_rows, shard_map,
                   slab_sum, whole)

__all__ = ["dispatch", "expert_positions", "init_moe_params", "moe_ffn", "recorded_routing",
           "route", "router_load_balancing_loss", "sequence_balance_loss"]

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
    """cfg is a configs.base.MoESettings (or the port's RoutedMoESettings,
    whose correction bias starts at zero, whose experts may have no gate or
    be fewer than the router's and whose shared experts may have no gate)."""
    r = routed_settings(cfg)
    gated = r.activation == "swiglu"

    def experts(d_in, d_out):
        return normal(gen, (r.n_held, d_in, d_out)).mul_(d_in ** -0.5).to(dtype)

    p = {"router": init_linear(gen, d_model, r.n_experts, torch.float32)}
    if gated:
        p["w_gate"] = experts(d_model, r.d_ff_expert)
    p["w_up"] = experts(d_model, r.d_ff_expert)
    p["w_down"] = experts(r.d_ff_expert, d_model)
    if r.correction_bias:
        p["router_bias"] = torch.zeros((r.n_experts,), dtype=torch.float32, device=gen.device)
    if r.n_shared_experts:
        f_shared = r.shared_width
        p["shared"] = {"w_gate": init_linear(gen, d_model, f_shared, dtype)} if gated else {}
        p["shared"]["w_up"] = init_linear(gen, d_model, f_shared, dtype)
        p["shared"]["w_down"] = init_linear(gen, f_shared, d_model, dtype)
        if r.shared_gate:
            p["shared"]["gate"] = init_linear(gen, d_model, 1, torch.float32)
    return p


def _expert_weights(p, activation: str) -> tuple:
    """The expert FFN's weights in its order: ``(w_gate, w_up, w_down)``
    for a SwiGLU, ``(w_up, w_down)`` for the squared ReLU."""
    names = ("w_up", "w_down") if activation == "relu2" else ("w_gate", "w_up", "w_down")
    return tuple(p[k] for k in names)


def _expert_counts(ids, n_experts: int) -> torch.Tensor:
    """Pairs routed to each expert, float32 ``(E,)`` (whole numbers: exact in any order)."""
    ids = ids.reshape(-1)
    return torch.zeros(n_experts, device=ids.device).index_add_(
        0, ids, torch.ones(ids.shape, device=ids.device))


def router_load_balancing_loss(router_probs, expert_ids, n_experts: int) -> torch.Tensor:
    """Switch-Transformer aux loss: E * sum_e f_e * p_e (1.0 at uniform)."""
    if is_dtensor(expert_ids):  # each rank counts its tokens' pairs; the sum is the reduction
        from torch.distributed.tensor import Partial, Replicate, Shard

        in_pl = placements(expert_ids.shape, ("batch", None))
        out_pl = [Partial() if isinstance(p, Shard) else Replicate() for p in in_pl]
        counts = shard_map(lambda ids: _expert_counts(ids, n_experts), (expert_ids,), (in_pl,),
                           out_pl)
        counts = counts.redistribute(counts.device_mesh, [Replicate()] * len(out_pl))
    else:
        counts = _expert_counts(expert_ids, n_experts)
    frac_tokens = counts / counts.sum().clamp(min=1.0)
    return n_experts * torch.sum(frac_tokens * router_probs.mean(dim=0))


def sequence_balance_loss(scores, expert_ids, n_experts: int, rows: int) -> torch.Tensor:
    """DeepSeek-V3's sequence-wise balance loss: the mean over the ``rows``
    packed rows of ``sum_e f_e * P_e``, with ``f_e = E / (k S)`` times the
    row's pairs routed to ``e`` and ``P_e`` the row's mean of the normalised
    scores ``s / sum(s)`` (1.0 at uniform).  ``scores (T, E)`` and
    ``expert_ids (T, k)`` hold the rows one after another."""
    if is_dtensor(expert_ids):
        raise NotImplementedError("the sequence-wise balance loss runs on one device")
    t, k = expert_ids.shape
    s = t // rows
    ids = expert_ids.reshape(rows, s * k)
    counts = torch.zeros((rows, n_experts), device=ids.device).scatter_add_(
        1, ids, torch.ones(ids.shape, device=ids.device))
    p = (scores / scores.sum(dim=-1, keepdim=True)).reshape(rows, s, n_experts).mean(dim=1)
    return torch.sum(counts * (n_experts / (k * s)) * p, dim=-1).mean()


def _sigmoid_choice(scores, bias, top_k: int):
    """The experts the sigmoid scores (plus the correction bias, which
    only picks: no gradient flows through the ids) choose: ``(T, k)`` ids."""
    if bias is not None:
        scores = scores + bias
    return torch.topk(scores, top_k, dim=-1).indices


def route(x, router, top_k: int, norm_topk: bool = True, *, scoring: str = "softmax",
          bias=None, routed_scale: float = 1.0):
    """``(probs (T, E), weights (T, k), ids (T, k))`` of tokens ``x (T, D)``.
    ``scoring="sigmoid"``: ``probs`` are the sigmoid scores, the experts the
    top-k of the scores plus ``bias`` (no gradient reaches it), the weights
    the scores at those experts, renormalised with ``norm_topk`` and times
    ``routed_scale``.  On DTensors the scoring and top-k run on each rank's
    tokens (without a bias)."""
    def local(logits, bias=None):
        if scoring == "sigmoid":
            probs = torch.sigmoid(logits)
            ids = _sigmoid_choice(probs, bias, top_k)
            weights = probs.gather(-1, ids)
            if norm_topk:
                weights = weights / (weights.sum(dim=-1, keepdim=True) + 1e-20)
            return probs, weights * routed_scale, ids
        probs = torch.softmax(logits, dim=-1)
        weights, ids = torch.topk(probs, top_k, dim=-1)
        if norm_topk:
            weights = weights / weights.sum(dim=-1, keepdim=True).clamp(min=1e-9)
        return probs, weights, ids

    logits = dot_f32(x, whole(router))
    if not is_dtensor(logits):
        return local(logits, bias)
    if bias is not None:
        raise NotImplementedError("routing with a correction bias runs on one device")
    pl = placements(logits.shape, ("batch", None))
    k_pl = placements((logits.shape[0], top_k), ("batch", None))
    return shard_map(local, (logits,), (pl,), (pl, k_pl, k_pl))


@spans.traced("repro_torch.moe.route")
def _route(x, router, bias, top_k: int, n_experts: int, norm_topk: bool, scoring: str,
           routed_scale: float, seq_rows: int):
    """``(weights, ids, aux)``: :func:`route`'s weights and ids of tokens
    ``x (T, D)`` and the balance loss of their routing, the Switch loss or,
    with ``seq_rows``, the sequence-wise loss over that many rows."""
    probs, weights, ids = route(x, router, top_k, norm_topk, scoring=scoring, bias=bias,
                                routed_scale=routed_scale)
    if seq_rows:
        return weights, ids, sequence_balance_loss(probs, ids, n_experts, seq_rows)
    return weights, ids, router_load_balancing_loss(probs, ids, n_experts)


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


@spans.traced("repro_torch.moe.dispatch")
def dispatch(x: torch.Tensor, ids: torch.Tensor, n_experts: int, capacity: int,
             n_shards: int = 1, experts: Optional[tuple[int, int]] = None):
    """Capacity slabs of the routed pairs of tokens ``x (T, D)`` with expert
    ids ``ids (T, k)``.

    The pairs (token-major, k-minor) fall into ``n_shards`` equal runs, one
    per dispatch shard; each expert's capacity splits into one slice of
    ``capacity / n_shards`` per shard, and a pair's position is counted
    among the earlier pairs of its expert in its own shard (the reference's
    slab ``(E, ns, cap/ns, D)``, the per-shard running count).  With
    ``experts = (e0, n)`` only experts ``e0 .. e0 + n - 1`` get slabs (a
    rank's expert slice) and pairs routed elsewhere count as dropped here.

    Returns ``(slab (n, capacity, D), rows (T * k,), keep (T * k,))``: the
    slab row of each pair and whether it was kept.  A dropped pair's row is
    the spare row ``n * capacity`` past the slabs; unfilled slab rows, and
    so every row of an expert no pair chose, are zeros.  Counts the pairs
    kept (``moe.kept_pairs``), the slots they were kept in (``moe.slots``)
    and, with ``experts``, the pairs routed to experts outside it
    (``moe.foreign_pairs``).
    """
    t, top_k = ids.shape
    n_pairs = t * top_k
    cap_l = capacity // n_shards
    ids_flat = ids.reshape(n_pairs)
    key = ids_flat  # the (expert, shard) slice of each pair
    if n_shards > 1:
        shard = torch.arange(n_pairs, device=x.device) // (n_pairs // n_shards)
        key = ids_flat * n_shards + shard
    pos = expert_positions(key, n_experts * n_shards)
    keep = pos < cap_l
    e0, n_exp = experts or (0, n_experts)
    held = None
    if experts is not None:
        held = (ids_flat >= e0) & (ids_flat < e0 + n_exp)
        keep = keep & held
    n_rows = n_exp * capacity
    rows = torch.where(keep, (key - e0 * n_shards) * cap_l + pos, n_rows)
    pair_token = torch.arange(n_pairs, device=x.device) // top_k
    slab = x.new_zeros((n_rows + 1, x.shape[1]))
    slab[rows] = x[pair_token]
    if spans.is_on():
        spans.count("moe.kept_pairs", keep.sum())
        spans.count("moe.slots", n_rows)
        if held is not None:
            spans.count("moe.foreign_pairs", n_pairs - held.sum())
    return slab[:n_rows].view(n_exp, capacity, x.shape[1]), rows, keep


def _routed_experts(x, ids, weights, ws: tuple, n_experts: int, capacity: int,
                    n_shards: int, e0: Optional[int], experts, own=None):
    """The routed experts' combined output ``(T, D)`` in float32 of tokens
    ``x (T, D)``: dispatch, the expert FFN ``experts`` with the weights
    ``ws`` over the slabs, each kept pair's output gathered back and
    weighted.  ``e0`` set: the weights hold experts ``e0 ..`` only, and
    pairs routed elsewhere add nothing.  ``own`` set: ``weights`` are those
    of tokens ``own .. own + len(weights)`` only, whose outputs alone are
    combined."""
    window = None if e0 is None else (e0, ws[0].shape[0])
    slab, rows, keep = dispatch(x, ids, n_experts, capacity, n_shards, window)
    out_slab = _expert_ffn(experts, slab, *ws)
    return _combine(out_slab, rows, keep, weights, capacity, ids.shape[1], own)


@spans.traced("repro_torch.moe.experts")
def _expert_ffn(experts, slab, *ws):
    """The expert FFN ``experts`` over the capacity slabs."""
    return experts(slab, *ws)


@spans.traced("repro_torch.moe.combine")
def _combine(out_slab, rows, keep, weights, capacity: int, top_k: int, own):
    """Each kept pair's row of ``out_slab`` gathered back, weighted by its
    router weight and summed over the token's pairs, in float32."""
    t = rows.shape[0] // top_k
    d = out_slab.shape[-1]

    # A dropped pair reads a slab row of its own (its pair index; the value is
    # masked out), not one shared row: in the backward pass the gather's
    # index-add would otherwise sum every dropped pair into one row, in turn.
    n_rows = out_slab.shape[0] * capacity
    pairs = torch.arange(t * top_k, device=rows.device)
    if own is not None:
        t = weights.shape[0]
        pairs = pairs[own * top_k : (own + t) * top_k]
        rows, keep = rows[pairs], keep[pairs]
    y_pairs = out_slab.view(n_rows, d)[torch.where(keep, rows, pairs % n_rows)]
    y_pairs = y_pairs.float().masked_fill(~keep[:, None], 0.0)  # (T * k, D)
    return (y_pairs * weights.reshape(t * top_k, 1)).reshape(t, top_k, d).sum(dim=1)


def _routed_experts_sharded(x, ids, weights, ws: tuple, n_experts: int, capacity: int, ns: int,
                            experts, expert_perm):
    """:func:`_routed_experts` on DTensors, on each rank's shards.

    The tokens stay split over the data axes when the dispatch shards
    match them (each rank scatters into its own capacity slices; no
    collective), else they are gathered whole.  When E divides the 'model'
    axis, each rank builds and runs only its expert slice, and the output
    is a partial sum over 'model' (the combine's one all-reduce);
    otherwise every rank runs every expert.

    Where the rules split the experts' F dim as well (over 'data', for a
    large expert leaf: the reference's compute-stationary experts), the
    weights stay on their shards when that moves fewer bytes than
    gathering them (decode, and a train step with few tokens a rank): the
    tokens are gathered over the mesh axes that split F, each rank runs the
    expert FFN on its ``(E/tp, D, F/data)`` slice, the partial output slabs
    are summed over those axes in float32
    (:func:`~repro_torch.models.spmd.slab_sum`), and each rank combines its
    own tokens' pairs.  The bytes compared are the tokens' gather and the
    slab sum against the slices' gather, and in a step that needs
    gradients also their backward passes: the slabs' gradient summed and
    the gathered tokens' gradient summed over the F ranks and 'model',
    against the slices' gradient reduce-scattered.  Where the slices are
    the fewer bytes (prefill, a train step over many tokens), and in a step
    that needs gradients whose tokens do not split over the F ranks, the F
    dim is gathered, the weights' layout in every other case."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    prof = get_activation_sharding()
    mesh = prof.mesh
    tp = next((a for a in prof.logical.get("model", ()) if a in mesh.mesh_dim_names), None)
    tp_size = prof.axis_size((tp,)) if tp else 1
    split = tp_size > 1 and n_experts % tp_size == 0
    rows_pl = placements(x.shape, ("batch", None))  # the combine's: this rank's tokens
    f_dims = [d for d, p in enumerate(ws[0].placements)
              if isinstance(p, Shard) and p.dim == 2 and mesh.size(d) > 1]
    if f_dims:  # bytes a rank sends either way (ring model), from shapes alone
        grad = torch.is_grad_enabled() and ws[0].requires_grad
        n_f = math.prod(mesh.size(d) for d in f_dims)
        x_ways = math.prod(mesh.size(d) for d in f_dims if isinstance(rows_pl[d], Shard))
        x_bytes = x.to_local().numel() * x.element_size()
        rows_ways = math.prod(n for n, pl in zip(mesh.shape, rows_pl) if isinstance(pl, Shard))
        slab = ((n_experts // tp_size if split else n_experts) * (capacity * x_ways // rows_ways)
                * x.shape[1] * 4)
        slab_sum_bytes = 2 * slab * (n_f - 1) / n_f
        keep = x_bytes * (x_ways - 1) + slab_sum_bytes  # gather the tokens, sum the slabs
        gather = sum(w.to_local().numel() * w.element_size() for w in ws) * (n_f - 1)
        if grad:  # and back: the slabs' gradient summed; the gathered tokens' gradient summed
            # over the F ranks and over 'model'; the gathered slices' gradient reduce-scattered
            keep += slab_sum_bytes + 2 * x_bytes * (x_ways * (n_f - 1) / n_f
                                                    + (x_ways - 1) * (tp_size - 1) / tp_size)
            gather *= 2
        # a gradient needs the combine split over the F ranks (see slab_sum)
        if keep >= gather or (grad and x_ways < n_f):
            f_dims = []  # the F dim is gathered
    # the dispatch's tokens: gathered over the experts' F slices
    x_pl = [Replicate() if d in f_dims else p for d, p in enumerate(rows_pl)]
    ways = math.prod(n for n, pl in zip(mesh.shape, x_pl) if not isinstance(pl, Replicate))
    if ns % ways:
        ns, x_pl = 1, placements(x.shape, (None, None))
        ways = 1
        if not f_dims:
            rows_pl = x_pl
    own_dims = [d for d, (p, q) in enumerate(zip(rows_pl, x_pl))
                if isinstance(p, Shard) and not isinstance(q, Shard) and mesh.size(d) > 1]
    if f_dims:
        w_pls = [list(w.placements) for w in ws]
    else:
        w_pls = [placements(ws[0].shape, ("model" if split else None, None, None))] * len(ws)
    names = mesh.mesh_dim_names
    y_pl = [Partial() if split and names[d] == tp else p for d, p in enumerate(rows_pl)]

    def ffn(*a):  # with the F dim split, the partial output slabs summed over its ranks
        out = experts(*a)
        return slab_sum(out.float(), f_dims, mesh) if f_dims else out

    def local(x, ids, weights, *ws):
        if expert_perm is not None:
            ids = expert_perm.to(ids.device)[ids]
        e0 = local_index(tp, True) * ws[0].shape[0] if split else None
        own = None
        if own_dims:  # this rank's block of the tokens, in DTensor's chunk order
            own = 0
            for d in own_dims:
                own = own * mesh.size(d) + mesh.get_local_rank(d)
            own *= weights.shape[0]
        return _routed_experts(x, ids, weights, ws, n_experts, capacity // ways, ns // ways, e0,
                               ffn, own)

    y = shard_map(local, (x, ids, weights, *ws), (x_pl, x_pl, rows_pl, *w_pls), y_pl)
    return reduce_rows(y)


def moe_ffn(
    x: torch.Tensor,  # (T, D) flattened tokens
    params,
    n_experts: int,
    top_k: int,
    capacity: int,
    *,
    norm_topk: bool = True,
    expert_perm: Optional[torch.Tensor] = None,
    n_dispatch_shards: int = 1,
    train: bool = False,
    routing=None,
    rows: int = 1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (T, D), aux load-balancing loss).

    ``routing``, the layer's settings (a ``MoESettings`` or the port's
    ``RoutedMoESettings``; None: the reference's defaults), sets the
    policy: its ``scoring``, ``routed_scale`` and ``params["router_bias"]``
    (where the layer has one) choose the experts and weigh them
    (:func:`route`); ``balance="sequence"`` takes DeepSeek-V3's
    sequence-wise balance loss over the ``rows`` packed rows of ``x`` in
    place of the Switch loss; ``activation`` names the experts' FFN; with
    ``held`` the layer holds experts ``0 .. held - 1`` of the ``n_experts``
    it routes over, and pairs routed to the others are left out.

    ``n_dispatch_shards`` (the data-parallel degree under a mesh profile)
    splits each expert's capacity into per-shard slices, the reference's
    slab ``(E, ns, cap/ns, D)`` (see :func:`dispatch`); it falls back to 1
    where tokens or capacity do not split into shards of at least ``top_k``
    slots, as the reference's does.  ``train`` runs a SwiGLU's experts
    through ``swiglu`` (differentiable) in place of the ``moe_mlp`` kernel
    (forward only)."""
    r = routed_settings(routing or MoESettings(n_experts, top_k, 0))
    activation = r.activation
    held = r.held if r.held < n_experts else 0
    t, d = x.shape
    x = grad_layout(x, "batch", None)
    bias = params["router_bias"].detach() if "router_bias" in params else None
    weights, ids, aux = _route(x, params["router"], bias, top_k, n_experts, norm_topk, r.scoring,
                               r.routed_scale, rows if r.balance == "sequence" else 0)
    ns = n_dispatch_shards
    if ns < 1 or t % ns or capacity % ns or capacity // ns < top_k:
        ns = 1  # decode-sized batches: slices would be thinner than top_k
    if activation == "relu2":
        experts = relu2_mlp
    else:
        experts = swiglu if train else moe_mlp
    ws = _expert_weights(params, activation)

    if is_dtensor(x):
        if held:
            raise NotImplementedError("a layer holding part of its experts runs on one device")
        y = _routed_experts_sharded(x, ids, weights, ws, n_experts, capacity, ns, experts,
                                    expert_perm)
    else:
        if expert_perm is not None:
            ids = expert_perm.to(ids.device)[ids]  # logical -> physical slot
        if _routing is not None:
            _routing.append(ids)
        y = _routed_experts(x, ids, weights, ws, n_experts, capacity, ns, 0 if held else None,
                            experts)
    y = y.to(x.dtype)

    if "shared" in params:
        sh = params["shared"]
        y = y + _shared_experts(x, activation, sh["gate"] if "gate" in sh else None,
                                *_expert_weights(sh, activation))
    return y, aux


@spans.traced("repro_torch.moe.shared")
def _shared_experts(x, activation: str, gate, *ws):
    """The shared experts' FFN (``activation``, weights ``ws``) of every
    token ``x (T, D)``, under their sigmoid gate where they have one
    (``gate (D, 1)``)."""
    ys = (relu2_mlp if activation == "relu2" else swiglu)(x, *ws)
    if gate is not None:
        ys = (ys.float() * torch.sigmoid(dot_f32(x, whole(gate)))).to(x.dtype)
    return ys
