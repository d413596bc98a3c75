"""Mamba2 (SSD — state-space duality) mixer (port of ``repro.models.mamba2``).

The chunked SSD algorithm: quadratic, attention-like products *within*
chunks of length L and a linear recurrence *across* chunks, here a Python
loop over the chunk axis where the reference scans it.  The reference has no
kernel for any of this, so the port is plain PyTorch: batched products and
elementwise ops, with every sum in float32 as the reference takes it.

Shapes (G state groups, Hg = H // G heads per group):
  x   (B, S, H, P)     inputs per head (P = head_dim)
  dt  (B, S, H)        softplus-discretized step sizes
  A   (H,)             negative decay rates
  Bm  (B, S, G, N)     input projections (N = d_state)
  Cm  (B, S, G, N)     output projections

Decode is the O(1) recurrent form over a persistent (B, H, P, N) state.

The mixer's width is ``expand * d`` as the reference sizes it, or, for the
port's :class:`~repro_torch.archs.MambaSettings` with ``n_heads``, heads times
``head_dim`` (Nemotron-H); its gated norm is one RMSNorm over the width at
1e-6 as the reference takes it, or, for ``MambaSettings``, one per group
of ``d_inner / n_groups`` channels at the settings' epsilon, as published
Mamba2 takes it.

Spans (:func:`~repro_torch.runtime.spans.traced`): ``repro_torch.mamba``
(the whole mixer of :func:`mamba_mixer`: in_proj, conv, SSD, gated norm,
out_proj) and ``repro_torch.mamba.ssd`` (:func:`ssd_chunked`, counting each
row's chunks in ``mamba.chunks``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..archs import MambaSettings, mamba_width
from ..runtime import spans
from ..runtime.axes import get_activation_sharding, hint
from .layers import init_linear, linear, normal, rms_norm, rms_norm_grouped
from .spmd import (col, col_linear, is_dtensor, local_index, model_ways,
                   placements, replicated_like, row_linear, rows_move, shard_map, split_parts,
                   to_layout_of, weight_layout)

__all__ = [
    "ssd_chunked",
    "ssd_decode_step",
    "init_mamba_params",
    "mamba_mixer",
    "mamba_decode_step",
    "causal_conv1d",
    "conv_decode_step",
]


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """Lower-triangular segment sums: out[..., i, j] = sum_{j < s <= i} a[..., s].

    Entries with j > i are -inf (they exponentiate to 0 in the decay matrix).
    """
    l = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]  # sum_{j < s <= i}
    above = torch.ones((l, l), dtype=torch.bool, device=a.device).triu_(1)
    return diff.masked_fill_(replicated_like(a, above), float("-inf"))


@spans.traced("repro_torch.mamba.ssd")
def ssd_chunked(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    *,
    chunk: int = 256,
    initial_state: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.  Returns (y (B,S,H,P), final_state (B,H,P,N) float32).

    The reference's four-operand contractions are taken two operands at a
    time, so that nothing larger than the (B, nc, G, Hg, L, L) decay matrix
    is built.
    """
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    hg = h // g
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        # dt = 0 padding is state-neutral: exp(0·A) = 1 decay, zero input.
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    s_orig, s = s, s + pad
    nc = s // chunk
    spans.count("mamba.chunks", b * nc)

    # Chunked views, grouped heads: (B, nc, L, G, Hg, ...)
    dtc = dt.reshape(b, nc, chunk, g, hg).float()
    bc = Bm.reshape(b, nc, chunk, g, n).float()
    cc = Cm.reshape(b, nc, chunk, g, n).float()
    xdt = x.reshape(b, nc, chunk, g, hg, p).float() * dtc[..., None]  # discretized input
    da = (dtc * A.reshape(g, hg)).movedim(2, -1)  # (B,nc,G,Hg,L), negative
    da_cs = torch.cumsum(da, dim=-1)

    # 1. Intra-chunk (diagonal blocks): attention-like quadratic form.
    scores = _segsum(da).exp_()  # (B,nc,G,Hg,L,S) lower-triangular decays
    cb = torch.einsum("bclgn,bcsgn->bcgls", cc, bc).unsqueeze(3)
    # In place when nothing is differentiated (serving's peak); autograd
    # needs the decays exp_ saved, so a product it records is a new tensor.
    scores = scores * cb if scores.requires_grad or cb.requires_grad else scores.mul_(cb)
    y = torch.einsum("bcgrls,bcsgrp->bclgrp", scores, xdt)
    del scores

    # 2. Per-chunk end states.
    decay_states = torch.exp(da_cs[..., -1:] - da_cs)  # (B,nc,G,Hg,L)
    states = torch.einsum("bcsgn,bcsgrp->bcgrpn", bc,
                          xdt * decay_states.permute(0, 1, 4, 2, 3)[..., None])

    # 3. Inter-chunk recurrence, emitting the state *entering* each chunk.
    chunk_decay = torch.exp(da_cs[..., -1])  # (B,nc,G,Hg)
    if initial_state is None:
        state = x.new_zeros((b, g, hg, p, n), dtype=torch.float32)
    else:
        state = initial_state.reshape(b, g, hg, p, n).float()
    entering = []
    for c in range(nc):
        entering.append(state)
        state = state * chunk_decay[:, c, :, :, None, None] + states[:, c]
    prev_states = torch.stack(entering, dim=1)  # (B,nc,G,Hg,P,N)

    # 4. Inter-chunk (off-diagonal) contribution.
    state_decay_out = torch.exp(da_cs).permute(0, 1, 4, 2, 3)[..., None]  # (B,nc,L,G,Hg,1)
    y += torch.einsum("bclgn,bcgrpn->bclgrp", cc, prev_states) * state_decay_out

    y = y.reshape(b, s, h, p).to(x.dtype)
    if pad:
        y = y[:, :s_orig]
    return y, state.reshape(b, h, p, n)


def ssd_decode_step(
    x_t: torch.Tensor,   # (B, H, P)
    dt_t: torch.Tensor,  # (B, H)
    A: torch.Tensor,     # (H,)
    B_t: torch.Tensor,   # (B, G, N)
    C_t: torch.Tensor,   # (B, G, N)
    state: torch.Tensor,  # (B, H, P, N) float32
) -> tuple[torch.Tensor, torch.Tensor]:
    """Recurrent form: state' = exp(dt·A)·state + dt·x ⊗ B;  y = state'·C."""
    h = x_t.shape[1]
    hg = h // B_t.shape[1]
    dt_f = dt_t.float()
    da = torch.exp(dt_f * A)  # (B,H)
    bh = B_t.float().repeat_interleave(hg, dim=1)  # (B,H,N)
    ch = C_t.float().repeat_interleave(hg, dim=1)
    upd = (dt_f[..., None] * x_t.float())[..., None] * bh[:, :, None, :]  # (B,H,P,N)
    new_state = state * da[..., None, None] + upd
    y = torch.einsum("bhpn,bhn->bhp", new_state, ch)
    return y.to(x_t.dtype), new_state


# ---------------------------------------------------------------------------
# Causal depthwise conv1d (width d_conv, per-channel)
# ---------------------------------------------------------------------------


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x: (B, S, C); w: (W, C); b: (C,).  y[t] = Σ_i w[i]·x[t-W+1+i] + b."""
    width = w.shape[0]
    padded = F.pad(x, (0, 0, width - 1, 0))
    s = x.shape[1]
    y = padded[:, :s, :].float() * w[0].float()
    for i in range(1, width):  # W=4: four shifted multiply-adds
        y = y + padded[:, i : i + s, :].float() * w[i].float()
    return (y + b.float()).to(x.dtype)


def conv_decode_step(
    x_t: torch.Tensor, conv_state: torch.Tensor, w: torch.Tensor, b: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """x_t: (B, C); conv_state: (B, W-1, C) past inputs. Returns (y_t, state').

    The window takes the promoted type of the state and ``x_t``, as the
    reference's concatenation does: a float32 state (what prefill returns
    under mixed precision) stays float32.
    """
    dt = torch.promote_types(conv_state.dtype, x_t.dtype)
    window = torch.cat([conv_state.to(dt), x_t[:, None, :].to(dt)], dim=1)  # (B,W,C)
    return _conv_window(window, w, b, x_t.dtype), window[:, 1:, :]


def _conv_window(window, w, b, dtype):
    """The conv's output ``(B, C)`` of a full window ``(B, W, C)``."""
    y = torch.einsum("bwc,wc->bc", window.float(), w.float())
    return (y + b.float()).to(dtype)


def _conv_step_by_weight(x_t, conv_state, w, b):
    """:func:`conv_decode_step` on DTensors with the conv's weights left on
    their shards: the window is built in the cache state's layout (the new
    state goes back there as it is), then laid out as the weights' channels
    for the product, whose output keeps that layout."""
    from torch.distributed.tensor import Shard

    as_rows = lambda pls: [Shard(1) if isinstance(p, Shard) and p.dim == 2 else p for p in pls]
    x_t = x_t.redistribute(x_t.device_mesh, as_rows(conv_state.placements))
    dt = torch.promote_types(conv_state.dtype, x_t.dtype)
    window = torch.cat([conv_state.to(dt), x_t[:, None, :].to(dt)], dim=1)
    win_pl = weight_layout(window, w, 2, 1)
    y = shard_map(lambda win, w, b: _conv_window(win, w, b, x_t.dtype), (window, w, b),
                  (win_pl, list(w.placements), list(b.placements)), as_rows(win_pl))
    return y, window[:, 1:, :]


# ---------------------------------------------------------------------------
# Full Mamba2 mixer (in_proj -> conv -> SSD -> gated norm -> out_proj)
# ---------------------------------------------------------------------------


def init_mamba_params(gen: torch.Generator, d_model: int, ssm, dtype) -> dict:
    """``ssm`` is a configs.base.SSMSettings (or the port's MambaSettings);
    draws on ``gen``'s device."""
    d_inner = mamba_width(ssm, d_model)
    h = d_inner // ssm.head_dim
    conv_dim = d_inner + 2 * ssm.n_groups * ssm.d_state
    d_in_proj = 2 * d_inner + 2 * ssm.n_groups * ssm.d_state + h
    dev = gen.device
    in_proj = init_linear(gen, d_model, d_in_proj, dtype)
    conv_w = normal(gen, (ssm.d_conv, conv_dim)).mul_(0.2).to(dtype)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=dev),
        "dt_bias": torch.zeros((h,), dtype=torch.float32, device=dev),
        "A_log": torch.zeros((h,), dtype=torch.float32, device=dev),  # A = -exp(A_log) = -1
        "D": torch.ones((h,), dtype=torch.float32, device=dev),
        "norm_w": torch.ones((d_inner,), dtype=dtype, device=dev),
        "out_proj": init_linear(gen, d_inner, d_model, dtype),
    }


def _gated_norm(yz, w, ssm):
    """The gated RMSNorm of ``yz = y * silu(z)``: per group of channels for
    the port's ``MambaSettings``; over the whole width at 1e-6 for the
    reference's ``SSMSettings``, as the reference's mixer takes it whatever
    ``n_groups``."""
    if isinstance(ssm, MambaSettings):
        return rms_norm_grouped(yz, w, ssm.n_groups, ssm.norm_eps)
    return rms_norm(yz, w)


def _split_proj(z_xbc_dt, d_inner, gn2, h):
    z = z_xbc_dt[..., :d_inner]
    xbc = z_xbc_dt[..., d_inner : d_inner + d_inner + gn2]
    dt = z_xbc_dt[..., -h:]
    return z, xbc, dt


def _conv_by_channels(x, w, b):
    """:func:`causal_conv1d`; on DTensors each rank convolves its batch
    shard's channels (the conv mixes no channels; DTensor's pad has no
    strategy on PyTorch 2.11)."""
    if not is_dtensor(x):
        return causal_conv1d(x, w, b)
    x_pl = placements(x.shape, ("batch", None, "model"))
    return shard_map(causal_conv1d, (x, w, b), (x_pl, placements(w.shape, (None, "model")),
                                                placements(b.shape, ("model",))), x_pl)


def _by_heads(fn, xs, dt, A, bm, cm, state, head_dim: int):
    """``fn(xs, dt, A, bm, cm, state)``, an SSD over heads (``xs`` with its
    heads at ``head_dim``, ``dt`` likewise, ``A (H,)``, ``bm``/``cm`` with
    their groups at ``head_dim``, ``state (B, H, P, N)`` or None) returning
    ``(y like xs, state)``.  On DTensors each rank runs its batch shard and,
    where the heads divide the 'model' axis into whole groups or parts of
    one, its heads with their groups' B and C: the SSD mixes no heads."""
    if not is_dtensor(xs):
        return fn(xs, dt, A, bm, cm, state)
    h, g = xs.shape[head_dim], bm.shape[head_dim]
    hg = h // g
    prof = get_activation_sharding()
    ways = prof.axis_size(prof.logical.get("model", ()))
    h_l = h // ways
    split = ways > 1 and h % ways == 0 and (h_l % hg == 0 or hg % h_l == 0)
    heads = "model" if split else None

    def local(xs, dt, A, bm, cm, state):
        h0 = local_index("model", split) * xs.shape[head_dim]
        g0, ng = h0 // hg, max(1, xs.shape[head_dim] // hg)
        bm, cm = (t.narrow(head_dim, g0, ng) for t in (bm, cm))
        return fn(xs, dt, A, bm, cm, state)

    pl = lambda t, d: None if t is None else placements(t.shape, _at(d, t.dim(), heads))
    group_pl = placements(bm.shape, _at(head_dim, bm.dim(), None))
    y_pl, st_pl = pl(xs, head_dim), placements(
        (xs.shape[0], h, xs.shape[-1], bm.shape[-1]), _at(1, 4, heads))
    return shard_map(local, (xs, dt, A, bm, cm, state),
                     (y_pl, pl(dt, head_dim), pl(A, 0), group_pl, group_pl, pl(state, 1)),
                     (y_pl, st_pl))


def _at(dim: int, ndim: int, heads) -> tuple:
    """A logical spec: batch first, ``heads`` at ``dim`` (dim 0 of a 1-D
    tensor is its heads), nothing else split."""
    spec = [None] * ndim
    if ndim > 1:
        spec[0] = "batch"
    spec[dim] = heads
    return tuple(spec)


@spans.traced("repro_torch.mamba")
def mamba_mixer(
    params, x: torch.Tensor, ssm, *, chunk: Optional[int] = None,
    initial_state: Optional[torch.Tensor] = None, return_state: bool = False,
):
    """Prefill forward.  x: (B, S, D) -> (B, S, D).

    With ``return_state``, also returns (conv_state, ssm_state) for decode
    handoff: the last W-1 pre-conv inputs (zero-padded in front when S < W-1)
    and the float32 SSD state.

    On a mesh whose 'model' axis has more than one rank, ``in_proj``'s
    output width is split over 'model' in even shards whose edges are not
    the z / xBC / dt boundaries, and a slice of it would gather all of it.
    So there its output goes, by one all-to-all, to z, xBC and dt each over
    'model' on its own width (``spmd.split_parts``): xBC as the conv's
    weights and the cache's conv state lie, so neither moves; the conv's
    output goes, by one more, to x, B and C each on its own width.
    Elsewhere, one product and slices of it.
    """
    b, s, d = x.shape
    d_inner = mamba_width(ssm, d)
    h = d_inner // ssm.head_dim
    g, n = ssm.n_groups, ssm.d_state
    conv = lambda raw: F.silu(_conv_by_channels(raw, params["conv_w"], params["conv_b"])
                              .float()).to(x.dtype)
    if model_ways(x) > 1:  # z, xBC and dt each over 'model' on its own width
        # the weight gathered, as col_linear gathers it at any real length: moving the
        # rows would leave a wide weight's output split over 'data' as well
        z, xbc_raw, dt_raw = split_parts(linear(x, col(params["in_proj"])),
                                         (d_inner, d_inner + 2 * g * n, h))
        xs, bm, cm = split_parts(conv(xbc_raw), (d_inner, g * n, g * n))
    else:
        proj = col_linear(x, params["in_proj"], linear)  # float32 sums, rounded to x's type
        z, xbc_raw, dt_raw = _split_proj(proj, d_inner, 2 * g * n, h)
        xbc = conv(xbc_raw)
        xs, bm = xbc[..., :d_inner], xbc[..., d_inner : d_inner + g * n]
        cm = xbc[..., d_inner + g * n :]
    xs = xs.reshape(b, s, h, ssm.head_dim)
    bm = bm.reshape(b, s, g, n)
    cm = cm.reshape(b, s, g, n)
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    y, final_state = _by_heads(
        lambda xs, dt, A, bm, cm, st: ssd_chunked(xs, dt, A, bm, cm, chunk=chunk or ssm.chunk,
                                                  initial_state=st),
        xs, dt, A, bm, cm, initial_state, head_dim=2)
    y = y + (params["D"].reshape(h, 1) * xs.float()).to(y.dtype)
    y = y.reshape(b, s, d_inner)
    y = _gated_norm(y * F.silu(z.float()).to(y.dtype), params["norm_w"], ssm)
    out = row_linear(y, params["out_proj"], linear)
    if return_state:
        width = params["conv_w"].shape[0]
        tail = xbc_raw[:, -(width - 1) :, :]
        if s < width - 1:
            tail = F.pad(tail, (0, 0, width - 1 - s, 0))
        return out, (tail, final_state)
    return out


def mamba_decode_step(
    params, x_t: torch.Tensor, conv_state: torch.Tensor, ssm_state: torch.Tensor, ssm
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token recurrent step.  x_t: (B, D) -> (B, D), updated states.

    On a mesh, where the step's rows are fewer bytes to move than its
    output product's weight (:func:`~repro_torch.models.spmd.rows_move`,
    decode under the serve rules), every weight of the mixer stays on its
    shards: the products move the rows (``col_linear``, ``row_linear``);
    ``in_proj``'s output is laid out whole over its width, rows over the
    batch axes, so that z, x, B, C and dt are local slices; the conv's
    window, dt and x beside the per-head weights, and the gated norm's
    input are laid out as their weights are; the SSD runs on heads over
    'model'."""
    b, d = x_t.shape
    d_inner = mamba_width(ssm, d)
    h = d_inner // ssm.head_dim
    g, n = ssm.n_groups, ssm.d_state
    proj = col_linear(x_t, params["in_proj"], linear)
    stationary = rows_move(x_t, params["out_proj"], 0) is not None
    if stationary:
        proj = hint(proj, "batch", None)
    z, xbc, dt_raw = _split_proj(proj, d_inner, 2 * g * n, h)
    conv = _conv_step_by_weight if stationary else conv_decode_step
    xbc, conv_state = conv(xbc, conv_state, params["conv_w"], params["conv_b"])
    xbc = F.silu(xbc.float()).to(x_t.dtype)
    if stationary:
        xbc = hint(xbc, "batch", None)
    xs = xbc[..., :d_inner].reshape(b, h, ssm.head_dim)
    bm = xbc[..., d_inner : d_inner + g * n].reshape(b, g, n)
    cm = xbc[..., d_inner + g * n :].reshape(b, g, n)
    if stationary:
        dt_raw, xs = to_layout_of(dt_raw, params["dt_bias"], 1), to_layout_of(xs, params["D"], 1)
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    y, ssm_state = _by_heads(ssd_decode_step, xs, dt, A, bm, cm, ssm_state, head_dim=1)
    y = y + (params["D"].reshape(h, 1) * xs.float()).to(y.dtype)
    y = y.reshape(b, d_inner) * F.silu(z.float()).to(y.dtype)
    if stationary:
        y = to_layout_of(y, params["norm_w"], 1)
    out = row_linear(_gated_norm(y, params["norm_w"], ssm), params["out_proj"], linear)
    return out, conv_state, ssm_state
