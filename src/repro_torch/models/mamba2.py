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
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .layers import init_linear, rms_norm

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
    return diff.masked_fill_(above, float("-inf"))


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
        state = torch.zeros((b, g, hg, p, n), dtype=torch.float32, device=x.device)
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
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(width):  # W=4: four shifted multiply-adds
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
    y = torch.einsum("bwc,wc->bc", window.float(), w.float())
    y = (y + b.float()).to(x_t.dtype)
    return y, window[:, 1:, :]


# ---------------------------------------------------------------------------
# Full Mamba2 mixer (in_proj -> conv -> SSD -> gated norm -> out_proj)
# ---------------------------------------------------------------------------


def init_mamba_params(gen: torch.Generator, d_model: int, ssm, dtype) -> dict:
    """``ssm`` is a configs.base.SSMSettings; draws on ``gen``'s device."""
    d_inner = ssm.expand * d_model
    h = d_inner // ssm.head_dim
    conv_dim = d_inner + 2 * ssm.n_groups * ssm.d_state
    d_in_proj = 2 * d_inner + 2 * ssm.n_groups * ssm.d_state + h
    dev = gen.device
    in_proj = init_linear(gen, d_model, d_in_proj, dtype)
    conv_w = torch.randn((ssm.d_conv, conv_dim), generator=gen, device=dev,
                         dtype=torch.float32).mul_(0.2).to(dtype)
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


def _split_proj(z_xbc_dt, d_inner, gn2, h):
    z = z_xbc_dt[..., :d_inner]
    xbc = z_xbc_dt[..., d_inner : d_inner + d_inner + gn2]
    dt = z_xbc_dt[..., -h:]
    return z, xbc, dt


def mamba_mixer(
    params, x: torch.Tensor, ssm, *, chunk: Optional[int] = None,
    initial_state: Optional[torch.Tensor] = None, return_state: bool = False,
):
    """Prefill forward.  x: (B, S, D) -> (B, S, D).

    With ``return_state``, also returns (conv_state, ssm_state) for decode
    handoff: the last W-1 pre-conv inputs (zero-padded in front when S < W-1)
    and the float32 SSD state.
    """
    b, s, d = x.shape
    d_inner = ssm.expand * d
    h = d_inner // ssm.head_dim
    g, n = ssm.n_groups, ssm.d_state
    proj = x @ params["in_proj"]  # float32 sums, rounded to x's type
    z, xbc_raw, dt_raw = _split_proj(proj, d_inner, 2 * g * n, h)
    xbc = causal_conv1d(xbc_raw, params["conv_w"], params["conv_b"])
    xbc = F.silu(xbc.float()).to(x.dtype)
    xs = xbc[..., :d_inner].reshape(b, s, h, ssm.head_dim)
    bm = xbc[..., d_inner : d_inner + g * n].reshape(b, s, g, n)
    cm = xbc[..., d_inner + g * n :].reshape(b, s, g, n)
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    y, final_state = ssd_chunked(
        xs, dt, A, bm, cm, chunk=chunk or ssm.chunk, initial_state=initial_state
    )
    y = y + (params["D"].reshape(h, 1) * xs.float()).to(y.dtype)
    y = y.reshape(b, s, d_inner)
    y = rms_norm(y * F.silu(z.float()).to(y.dtype), params["norm_w"])
    out = y @ params["out_proj"]
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
    """One-token recurrent step.  x_t: (B, D) -> (B, D), updated states."""
    b, d = x_t.shape
    d_inner = ssm.expand * d
    h = d_inner // ssm.head_dim
    g, n = ssm.n_groups, ssm.d_state
    proj = x_t @ params["in_proj"]
    z, xbc, dt_raw = _split_proj(proj, d_inner, 2 * g * n, h)
    xbc, conv_state = conv_decode_step(xbc, conv_state, params["conv_w"], params["conv_b"])
    xbc = F.silu(xbc.float()).to(x_t.dtype)
    xs = xbc[..., :d_inner].reshape(b, h, ssm.head_dim)
    bm = xbc[..., d_inner : d_inner + g * n].reshape(b, g, n)
    cm = xbc[..., d_inner + g * n :].reshape(b, g, n)
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    y, ssm_state = ssd_decode_step(xs, dt, A, bm, cm, ssm_state)
    y = y + (params["D"].reshape(h, 1) * xs.float()).to(y.dtype)
    y = y.reshape(b, d_inner)
    y = rms_norm(y * F.silu(z.float()).to(y.dtype), params["norm_w"])
    out = y @ params["out_proj"]
    return out, conv_state, ssm_state
