"""Shared neural-net primitives of the serving and training paths (port of
``repro.models.layers``).

Conventions as in the reference: activations ``(B, S, D)``; attention in the
flat-head layout ``(B, H, S, Dh)`` (K/V ``(B, Hkv, S, Dh)``, not repeated:
the prefill kernel reads kv head ``h // (H // Hkv)`` for q head ``h``), and
the cache in its native ``(B, T, Hkv, Dh)`` layout for decode; norms, RoPE
and softmax in float32 whatever the activation type; weights in
``(d_in, d_out)`` layout (``x @ w``).  Prefill attention goes through
:func:`repro_torch.kernels.flash_attention`; training's
:func:`chunked_attention` through the flash training kernels on a card, and
through the reference's chunked loop elsewhere.
"""
from __future__ import annotations

import itertools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels.flash_attention import flash_attention_backward, flash_attention_train
from ..runtime import spans
from .spmd import col_linear, is_dtensor, row_linear

__all__ = [
    "apply_mrope",
    "apply_rope",
    "chunked_attention",
    "decode_attention",
    "dot_f32",
    "generator",
    "init_embedding",
    "init_linear",
    "init_rms_norm",
    "linear",
    "make_rope_cache",
    "normal",
    "relu2_mlp",
    "rms_norm",
    "rms_norm_grouped",
    "swiglu",
]


# ---------------------------------------------------------------------------
# Init helpers (float32 normal draws from a torch.Generator, then cast)
# ---------------------------------------------------------------------------


class _MetaGenerator:
    """Stands in for a generator on the meta device, which has none: the
    initialisers then draw nothing and return storage-less tensors."""

    device = torch.device("meta")


def generator(seed: int, device):
    """A ``torch.Generator`` on ``device`` seeded with ``seed`` (a stand-in
    that draws nothing on the meta device)."""
    dev = torch.device(device)
    if dev.type == "meta":
        return _MetaGenerator()
    return torch.Generator(device=dev).manual_seed(seed)


def normal(gen, shape) -> torch.Tensor:
    """Float32 standard-normal draws of ``shape`` from ``gen`` on its device."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)


def init_linear(gen: torch.Generator, d_in: int, d_out: int, dtype) -> torch.Tensor:
    w = normal(gen, (d_in, d_out))
    return w.mul_(1.0 / math.sqrt(d_in)).to(dtype)


def init_rms_norm(d: int, dtype, device) -> torch.Tensor:
    return torch.ones((d,), dtype=dtype, device=device)


def init_embedding(gen: torch.Generator, vocab: int, d: int, dtype) -> torch.Tensor:
    return normal(gen, (vocab, d)).mul_(0.02).to(dtype)


# ---------------------------------------------------------------------------
# Products, norms and rotary embeddings
# ---------------------------------------------------------------------------


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w``; with a 2-D ``w``, one 2-D product over ``x``'s flattened
    leading dims.  ``matmul`` does the same when ``x``'s strides chain, and
    else a batched product, which rounds differently; a DTensor's size-1
    dims can carry strides that do not chain where the plain tensor's do,
    so the sharded path would round otherwise than the unsharded one."""
    if w.dim() != 2 or x.dim() <= 2:
        return x @ w
    return (x.reshape(-1, x.shape[-1]) @ w).reshape(*x.shape[:-1], w.shape[-1])


@spans.traced("repro_torch.dot_f32")
def dot_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` accumulated and returned in float32 (the reference's
    ``preferred_element_type=float32`` product), under the span
    ``repro_torch.dot_f32``.

    Two bf16 plain tensors, ``x (..., K)`` under a ``(K, N)`` weight or
    ``(E, M, K)`` slabs under ``(E, K, N)`` weights, take :class:`_DotF32`:
    on a CUDA device the bf16 operands go to the tensor cores with float32
    sums and output (``torch.mm``/``torch.bmm`` with ``out_dtype``), which
    computes the upcast product's sums, since a product of two bf16 values
    is exact in float32; elsewhere the upcast product itself.  Only the
    bf16 operands are saved for the backward pass.  A float32 operand takes
    the float32 product (the reference promotes it), and so do DTensors,
    whose ops have no sharding rule for the ``out_dtype`` products.  Each
    product counts one ``dot_f32.tensor_core`` or ``dot_f32.float32``."""
    if _bf16_pair(x, w):
        spans.count("dot_f32.tensor_core", 1)
        return _DotF32.apply(x, w)
    spans.count("dot_f32.float32", 1)
    if x.dtype == w.dtype == torch.float32:
        return linear(x, w)
    return linear(x.float(), w.float())


def _bf16_pair(x, w) -> bool:
    if not (x.dtype == w.dtype == torch.bfloat16) or is_dtensor(x) or is_dtensor(w):
        return False
    return (w.dim() == 2 and x.dim() >= 2) or (w.dim() == x.dim() == 3)


def _mm_f32(a: torch.Tensor, b: torch.Tensor, acc=None) -> torch.Tensor:
    """``a @ b`` (2-D, or batched 3-D) of bf16 operands with float32 sums
    and output, added in place to the float32 ``acc`` when given: on the
    tensor cores on a CUDA device, else through float32 copies."""
    if a.device.type == "cuda":
        if acc is None:
            return (torch.mm if a.dim() == 2 else torch.bmm)(a, b, out_dtype=torch.float32)
        add = torch.addmm if a.dim() == 2 else torch.baddbmm
        return add(acc, a, b, out_dtype=torch.float32, out=acc)
    p = a.float() @ b.float()
    return p if acc is None else acc.add_(p)


def _split_bf16(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """A float32 ``g`` as two bf16 terms, ``g_hi = bf16(g)`` and ``g_lo =
    bf16(g - g_hi)``: their sum holds ~16 of ``g``'s 24 bits."""
    hi = g.to(torch.bfloat16)
    lo = torch.empty_like(hi)
    torch.sub(g, hi, out=lo)  # the difference is exact in float32, rounded once on write
    return hi, lo


class _DotF32(torch.autograd.Function):
    """:func:`dot_f32` of two bf16 operands (see there).

    The backward pass splits the incoming float32 gradient in two bf16 terms
    (:func:`_split_bf16`), so that its products run on the tensor cores too,
    each as two products summed in float32.  One bf16 term would round the
    gradient to 8 bits, below the float32 product of the reference; two
    keep ~16, and ``dx`` and ``dw`` are rounded to bf16 (8 bits) as the
    upcast product's are."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        if w.dim() == 2:
            return _mm_f32(x.reshape(-1, x.shape[-1]), w).reshape(*x.shape[:-1], w.shape[-1])
        return _mm_f32(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        shape = x.shape
        if w.dim() == 2:  # the forward pass's flattened rows
            x, g = x.reshape(-1, shape[-1]), g.reshape(-1, w.shape[-1])
        hi, lo = _split_bf16(g)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            wt = w.transpose(-1, -2)
            dx = _mm_f32(lo, wt, _mm_f32(hi, wt)).to(x.dtype).reshape(shape)
        if ctx.needs_input_grad[1]:
            xt = x.transpose(-1, -2)
            dw = _mm_f32(xt, lo, _mm_f32(xt, hi)).to(w.dtype)
        return dx, dw


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def rms_norm_grouped(x: torch.Tensor, w: torch.Tensor, groups: int,
                     eps: float = 1e-6) -> torch.Tensor:
    """:func:`rms_norm` taken over each of ``groups`` equal runs of the last
    dim apart (Mamba2's grouped gated norm), then times ``w``."""
    xf = x.float()
    xg = xf.reshape(*x.shape[:-1], groups, x.shape[-1] // groups)
    var = (xg * xg).mean(dim=-1, keepdim=True)
    return ((xg * torch.rsqrt(var + eps)).reshape(x.shape) * w.float()).to(x.dtype)


def make_rope_cache(positions: torch.Tensor, d_head: int, theta: float):
    """cos/sin tables ``(..., S, d_head // 2)`` for positions ``(..., S)``.

    θ is copied to the device from the host's memory, which waits for the
    device to finish the work queued before it (the span
    ``repro_torch.sync.rope_theta``)."""
    half = d_head // 2
    exponent = -torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    with spans.sync("rope_theta"):
        base = torch.tensor(theta, dtype=torch.float32, device=positions.device)
    freqs = torch.pow(base, exponent)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate pairs (x[..., :half], x[..., half:]) by cos/sin (rotate-half)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: ``(B, H, S, Dh)``; positions: ``(B, S)``."""
    cos, sin = make_rope_cache(positions, x.shape[-1], theta)  # (B, S, half)
    shape = (cos.shape[0],) + (1,) * (x.dim() - 3) + tuple(cos.shape[1:])
    return _rotate(x, cos.reshape(shape), sin.reshape(shape))


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, sections, theta: float) -> torch.Tensor:
    """Multimodal RoPE (qwen2-vl §2): three position streams (t, h, w).

    x: ``(B, ..., S, Dh)``; positions3: ``(3, B, S)``.  ``sections`` gives how
    many of the ``Dh // 2`` frequency pairs take their position from each
    stream, in order (``sum(sections) == Dh // 2``).
    """
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to {half}")
    cos3, sin3 = make_rope_cache(positions3, x.shape[-1], theta)  # (3, B, S, half)
    # Pair i's angle from the stream whose section holds it: each stream's
    # slice of its own table, side by side -> (B, S, half).  Slices, not an
    # index tensor, so no host-to-device copy per call.
    ends = list(itertools.accumulate(sections))
    spans = list(zip([0] + ends[:-1], ends))
    cos = torch.cat([cos3[i, ..., lo:hi] for i, (lo, hi) in enumerate(spans)], dim=-1)
    sin = torch.cat([sin3[i, ..., lo:hi] for i, (lo, hi) in enumerate(spans)], dim=-1)
    shape = (cos.shape[0],) + (1,) * (x.dim() - 3) + tuple(cos.shape[1:])
    return _rotate(x, cos.reshape(shape), sin.reshape(shape))


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------


def swiglu(x, w_gate, w_up, w_down) -> torch.Tensor:
    """SwiGLU feed-forward: gate and up with float32 sums and output
    (:func:`dot_f32`: bf16 operands on the tensor cores of a CUDA device,
    float32 operands on its CUDA cores), ``h`` and the down product in the
    activation type.  Leading axes batch, so the training path runs every
    expert at once over ``(E, C, D)`` slabs and ``(E, D, F)`` weights, one
    batched product each.  On a mesh the products are :func:`~repro_torch.models.spmd.col_linear`
    and ``row_linear``: where the weights stay on their shards, ``h`` keeps
    their F split and the down product's partial sums are reduced."""
    gate, up = col_linear(x, (w_gate, w_up), dot_f32)
    return row_linear((F.silu(gate) * up).to(x.dtype), w_down, linear)


def relu2_mlp(x, w_up, w_down) -> torch.Tensor:
    """Nemotron-H's non-gated squared-ReLU feed-forward ``down(relu(up(x))^2)``:
    up with float32 sums and output (:func:`dot_f32`), the square in float32
    and ``h`` and the down product in the activation type, as :func:`swiglu`
    takes them; leading axes batch alike."""
    up = col_linear(x, w_up, dot_f32)
    return row_linear(torch.relu(up).square().to(x.dtype), w_down, linear)


# ---------------------------------------------------------------------------
# Attention helpers
# ---------------------------------------------------------------------------


def _kv_step(qf, kb, vb, m_prev, l_prev, acc, k0: int, t: int, causal: bool, pad: bool):
    """One KV chunk of :func:`chunked_attention`: the running max ``m``, sum
    ``l`` and accumulator ``acc`` after keys ``k0 .. k0 + kc``.  ``qf`` is
    ``(B, Hkv, G, S, Dh)`` float32, ``kb`` ``(B, Hkv, kc, Dh)``, ``vb``
    ``(B, Hkv, kc, Dv)``."""
    s_len, kc = qf.shape[3], kb.shape[2]
    sblk = (qf @ kb.float().unsqueeze(2).transpose(-1, -2)) * (1.0 / math.sqrt(qf.shape[-1]))
    kpos = k0 + torch.arange(kc, device=qf.device)
    if causal or pad:
        mask = (kpos < t).expand(s_len, kc)
        if causal:
            mask = mask & (torch.arange(s_len, device=qf.device)[:, None] >= kpos[None, :])
        sblk = sblk.masked_fill(~mask, float("-inf"))
    m_new = torch.maximum(m_prev, sblk.amax(dim=-1))
    safe_m = torch.where(torch.isfinite(m_new), m_new, 0.0)
    p = torch.exp(sblk - safe_m[..., None])
    p = torch.where(torch.isfinite(sblk), p, 0.0)
    alpha = torch.where(torch.isfinite(m_prev), torch.exp(m_prev - safe_m), 0.0)
    l_new = l_prev * alpha + p.sum(dim=-1)
    pv = p.to(vb.dtype).float() @ vb.float().unsqueeze(2)
    return m_new, l_new, acc * alpha[..., None] + pv


@spans.traced("repro_torch.attention")
def chunked_attention(q, k, v, *, causal: bool = True, kv_chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention over KV chunks; never builds the (S, T) scores.

    q: ``(B, H, S, Dh)``; k: ``(B, Hkv, T, Dh)``, v: ``(B, Hkv, T, Dv)`` with
    ``Hkv | H`` (q head h reads kv head ``h // (H // Hkv)``; ``Hkv = H`` is
    the reference's head-repeated input); the scores are scaled by
    ``Dh ** -0.5``, and ``Dv`` may differ from ``Dh`` (latent attention's
    value heads are narrower).  Returns ``(B, H, S, Dv)`` in q's type.  The
    reference's arithmetic: scores, ``m``, ``l`` and ``acc`` in float32, ``p``
    rounded to V's type before the ``p v`` product, ``l`` clamped at 1e-20;
    a ragged T is padded and masked; causality by absolute offsets
    (``qpos >= kpos``), so cross-attention (``causal=False``) shares it.
    Each KV step runs under ``torch.utils.checkpoint`` (the reference's
    ``jax.checkpoint``): its ``(B, H, S, kc)`` probabilities are recomputed
    in the backward pass, not kept for every step.  Runs under the span
    ``repro_torch.attention``.

    Plain bf16 tensors on a CUDA device take :class:`_FlashAttention`
    instead, the same arithmetic on the tensor cores: the flash training
    forward and backward kernels, q, k and v made contiguous, ``kv_chunk``
    unused; widths the kernels do not take raise there.  CPU and meta
    tensors, float32 and float64 inputs and DTensors run the chunked loop
    above.  Each forward call counts one ``attention.fused`` or
    ``attention.chunked``.
    """
    if _fused(q, k, v):
        spans.count("attention.fused", 1)
        return _FlashAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(), causal)
    spans.count("attention.chunked", 1)
    return _chunked_attention(q, k, v, causal, kv_chunk)


def _fused(q, k, v) -> bool:
    """Whether :func:`chunked_attention` takes the flash training kernels:
    plain (not DTensor) bf16 tensors on a CUDA device."""
    return not any(is_dtensor(t) for t in (q, k, v)) and all(_card_bf16(t) for t in (q, k, v))


def _card_bf16(t) -> bool:
    return t.device.type == "cuda" and t.dtype == torch.bfloat16


class _FlashAttention(torch.autograd.Function):
    """:func:`chunked_attention` of contiguous bf16 q, k and v through
    :func:`~repro_torch.kernels.flash_attention_train` and
    :func:`~repro_torch.kernels.flash_attention_backward`.  Saves q, k, v,
    the output and the rows' log-sum-exp; the backward pass recomputes the
    probabilities from them, so no per-chunk checkpoint is kept."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = flash_attention_train(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, lse, g.contiguous(), ctx.causal)
        return dq, dk, dv, None


def _chunked_attention(q, k, v, causal: bool, kv_chunk: int) -> torch.Tensor:
    b, h, s, dh = q.shape
    hkv, t = k.shape[1], k.shape[2]
    kv_chunk = min(kv_chunk, t)
    pad = (-t) % kv_chunk
    if pad:
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
    qf = q.float().reshape(b, hkv, h // hkv, s, dh)
    m = torch.full(qf.shape[:-1], float("-inf"), device=q.device)
    l = torch.zeros(qf.shape[:-1], device=q.device)
    acc = torch.zeros((*qf.shape[:-1], v.shape[-1]), device=q.device)
    for k0 in range(0, t + pad, kv_chunk):
        m, l, acc = checkpoint(_kv_step, qf, k[:, :, k0:k0 + kv_chunk], v[:, :, k0:k0 + kv_chunk],
                               m, l, acc, k0, t, causal, bool(pad), use_reentrant=False)
    out = acc / l.clamp(min=1e-20)[..., None]
    return out.reshape(b, h, s, v.shape[-1]).to(q.dtype)


def decode_attention(q, k_cache, v_cache, pos) -> torch.Tensor:
    """One-token attention over the cache in its native layout.

    q: ``(B, H, 1, Dh)``; caches ``(B, T, Hkv, Dh)``; keys ``t < pos`` are
    valid (``pos`` an int or a ``(B,)`` tensor).  Scores and the ``p v``
    product in float32, ``p`` rounded to the cache's type first; no head
    repeat (q head h reads kv head h // G).  No kernel: the reference has none.
    """
    b, t, hkv = k_cache.shape[:3]
    h, dh = q.shape[1], q.shape[-1]
    g = h // hkv
    qg = q[:, :, 0, :].reshape(b, hkv, g, dh).float()
    s = torch.einsum("bhgd,bthd->bhgt", qg, k_cache.float()) / math.sqrt(dh)
    tpos = torch.arange(t, device=q.device)
    if isinstance(pos, torch.Tensor) and pos.dim() == 1:
        valid = tpos[None, :] < pos[:, None].to(q.device)  # (B, T)
        s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    else:
        s = s.masked_fill(tpos >= int(pos), float("-inf"))
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bhgt,bthd->bhgd", p.float(), v_cache.float())
    return out.reshape(b, h, 1, dh).to(q.dtype)
