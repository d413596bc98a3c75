"""Plain PyTorch oracles: the whole SpMV, softmax attention and the expert SwiGLU.

``flash_attention_ref`` and ``moe_mlp_ref`` are also the twins the kernel
wrappers run on CPU tensors, as are ``flash_attention_train_ref`` and
``flash_attention_backward_ref`` for the training kernels.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["flash_attention_backward_ref", "flash_attention_ref", "flash_attention_train_ref",
           "moe_mlp_ref", "spmv_coo_ref"]


def spmv_coo_ref(n_rows: int, rows, cols, vals, x) -> torch.Tensor:
    """y = A @ x for COO A, summed in COO order."""
    rows, cols = torch.as_tensor(rows).long(), torch.as_tensor(cols).long()
    vals = torch.as_tensor(vals)
    x = torch.as_tensor(x, device=vals.device)
    y = torch.zeros(n_rows, dtype=vals.dtype, device=vals.device)
    return y.index_add_(0, rows.to(vals.device), vals * x[cols.to(vals.device)])


def flash_attention_ref(q, k, v, causal: bool = True) -> torch.Tensor:
    """Naive softmax attention of ``q (B, H, S, Dh)`` over ``k, v (B, Hkv, T, Dh)``;
    the flash oracle.

    K and V are head-repeated here (q head h reads kv head h // (H // Hkv)).
    Scores in float32, a top-left causal mask ``i >= j``, ``p`` rounded to
    V's type before the float32 ``p v`` product, output in q's type.
    """
    g = q.shape[1] // k.shape[1]
    if g > 1:
        k, v = k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)
    s = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()) / math.sqrt(q.shape[-1])
    if causal:
        i = torch.arange(q.shape[2], device=q.device)[:, None]
        j = torch.arange(k.shape[2], device=q.device)[None, :]
        s = s.masked_fill(i < j, float("-inf"))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhst,bhtd->bhsd", p.float(), v.float()).to(q.dtype)


def _head_scores(q, k, b: int, h: int, g: int, causal: bool):
    """Scaled float32 scores ``(S, T)`` of q head ``h`` of row ``b`` (kv head
    ``h // g``) and the causal mask (True where a key is past the query), or
    None."""
    s = (q[b, h].float() @ k[b, h // g].float().T) / math.sqrt(q.shape[-1])
    if not causal:
        return s, None
    i = torch.arange(q.shape[2], device=q.device)[:, None]
    j = torch.arange(k.shape[2], device=q.device)[None, :]
    return s, i < j


def flash_attention_train_ref(q, k, v, causal: bool = True):
    """Twin of the training forward: ``(out, lse)``, ``out`` as
    :func:`flash_attention_ref` computes it (v may be narrower than q and k)
    and ``lse (B, H, S)`` each row's float32 log-sum-exp of its scaled
    scores.  One head at a time, so the ``(S, T)`` scores of one head are
    the largest temporary."""
    b_, h_, s_, _ = q.shape
    g = h_ // k.shape[1]
    out = q.new_empty((b_, h_, s_, v.shape[-1]))
    lse = torch.empty((b_, h_, s_), dtype=torch.float32, device=q.device)
    for b in range(b_):
        for h in range(h_):
            s, mask = _head_scores(q, k, b, h, g, causal)
            if mask is not None:
                s = s.masked_fill(mask, float("-inf"))
            lse[b, h] = torch.logsumexp(s, dim=-1)
            p = torch.softmax(s, dim=-1).to(v.dtype)
            out[b, h] = (p.float() @ v[b, h // g].float()).to(q.dtype)
    return out, lse


def flash_attention_backward_ref(q, k, v, out, lse, dout, causal: bool = True):
    """Twin of the training backward: ``(dq, dk, dv)`` from the forward's
    ``out`` and ``lse``, with the kernels' arithmetic: ``p = exp(s - lse)``
    and ``dP = dout v^T`` in float32, ``p`` rounded to v's type before
    ``p^T dout``, ``D = rowsum(dout * out)``, ``dS = scale p (dP - D)`` split
    into ``hi = dS`` in q's type and ``lo = dS - hi`` before its products,
    float32 sums; each in its input's type.  One head at a time."""
    b_, h_, _, dh = q.shape
    g = h_ // k.shape[1]
    scale = 1.0 / math.sqrt(dh)
    d = (dout.float() * out.float()).sum(dim=-1)
    dq = torch.empty_like(q)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    for b in range(b_):
        for h in range(h_):
            kv = h // g
            s, mask = _head_scores(q, k, b, h, g, causal)
            p = torch.exp(s - lse[b, h, :, None])
            if mask is not None:
                p = p.masked_fill(mask, 0.0)
            do = dout[b, h].float()
            dv[b, kv] += p.to(v.dtype).float().T @ do
            ds = scale * (p * (do @ v[b, kv].float().T - d[b, h, :, None]))
            hi = ds.to(q.dtype)
            lo = (ds - hi.float()).to(q.dtype)
            kf, qf = k[b, kv].float(), q[b, h].float()
            dq[b, h] = (hi.float() @ kf + lo.float() @ kf).to(q.dtype)
            dk[b, kv] += hi.float().T @ qf + lo.float().T @ qf
    return dq, dk.to(k.dtype), dv.to(v.dtype)


def moe_mlp_ref(x_packed, w_gate, w_up, w_down) -> torch.Tensor:
    """Per-expert SwiGLU over packed ``(E, C, D)`` slabs (batched products).

    Products accumulate in float32; ``h`` is rounded to the input type before
    the down product (a no-op for float32, what ``moe_ffn`` does for bf16).
    """
    xf = x_packed.float()
    gate = torch.bmm(xf, w_gate.float())
    up = torch.bmm(xf, w_up.float())
    h = (F.silu(gate) * up).to(x_packed.dtype)
    return torch.bmm(h.float(), w_down.float()).to(x_packed.dtype)
