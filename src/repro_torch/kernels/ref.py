"""Plain PyTorch oracles: the whole SpMV, softmax attention and the expert SwiGLU.

``flash_attention_ref`` and ``moe_mlp_ref`` are also the twins the kernel
wrappers run on CPU tensors.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["flash_attention_ref", "moe_mlp_ref", "spmv_coo_ref"]


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
