"""Plain float32 pieces shared by the references, and the control's lower precision.

Every product here is a float32 ``matmul`` with TF32 off (:func:`strict`);
no kernel, cache or batching of the program is used.  ``Prec`` says in
which precision the products that the configuration states in bf16 run:
float32 for the reference, or float8 for the control (e4m3 operands, e5m2
gradients, one scale a tensor), the next precision below bf16.
"""
from __future__ import annotations

import dataclasses

import torch

F8_FORMATS = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}  # largest finite


def strict() -> None:
    """Float32 products in float32: no TF32 in matmul or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _f8(x: torch.Tensor, fmt: torch.dtype = torch.float8_e4m3fn) -> tuple:
    """``x`` in float8 ``fmt`` under one scale (its largest magnitude to the
    format's largest): ``(float8 values, scale)``."""
    scale = x.abs().amax().clamp(min=1e-30) / F8_FORMATS[fmt]
    return (x / scale).to(fmt), scale


def _up(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def to_f8(x: torch.Tensor, fmt: torch.dtype = torch.float8_e4m3fn) -> torch.Tensor:
    """``x`` rounded to float8 ``fmt`` under one scale, back in float32."""
    return _up(*_f8(x, fmt))


class F8Product(torch.autograd.Function):
    """``a @ b`` in float8, forward and backward, as float8 training runs
    it: both operands in e4m3, and in the backward pass the incoming
    gradient in e5m2, multiplied by the saved e4m3 operands; every sum in
    float32, one scale a tensor.  The operands are saved in float8."""

    @staticmethod
    def forward(ctx, a, b):
        (a8, a_scale), (b8, b_scale) = _f8(a), _f8(b)
        ctx.save_for_backward(a8, a_scale, b8, b_scale)
        ctx.shapes = a.shape, b.shape
        return _up(a8, a_scale) @ _up(b8, b_scale)

    @staticmethod
    def backward(ctx, g):
        a8, a_scale, b8, b_scale = ctx.saved_tensors
        qa, qb = _up(a8, a_scale), _up(b8, b_scale)
        qg = to_f8(g, torch.float8_e5m2)
        sa, sb = ctx.shapes
        return ((qg @ qb.transpose(-1, -2)).sum_to_size(sa),
                (qa.transpose(-1, -2) @ qg).sum_to_size(sb))


@dataclasses.dataclass(frozen=True)
class Prec:
    """The precision of the products stated in bf16: ``lowp`` runs them in
    float8 (:class:`F8Product`, the control)."""

    lowp: bool = False

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return F8Product.apply(x, w) if self.lowp else x @ w


REF = Prec()


def top_layout(m) -> list[tuple[tuple, tuple, str]]:
    """The embedding, final norm and (untied) head: ``(path, shape, kind)``."""
    out = [(("embed",), (m.rows, m.d), "embed"), (("final_norm",), (m.d,), "norm")]
    if not m.tied:
        out.append((("lm_head",), (m.d, m.rows), "linear"))
    return out


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)
