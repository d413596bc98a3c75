"""``dot_f32``'s two paths on the CPU (``repro_torch.models.layers``).

Two bf16 operands take the bf16 product with float32 sums (on the CPU
through float32 copies, on a CUDA device on the tensor cores), whose
backward pass splits the float32 gradient into two bf16 terms.  Held here:
the forward pass against a float64 product of the same bf16 values, the
gradients against autograd through the upcast product, the split itself,
what the backward pass saves, the counters, and float32 and mixed operands
giving the float32 product's results bit for bit.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

from repro_torch.models.layers import _split_bf16, dot_f32, linear  # noqa: E402
from repro_torch.runtime import spans  # noqa: E402

BF16, F32 = torch.bfloat16, torch.float32

# (name, x shape, w shape): a 2-D weight over leading dims (the head's chunk,
# a dense MLP's gate), a plain 2-D product (the shared experts, the router),
# and the experts' (E, C, D) slabs under (E, D, F) weights.
SHAPES = [
    ("head", (2, 3, 48), (48, 40)),
    ("rows", (7, 64), (64, 24)),
    ("slab", (3, 5, 32), (3, 32, 16)),
]
BF16_CASES = [(n, xs, ws, BF16, BF16) for n, xs, ws in SHAPES]
F32_CASES = [(n + "-" + tag, xs, ws, dx, dw) for n, xs, ws in SHAPES
             for tag, dx, dw in (("f32", F32, F32), ("x_bf16", BF16, F32), ("w_bf16", F32, BF16))]
IDS = [c[0] for c in BF16_CASES + F32_CASES]


@pytest.fixture(autouse=True)
def _clean():
    spans.disable()
    spans.clear()
    yield
    spans.disable()
    spans.clear()


def _operands(xs, ws, x_dtype, w_dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(xs, generator=gen).to(x_dtype).requires_grad_()
    w = (torch.randn(ws, generator=gen) / ws[-2] ** 0.5).to(w_dtype).requires_grad_()
    g = torch.randn(*xs[:-1], ws[-1], generator=gen) * 1e-3
    return x, w, g


def _upcast_product(x, w):
    """The float32 product as ``dot_f32`` took it before the bf16 path."""
    if x.dtype == w.dtype == F32:
        return linear(x, w)
    return linear(x.float(), w.float())


def _grads(fn, x, w, g):
    x.grad = w.grad = None
    out = fn(x, w)
    out.backward(g)
    return out.detach(), x.grad, w.grad


def _bf16_ulp(v):
    """One bf16 ulp at each value of ``v`` (8 significant bits)."""
    exp = torch.frexp(v.double()).exponent
    return torch.ldexp(torch.ones_like(v, dtype=torch.float64), exp - 8)


@pytest.mark.parametrize("name,xs,ws,x_dtype,w_dtype", BF16_CASES, ids=[c[0] for c in BF16_CASES])
def test_bf16_forward_against_float64(name, xs, ws, x_dtype, w_dtype):
    """Float32 output within float32 summation error of the exact product of
    the same bf16 values: ``K * 2^-24 * sum |x w|``."""
    x, w, _ = _operands(xs, ws, x_dtype, w_dtype)
    out = dot_f32(x, w)
    assert out.dtype == F32 and out.shape == (*xs[:-1], ws[-1])
    exact = _upcast_product(x.detach().double(), w.detach().double())
    scale = _upcast_product(x.detach().double().abs(), w.detach().double().abs())
    k = xs[-1]
    assert bool(((out.double() - exact).abs() <= k * 2.0 ** -24 * scale).all())


@pytest.mark.parametrize("name,xs,ws,x_dtype,w_dtype", BF16_CASES, ids=[c[0] for c in BF16_CASES])
def test_bf16_gradients_against_upcast_product(name, xs, ws, x_dtype, w_dtype):
    """``dx`` and ``dw`` in bf16, each element within one bf16 ulp of
    autograd through the upcast float32 product (both are float32 sums
    rounded to bf16 once; the split gradient's ~2^-17 relative error can
    move a sum across a rounding boundary, by one ulp)."""
    x, w, g = _operands(xs, ws, x_dtype, w_dtype)
    out, dx, dw = _grads(dot_f32, x, w, g)
    want_out, want_dx, want_dw = _grads(_upcast_product, x, w, g)
    assert torch.equal(out, want_out)  # the CPU's product is the upcast one
    for got, want in ((dx, want_dx), (dw, want_dw)):
        assert got.dtype == want.dtype == BF16
        diff = (got.double() - want.double()).abs()
        assert bool((diff <= _bf16_ulp(want)).all())


@pytest.mark.parametrize("scale", [1e-30, 1e-3, 1.0, 1e20])
def test_split_reconstructs_float32(scale):
    """``g_hi + g_lo`` holds ``g`` to 2^-16 relative, over every magnitude."""
    g = torch.randn(4096, generator=torch.Generator().manual_seed(1)) * scale
    g = g * torch.logspace(-3, 3, 4096)
    hi, lo = _split_bf16(g)
    assert hi.dtype == lo.dtype == BF16
    assert torch.equal(hi, g.to(BF16))
    err = (g.double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0 ** -16 * g.double().abs()).all())


@pytest.mark.parametrize("name,xs,ws,x_dtype,w_dtype", BF16_CASES, ids=[c[0] for c in BF16_CASES])
def test_bf16_backward_saves_only_bf16(name, xs, ws, x_dtype, w_dtype):
    """The backward pass keeps the bf16 operands, not float32 copies."""
    x, w, _ = _operands(xs, ws, x_dtype, w_dtype)
    saved = []

    def pack(t):
        saved.append(t.dtype)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        dot_f32(x, w)
    assert saved and set(saved) == {BF16}


@pytest.mark.parametrize("name,xs,ws,x_dtype,w_dtype", BF16_CASES + F32_CASES, ids=IDS)
def test_each_product_counts_its_path(name, xs, ws, x_dtype, w_dtype):
    """One product adds one to ``dot_f32.tensor_core`` (two bf16 operands)
    or to ``dot_f32.float32`` (any float32 operand), in a step's forward
    pass; the backward pass counts nothing."""
    x, w, g = _operands(xs, ws, x_dtype, w_dtype)
    spans.enable()
    with spans.step("cpu"):
        dot_f32(x, w).backward(g)
    path = "tensor_core" if x_dtype == w_dtype == BF16 else "float32"
    assert spans.steps()[-1]["counters"] == {"dot_f32." + path: 1}


@pytest.mark.parametrize("name,xs,ws,x_dtype,w_dtype", F32_CASES, ids=[c[0] for c in F32_CASES])
def test_float32_and_mixed_operands_unchanged(name, xs, ws, x_dtype, w_dtype):
    """A float32 operand keeps the float32 product: output and gradients
    bit for bit those of the upcast product."""
    x, w, g = _operands(xs, ws, x_dtype, w_dtype)
    got = _grads(dot_f32, x, w, g)
    want = _grads(_upcast_product, x, w, g)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_only_the_needed_gradient():
    """A weight that needs no gradient (a frozen head) gets none, and ``dx``
    is the same as when both are differentiated."""
    _, xs, ws = SHAPES[0]
    x, w, g = _operands(xs, ws, BF16, BF16)
    _, dx_both, _ = _grads(dot_f32, x, w, g)
    w.requires_grad_(False)
    x.grad = w.grad = None
    dot_f32(x, w).backward(g)
    assert w.grad is None and torch.equal(x.grad, dx_both)
