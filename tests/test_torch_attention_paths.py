"""Which path ``chunked_attention`` takes, and the fused path's autograd function, on the CPU.

Plain bf16 tensors on a CUDA device take the flash training kernels
(``_FlashAttention``); everything else takes the chunked loop with its bits
unchanged.  The CPU has no card, so the tests that reach the fused path
stand the device check (``layers._card_bf16``) in with one that accepts CPU
tensors: the wrappers then run their twins, and the widths the kernels do
not take raise exactly as on a card.  The card's own tests are in
``test_torch_gpu.py``.
"""
import math

import pytest
import torch

from repro_torch.kernels import launch_counts
from repro_torch.kernels.ref import flash_attention_backward_ref, flash_attention_train_ref
from repro_torch.models import layers
from repro_torch.runtime import spans


@pytest.fixture(autouse=True)
def _spans_off():
    spans.clear()
    yield
    spans.disable()
    spans.clear()


def _qkv(b, h, hkv, s, t, dh, dv, dtype, seed=0, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=g).to(dtype).to(device)
               for shape in ((b, h, s, dh), (b, hkv, t, dh), (b, hkv, t, dv)))
    return q, k, v


def _counted(fn):
    """``fn()`` inside a traced step on the CPU, and the step's counters."""
    spans.enable()
    with spans.step("cpu"):
        out = fn()
    (st,) = spans.steps()
    return out, st["counters"]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float64],
                         ids=["bf16", "f32", "f64"])
@pytest.mark.parametrize("causal", [True, False])
def test_cpu_inputs_keep_the_chunked_bits(dtype, causal):
    """CPU tensors of every type run the chunked loop: the output and the
    gradients are ``_chunked_attention``'s bit for bit, and each call counts
    one ``attention.chunked``."""
    q, k, v = _qkv(1, 4, 2, 40, 37, 32, 16, dtype)
    do = torch.randn(1, 4, 40, 16, generator=torch.Generator().manual_seed(9)).to(dtype)

    def run(fn):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = fn(*leaves)
        out.backward(do)
        return out.detach(), [x.grad for x in leaves]

    (got, grads), counters = _counted(
        lambda: run(lambda a, b, c: layers.chunked_attention(a, b, c, causal=causal, kv_chunk=16)))
    want, want_grads = run(lambda a, b, c: layers._chunked_attention(a, b, c, causal, 16))
    assert torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(grads, want_grads))
    assert counters == {"attention.chunked": 1}


def test_meta_inputs_take_the_chunked_loop():
    """The dry-run's meta tensors keep the chunked loop: a meta output of the
    value heads' width, counted as ``attention.chunked``."""
    q, k, v = (torch.empty(shape, dtype=torch.bfloat16, device="meta")
               for shape in ((2, 8, 64, 192), (2, 8, 64, 192), (2, 8, 64, 128)))
    out, counters = _counted(lambda: layers.chunked_attention(q, k, v, causal=True, kv_chunk=32))
    assert out.is_meta and tuple(out.shape) == (2, 8, 64, 128)
    assert counters == {"attention.chunked": 1}


def test_dtensor_inputs_take_the_chunked_loop(monkeypatch, tmp_path):
    """DTensors never reach the kernels, even where the device check would
    pass: they go to the chunked loop as they are (a one-rank gloo group)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DeviceMesh, Replicate, distribute_tensor

    owned = not dist.is_initialized()
    if owned:
        dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                                rank=0, world_size=1)
    try:
        mesh = DeviceMesh("cpu", list(range(dist.get_world_size())))
        q, k, v = (distribute_tensor(x, mesh, [Replicate()])
                   for x in _qkv(1, 4, 2, 16, 16, 32, 32, torch.bfloat16))
        monkeypatch.setattr(layers, "_card_bf16", lambda t: True)
        seen = []

        def chunked(*args):
            seen.append(args)
            return args[0]

        monkeypatch.setattr(layers, "_chunked_attention", chunked)
        assert not layers._fused(q, k, v)
        _, counters = _counted(lambda: layers.chunked_attention(q, k, v, causal=True))
        assert len(seen) == 1 and all(layers.is_dtensor(x) for x in seen[0][:3])
        assert counters == {"attention.chunked": 1}
    finally:
        if owned:
            dist.destroy_process_group()


@pytest.mark.parametrize("dh,dv", [(24, 24), (64, 80), (272, 272), (64, 24), (128, 0)],
                         ids=["dh-not-16", "dv-above-dh", "dh-above-256", "dv-not-16", "dv-0"])
def test_card_widths_the_kernels_do_not_take_raise(monkeypatch, dh, dv):
    """On a card, bf16 inputs whose widths the kernels do not take raise;
    nothing falls back to the chunked loop."""
    monkeypatch.setattr(layers, "_card_bf16", lambda t: True)

    def chunked(*args):
        raise AssertionError("fell back to the chunked loop")

    monkeypatch.setattr(layers, "_chunked_attention", chunked)
    q, k, v = _qkv(1, 2, 2, 8, 8, dh, dv, torch.bfloat16)
    with pytest.raises(ValueError, match="head sizes"):
        layers.chunked_attention(q, k, v, causal=True)


# Shapes of every kind the port trains, scaled down: (B, H, Hkv, S, T, Dh, Dv, causal).
FUSED_CASES = {
    "gqa-32-4-dh128": (1, 32, 4, 48, 48, 128, 128, True),
    "mla-192-128": (1, 4, 4, 40, 40, 192, 128, True),
    "dh64-cross": (2, 4, 4, 24, 56, 64, 64, False),
    "ragged": (1, 4, 2, 37, 37, 32, 32, True),
}


@pytest.mark.parametrize("case", list(FUSED_CASES), ids=list(FUSED_CASES))
def test_fused_function_against_float64_chunked(monkeypatch, case):
    """The fused path's autograd function, through the kernels' twins: the
    output and dq, dk, dv against the chunked loop's autograd in float64 on
    the same bf16 inputs, each within 1.5e-2 of the reference's largest
    magnitude (p, the output and each gradient are rounded to bf16, 2^-8
    relative each, where the float64 loop rounds nothing); one
    ``attention.fused`` a call, and no kernel launched on the CPU."""
    b, h, hkv, s, t, dh, dv, causal = FUSED_CASES[case]
    monkeypatch.setattr(layers, "_card_bf16", lambda t_: True)
    q, k, v = _qkv(b, h, hkv, s, t, dh, dv, torch.bfloat16, seed=1)
    do = torch.randn(b, h, s, dv, generator=torch.Generator().manual_seed(2)).bfloat16()
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = launch_counts()
    out, counters = _counted(lambda: layers.chunked_attention(*leaves, causal=causal, kv_chunk=16))
    out.backward(do)
    assert launch_counts() == before
    assert counters == {"attention.fused": 1}
    assert out.dtype == torch.bfloat16 and all(x.grad.dtype == torch.bfloat16 for x in leaves)
    ref = [x.double().requires_grad_() for x in (q, k, v)]
    want = layers._chunked_attention(*ref, causal, 16)
    want.backward(do.double())
    for name, a, r in (("out", out, want), *zip(("dq", "dk", "dv"), (x.grad for x in leaves),
                                                (x.grad for x in ref))):
        r = r.detach()
        err = (a.double() - r).abs().max().item()
        assert err <= 1.5e-2 * r.abs().max().item(), (name, err)


def test_fused_function_saves_no_float32_copy(monkeypatch):
    """The autograd function keeps q, k, v, the bf16 output and the float32
    rows' log-sum-exp for the backward pass, nothing per chunk."""
    monkeypatch.setattr(layers, "_card_bf16", lambda t: True)
    q, k, v = (x.requires_grad_() for x in _qkv(1, 4, 2, 64, 64, 32, 32, torch.bfloat16))
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda x: saved.append(x) or x, lambda x: x):
        layers.chunked_attention(q, k, v, causal=True, kv_chunk=16)
    assert [(x.dtype, tuple(x.shape)) for x in saved] == [
        (torch.bfloat16, (1, 4, 64, 32)), (torch.bfloat16, (1, 2, 64, 32)),
        (torch.bfloat16, (1, 2, 64, 32)), (torch.bfloat16, (1, 4, 64, 32)),
        (torch.float32, (1, 4, 64))]


@pytest.mark.parametrize("causal", [True, False])
def test_train_twin_log_sum_exp(causal):
    """The training forward's twin: softmax attention and each row's
    log-sum-exp of its scaled scores, within float32's rounding (the twin's
    scores are float32)."""
    q, k, v = _qkv(1, 4, 2, 20, 20, 32, 16, torch.float64, seed=3)
    out, lse = flash_attention_train_ref(q, k, v, causal)
    s = torch.einsum("bhsd,bhtd->bhst", q, k.repeat_interleave(2, 1)) / math.sqrt(32)
    if causal:
        s = s.masked_fill(torch.ones(20, 20, dtype=torch.bool).triu(1), float("-inf"))
    assert lse.dtype == torch.float32
    torch.testing.assert_close(lse, torch.logsumexp(s, -1).float())
    torch.testing.assert_close(out, torch.softmax(s, -1) @ v.repeat_interleave(2, 1),
                               rtol=1e-5, atol=1e-6)


def test_backward_twin_splits_ds_in_two_halves():
    """The backward twin's dq and dk take dS as hi + lo: at float32 inputs
    (whose ``hi`` is dS itself) they are float32 autograd's gradients."""
    q, k, v = (x.requires_grad_() for x in _qkv(1, 2, 2, 16, 16, 16, 16, torch.float32, seed=4))
    do = torch.randn(1, 2, 16, 16, generator=torch.Generator().manual_seed(5))
    out, lse = flash_attention_train_ref(q.detach(), k.detach(), v.detach(), True)
    dq, dk, dv = flash_attention_backward_ref(q.detach(), k.detach(), v.detach(), out, lse, do,
                                              True)
    s = (q @ k.transpose(-1, -2)) / 4.0
    s = s.masked_fill(torch.ones(16, 16, dtype=torch.bool).triu(1), float("-inf"))
    (torch.softmax(s, -1) @ v).backward(do)
    for got, want in ((dq, q.grad), (dk, k.grad), (dv, v.grad)):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
