"""CUDA kernels against their plain twins, byte-identity, and the LM serving and
training paths on the card.

Every test here needs a CUDA device and skips without one.  The file imports
no JAX, so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import importlib
import importlib.util
import math
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (  # noqa: E402
    PartitionService,
    build_pack_plan,
    edge_partition,
    synthetic_bipartite_graph,
)
from repro_torch.kernels import _build, flash_attention, launch_counts, moe_mlp  # noqa: E402
from repro_torch.kernels.ops import ep_spmv  # noqa: E402
from repro_torch.kernels.ref import flash_attention_ref, moe_mlp_ref  # noqa: E402
from repro_torch.launch.serve import prefill_inputs  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.runtime import GraphRequest, GraphServer  # noqa: E402

K = importlib.import_module("repro_torch.kernels.ep_spmv")

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _problem(n_rows, n_cols, nnz_per_row, k, seed=0, pad=8):
    edges, rows, cols = synthetic_bipartite_graph(n_rows, n_cols, nnz_per_row, seed=seed)
    res = edge_partition(edges, k, method="ep", seed=seed)
    plan = build_pack_plan(n_rows, n_cols, rows, cols, res.labels, k, pad=pad)
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal(rows.shape[0]).astype(np.float32)
    x = rng.standard_normal(n_cols).astype(np.float32)
    return plan, vals, x


def _entry(n_rows, n_cols, nnz_per_row, seed):
    _, rows, cols = synthetic_bipartite_graph(n_rows, n_cols, nnz_per_row, seed=seed)
    rng = np.random.default_rng(seed + 1000)
    vals = rng.standard_normal(rows.shape[0]).astype(np.float32)
    x = rng.standard_normal(n_cols).astype(np.float32)
    return GraphRequest(n_rows, n_cols, rows, cols, vals, x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernels_match_twins(cuda_device, dtype):
    plan, vals, x = _problem(128, 96, 3, 8)
    dev = cuda_device
    t = torch.from_numpy
    vp = t(plan.pack_values(vals)).to(dev, dtype)
    xl, yl = t(plan.x_lidx).to(dev), t(plan.y_lidx).to(dev)
    xv = t(x).to(dev, dtype)
    xp = xv[t(plan.x_gidx).long().to(dev)]
    xg = torch.gather(t(plan.x_gidx).to(dev), 1, xl.long())
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else dict(rtol=1e-12, atol=1e-12)
    before = K.launch_counts()
    got = K.spmv_software_cache(vp, xl, yl, xp, plan.y_max)
    torch.testing.assert_close(got, K.software_cache_plain(vp, xl, yl, xp, plan.y_max), **tol)
    got = K.spmv_streaming(vp, xg, yl, xv, plan.y_max)
    torch.testing.assert_close(got, K.streaming_plain(vp, xg, yl, xv, plan.y_max), **tol)
    b3 = (torch.stack([vp, vp, 0 * vp]), torch.stack([xg] * 3), torch.stack([yl] * 3))
    xb = torch.stack([xv, 2 * xv, xv])
    got = K.spmv_streaming_batched(*b3, xb, plan.y_max)
    torch.testing.assert_close(got, K.streaming_batched_plain(*b3, xb, plan.y_max), **tol)
    assert torch.equal(got[2], torch.zeros_like(got[2]))
    row_ptr, src = (a.to(dev) for a in K.combine_table(t(plan.y_gidx), plan.n_rows))
    y = K.ep_combine(got[0], row_ptr, src, plan.n_rows)
    torch.testing.assert_close(y, K.combine_plain(got[0], row_ptr, src, plan.n_rows), **tol)
    torch.cuda.synchronize()
    after = K.launch_counts()
    assert all(after[name] == before[name] + 1 for name in after)


@pytest.mark.parametrize("mode", ["software", "streaming"])
@pytest.mark.parametrize("shape,pad,seed", [((64, 64, 4, 4), 8, 0), ((301, 257, 7, 5), 1, 1),
                                            ((301, 257, 7, 5), 3, 3)])
def test_card_bits_equal_cpu_twin(cuda_device, mode, shape, pad, seed):
    """pad 1 and 3 give an e_max that is not a multiple of 4: rows whose
    start is off the 16-byte grid."""
    plan, vals, x = _problem(*shape, seed=seed, pad=pad)
    assert pad == 8 or plan.e_max % 4 != 0
    y = ep_spmv(x, plan, vals, mode=mode, device=cuda_device)
    # Same products and sums, in the same order, on either device.
    assert torch.equal(y.cpu(), ep_spmv(x, plan, vals, mode=mode, device="cpu"))


@pytest.mark.parametrize("mode", ["software", "streaming"])
def test_server_byte_identity_on_card(cuda_device, mode):
    reqs = [_entry(120, 120, 4, seed=s) for s in range(3)]
    with PartitionService() as svc:
        dedicated = GraphServer(svc, k=4, pad=8, mode=mode, device=cuda_device,
                                bucketing=None, start_batcher=False)
        with GraphServer(svc, k=4, pad=8, mode=mode, device=cuda_device, max_batch=4,
                         max_wait_ms=300.0) as server:
            alone = [server.serve(r).y.cpu() for r in reqs]
            stacked = [h.wait(60.0) for h in [server.submit(r) for r in reqs]]
        own = [dedicated.serve(r).y.cpu() for r in reqs]
    for y1, res, y_own in zip(alone, stacked, own):
        assert res.info.batch_size == 3
        assert torch.equal(res.y.cpu(), y1)  # stacked batch == batch of one
        assert torch.equal(y_own, y1)  # bucketed == dedicated


def _coo_y(s, n_rows):
    return np.bincount(s["rows"], weights=s["vals"].astype(np.float64)
                       * s["x"].astype(np.float64)[s["cols"]], minlength=n_rows)


@pytest.mark.parametrize("driver, kwargs, lane", [
    ("multitenant", {}, "spmv_software_cache"),
    ("replicated", {"mode": "streaming"}, "spmv_streaming_batched"),
    ("replicated", {"transport": "process"}, "spmv_software_cache"),
    ("overload", {}, "spmv_software_cache"),
])
def test_slice_drivers_on_card(cuda_device, driver, kwargs, lane):
    """The multitenant, replicated and overload drivers at their defaults on
    the card (no device given): every y within 1e-5 of the COO product,
    nothing stale, and the bucketed lane's kernel and the combine launched."""
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.launch import serve

    reset_launch_counts()
    report = getattr(serve, f"run_{driver}_graph_serving")(keep_samples=True, **kwargs)
    launches = launch_counts()
    assert report["device"].startswith("cuda")
    samples = report["samples"]
    samples = ([s for ss in samples.values() for s in ss] if isinstance(samples, dict)
               else samples)
    n_rows = 192 if driver == "overload" else 256
    assert samples and not any(s["stale"] for s in samples)
    for s in samples:
        np.testing.assert_allclose(s["y"], _coo_y(s, n_rows), rtol=1e-5, atol=1e-5)
    assert launches[lane] >= len(samples) and launches["ep_combine"] >= len(samples)


def synthetic_tiles(b, k, e_max, y_max, n_cols, counts, occupied, dtype, seed, hub=0):
    """Streaming operands packed as ``build_pack_plan`` packs them, without a
    partition: row r = b * k + p holds ``counts[r]`` tasks first, sorted by y
    slot, on ``occupied[r]`` distinct slots (each slot at least one task),
    then zero padding (y slot 0, x index 0); with ``hub``, ``hub`` of row 0's
    tasks fall on one slot.  Returns CPU tensors ``vals, xg_task, y_lidx
    (B, k, E)``, ``x (B, n_cols)`` and the runs ``seg (B, k, y_max + 1)``."""
    rng = np.random.default_rng(seed)
    rows = b * k
    vals = np.zeros((rows, e_max), dtype)
    xg, yl = np.zeros((rows, e_max), np.int32), np.zeros((rows, e_max), np.int32)
    valid = np.zeros((rows, e_max), bool)
    for r, (n, m) in enumerate(zip(counts, occupied)):
        if n == 0:
            continue
        slots = np.concatenate([np.arange(m), rng.integers(0, m, n - m)])
        if r == 0 and hub:
            slots[m:m + hub] = m // 2
        yl[r, :n] = np.sort(np.sort(rng.choice(y_max, m, replace=False))[slots])
        vals[r, :n] = rng.standard_normal(n)
        xg[r, :n] = rng.integers(0, n_cols, n)
        valid[r, :n] = True
    x = rng.standard_normal((b, n_cols)).astype(dtype)
    seg = K.tile_order(torch.from_numpy(yl), y_max, torch.from_numpy(valid))
    shape = (b, k, e_max)
    return (torch.from_numpy(vals).view(shape), torch.from_numpy(xg).view(shape),
            torch.from_numpy(yl).view(shape), torch.from_numpy(x), seg.view(b, k, y_max + 1))


# (B, k, e_max, y_max, n_cols, tasks per row, occupied slots per row, hub): the
# streaming kernel stages 2,048 f32 (1,024 f64) task slots at a time, one CTA
# per 1,024 y slots of a row, with 16-byte loads of rows whose start may not
# lie on the 16-byte grid (e_max odd).
STREAM_EDGES = {
    "hub_run_over_chunk": (1, 3, 6001, 700, 300, [5600, 40, 0], [300, 20, 0], 5000),
    "tile_over_buffer": (1, 2, 6400, 1100, 500, [6400, 3000], [1000, 900], 0),
    "e_max_4227": (2, 3, 4227, 1300, 1000, [4227, 4000, 1, 0, 4226, 17],
                   [1300, 1200, 1, 0, 5, 17], 0),
    "e_max_4225_y_max_513": (1, 4, 4225, 513, 800, [4225, 4224, 4223, 3], [513, 512, 500, 1], 0),
    "empty_tiles_zero_slot": (3, 2, 130, 70, 50, [100, 0, 0, 0, 129, 130], [60, 0, 0, 0, 70, 1],
                              0),
    "batched_occupancy": (2, 4, 5376, 5376, 16384, [4012] * 8, [648] * 8, 0),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("case", list(STREAM_EDGES))
def test_streaming_bits_equal_twin_on_edges(cuda_device, dtype, case):
    """Both streaming wrappers on the card give the CPU twin's bits on the
    redesigned kernel's edges: a run longer than a staged chunk, a window with
    more tasks than the product buffer, rows off the 16-byte grid, a y_max
    that is not a multiple of the window, empty tiles, an all-zero batch slot
    and f64.  The B = 1 wrapper runs each batch slot alone, with its runs and
    without (it then sorts the tasks itself)."""
    b, k, e_max, y_max, n_cols, counts, occupied, hub = STREAM_EDGES[case]
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    v, xg, yl, x, seg = synthetic_tiles(b, k, e_max, y_max, n_cols, counts, occupied, np_dtype,
                                        seed=len(case), hub=hub)
    if case == "empty_tiles_zero_slot":
        v[1], x[1] = 0, 0
    want = K.streaming_batched_plain(v, xg, yl, x, y_max, seg)
    dev = cuda_device
    before = K.launch_counts()
    got = K.spmv_streaming_batched(v.to(dev), xg.to(dev), yl.to(dev), x.to(dev), y_max,
                                   seg=seg.to(dev))
    assert torch.equal(got.cpu(), want)
    for i in range(b):
        ops = v[i].to(dev), xg[i].to(dev), yl[i].to(dev), x[i].to(dev), y_max
        assert torch.equal(K.spmv_streaming(*ops, seg=seg[i].to(dev)).cpu(), want[i])
        assert torch.equal(K.spmv_streaming(*ops).cpu(),
                           K.streaming_plain(v[i], xg[i], yl[i], x[i], y_max))
    torch.cuda.synchronize()
    after = K.launch_counts()
    assert after["spmv_streaming_batched"] == before["spmv_streaming_batched"] + 1
    assert after["spmv_streaming"] == before["spmv_streaming"] + 2 * b
    if case == "empty_tiles_zero_slot":
        assert torch.equal(got[1], torch.zeros_like(got[1]))


def test_stream_kernel_uses_16_byte_loads(cuda_device):
    """The streaming kernel streams its tasks with 16-byte loads
    (LDG.E[.qualifiers].128) in both types."""
    fn, found = None, {}
    for line in _build.sass("ep_spmv").splitlines():
        if "Function : " in line:
            fn = line.split("Function : ")[1].strip()
            found[fn] = False
        elif fn is not None and re.search(r"\bLDG\.E\.(?:\w+\.)*128\b", line):
            found[fn] = True
    stream = [fn for fn in found if "stream_kernel" in fn]
    assert len(stream) == 2 and all(found[fn] for fn in stream), found


# ---------------------------------------------------------------------------
# The serving path's kernels: flash_attention and moe_mlp
# ---------------------------------------------------------------------------

# The reference's tolerances (tests/test_kernels.py): 2e-5 in float32, 5e-2 in bf16.
KERNEL_TOL = {torch.float32: 2e-5, torch.bfloat16: 5e-2}


@pytest.fixture()
def no_tf32():
    """Float32 checks run the twins' products in full float32 (no TF32)."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _assert_kernel_close(got, want):
    """The reference's tolerance; a bf16 output is also held elementwise to
    1e-2 |want| + 5e-2 of its row's RMS (chip_smoke.py's limit): late rows of
    causal attention are ~sqrt(e / i) in size, well under 5e-2, and one bf16
    ulp is at most 2^-7 of a value."""
    tol = KERNEL_TOL[got.dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    if got.dtype == torch.bfloat16:
        got, want = got.double(), want.double()
        limit = 1e-2 * want.abs() + 5e-2 * want.square().mean(-1, keepdim=True).sqrt()
        assert bool(((got - want).abs() <= limit).all())


def _randn(shape, dtype, dev, seed, scale=1.0):
    a = np.random.default_rng(seed).standard_normal(shape) * scale
    return torch.from_numpy(a.astype(np.float32)).to(dev, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,s,t,d,causal", [
    (1, 2, 128, 128, 64, True),
    (2, 2, 192, 192, 32, False),
    (1, 2, 100, 100, 16, True),     # ragged S = T
    (1, 2, 64, 200, 128, False),    # T != S, ragged T
    (1, 1, 130, 70, 256, True),     # S > T, largest head
    (1, 4, 1100, 1100, 128, True),  # 18 key tiles, ragged
])
def test_flash_attention_matches_twin(cuda_device, no_tf32, dtype, b, h, s, t, d, causal):
    q = _randn((b, h, s, d), dtype, cuda_device, 0)
    k = _randn((b, h, t, d), dtype, cuda_device, 1)
    v = _randn((b, h, t, d), dtype, cuda_device, 2)
    before = launch_counts()["flash_attention"]
    out = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention"] == before + 1
    want = flash_attention_ref(q, k, v, causal)
    _assert_kernel_close(out, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("e,c,d,f", [
    (4, 128, 64, 128),
    (8, 100, 32, 64),    # capacity not a multiple of the 64-row tile
    (3, 8, 2048, 768),   # decode-sized capacity at qwen3-moe's widths
    (2, 72, 256, 192),   # just above the small-capacity path, ragged tile
    (5, 33, 128, 64),    # small-capacity path, 64 token columns
])
def test_moe_mlp_matches_twin(cuda_device, no_tf32, dtype, e, c, d, f):
    x = _randn((e, c, d), dtype, cuda_device, 0)
    wg = _randn((e, d, f), dtype, cuda_device, 1, d ** -0.5)
    wu = _randn((e, d, f), dtype, cuda_device, 2, d ** -0.5)
    wd = _randn((e, f, d), dtype, cuda_device, 3, f ** -0.5)
    before = launch_counts()["moe_mlp"]
    out = moe_mlp(x, wg, wu, wd)
    torch.cuda.synchronize()
    assert launch_counts()["moe_mlp"] == before + 1
    _assert_kernel_close(out, moe_mlp_ref(x, wg, wu, wd))


@pytest.mark.parametrize("b,h,hkv,s,t,d,causal", [
    (2, 8, 1, 300, 300, 128, True),   # one kv head, ragged S = T
    (1, 8, 2, 200, 333, 64, False),   # T != S, neither a multiple of 128
    (2, 8, 4, 257, 190, 128, True),   # S > T
    (1, 32, 4, 640, 640, 128, True),  # qwen3-moe's 32 / 4 heads
    (2, 12, 2, 384, 384, 128, True),  # qwen2-vl-2b's 12 / 2 heads: a group of 6
    (1, 16, 16, 700, 700, 64, True),  # seamless's causal decoder self-attention, Dh 64
])
def test_flash_attention_gqa_matches_twin(cuda_device, b, h, hkv, s, t, d, causal):
    """Un-repeated K/V (Hkv <= H): q head h reads kv head h // (H // Hkv)."""
    q = _randn((b, h, s, d), torch.bfloat16, cuda_device, 0)
    k = _randn((b, hkv, t, d), torch.bfloat16, cuda_device, 1)
    v = _randn((b, hkv, t, d), torch.bfloat16, cuda_device, 2)
    out = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    g = h // hkv
    want = flash_attention_ref(q, k.repeat_interleave(g, 1), v.repeat_interleave(g, 1), causal)
    _assert_kernel_close(out, want)
    assert torch.equal(out, flash_attention(q, k.repeat_interleave(g, 1).contiguous(),
                                            v.repeat_interleave(g, 1).contiguous(), causal))


def test_flash_attention_cross_shape_matches_twin(cuda_device):
    """seamless-m4t-medium's cross-attention: head size 64, H = Hkv = 16,
    non-causal over T != S keys (an encoder input longer than the prompt)."""
    q = _randn((2, 16, 300, 64), torch.bfloat16, cuda_device, 0)
    k = _randn((2, 16, 517, 64), torch.bfloat16, cuda_device, 1)
    v = _randn((2, 16, 517, 64), torch.bfloat16, cuda_device, 2)
    out = flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    _assert_kernel_close(out, flash_attention_ref(q, k, v, False))


# ---------------------------------------------------------------------------
# Training attention: the flash forward with its log-sum-exp, the flash backward
# ---------------------------------------------------------------------------

# Scaled-down shapes of every kind the port trains: (B, H, Hkv, S, T, Dh, Dv, causal).
TRAIN_ATTENTION = {
    "gqa-32-4-dh128": (1, 32, 4, 512, 512, 128, 128, True),   # qwen3-moe's heads
    "mla-192-128": (1, 4, 4, 384, 384, 192, 128, True),       # Moonlight's latent attention
    "dh64-cross": (2, 8, 8, 200, 333, 64, 64, False),         # seamless's cross-attention
    "ragged": (2, 8, 4, 257, 190, 128, 128, True),            # S, T not tile multiples, S > T
    "dh256": (1, 2, 2, 160, 160, 256, 256, True),             # dK and dV a launch each
}


def _train_attention_inputs(case, dev):
    b, h, hkv, s, t, dh, dv, causal = TRAIN_ATTENTION[case]
    q = _randn((b, h, s, dh), torch.bfloat16, dev, 0)
    k = _randn((b, hkv, t, dh), torch.bfloat16, dev, 1)
    v = _randn((b, hkv, t, dv), torch.bfloat16, dev, 2)
    return q, k, v, _randn((b, h, s, dv), torch.bfloat16, dev, 3), causal


@pytest.mark.parametrize("case", list(TRAIN_ATTENTION), ids=list(TRAIN_ATTENTION))
def test_fused_attention_matches_float64_chunked(cuda_device, no_tf32, case):
    """``chunked_attention``'s fused path on the card: the output and dq, dk
    and dv against the chunked loop's autograd in float64 on the same bf16
    inputs, each within 1.5e-2 of the reference's largest magnitude (p, the
    output and each gradient are rounded to bf16 once, 2^-8 relative each,
    where the float64 loop rounds nothing).  The call counts one
    ``attention.fused`` and launches one training forward and one backward."""
    from repro_torch.models import layers
    from repro_torch.runtime import spans

    q, k, v, do, causal = _train_attention_inputs(case, cuda_device)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = launch_counts()
    spans.clear()
    spans.enable()
    try:
        with spans.step(cuda_device):
            out = layers.chunked_attention(*leaves, causal=causal)
            out.backward(do)
        (st,) = spans.steps()
    finally:
        spans.disable()
        spans.clear()
    after = launch_counts()
    assert st["counters"] == {"attention.fused": 1}
    assert after["flash_attention_train"] == before["flash_attention_train"] + 1
    assert after["flash_attention_backward"] == before["flash_attention_backward"] + 1
    ref = [x.double().requires_grad_() for x in (q, k, v)]
    want = layers._chunked_attention(*ref, causal, 1024)
    want.backward(do.double())
    for name, got, r in (("out", out, want), *zip(("dq", "dk", "dv"), (x.grad for x in leaves),
                                                  (x.grad for x in ref))):
        r = r.detach()
        assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all()), name
        err = (got.double() - r).abs().max().item()
        assert err <= 1.5e-2 * r.abs().max().item(), (name, err)


@pytest.mark.parametrize("case", list(TRAIN_ATTENTION), ids=list(TRAIN_ATTENTION))
def test_fused_attention_backward_is_deterministic(cuda_device, case):
    """Two backward calls on the same inputs give the same bits (no atomics:
    every CTA owns its rows of dq, dk and dv and sums in a fixed order)."""
    from repro_torch.kernels import flash_attention_backward, flash_attention_train

    q, k, v, do, causal = _train_attention_inputs(case, cuda_device)
    out, lse = flash_attention_train(q, k, v, causal)
    first = flash_attention_backward(q, k, v, out, lse, do, causal)
    second = flash_attention_backward(q, k, v, out, lse, do, causal)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def _tf32(x):
    """float32 ``x`` rounded to TF32's 10 stored mantissa bits (ties away)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _backward_variant(q, k, v, out, lse, do, causal, variant):
    """The training backward's twin (``flash_attention_backward_ref``) with one
    piece of its arithmetic changed: ``p_unrounded`` leaves p in float32 before
    ``p^T do``, ``ds_one_bf16`` rounds dS once to bf16, ``ds_tf32`` takes dS in
    TF32 (the other pieces as the twin's: dS as two bf16 halves, p rounded,
    float32 sums)."""
    g = q.shape[1] // k.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    d = (do.float() * out.float()).sum(-1)
    dq = torch.empty(q.shape, dtype=torch.float64, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float64, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float64, device=q.device)
    for b in range(q.shape[0]):
        for h in range(q.shape[1]):
            kv = h // g
            qf, kf, vf, dof = q[b, h].float(), k[b, kv].float(), v[b, kv].float(), do[b, h].float()
            p = torch.exp(qf @ kf.T * scale - lse[b, h, :, None])
            if causal:
                p = p.masked_fill(torch.ones_like(p, dtype=torch.bool).triu(1), 0.0)
            pv = p if variant == "p_unrounded" else p.bfloat16().float()
            dv[b, kv] += (pv.T @ dof).double()
            ds = scale * (p * (dof @ vf.T - d[b, h, :, None]))
            if variant == "ds_one_bf16":
                ds = ds.bfloat16().float()
            elif variant == "ds_tf32":
                ds = _tf32(ds)
            else:
                hi = ds.bfloat16().float()
                ds = hi + (ds - hi).bfloat16().float()
            dq[b, h] = (ds @ kf).double()
            dk[b, kv] += (ds.T @ qf).double()
    return dq, dk, dv


@pytest.mark.parametrize("variant,grads", [("p_unrounded", (2,)), ("ds_one_bf16", (0, 1)),
                                           ("ds_tf32", (0, 1))])
@pytest.mark.parametrize("case", ["gqa-32-4-dh128", "mla-192-128"])
def test_fused_attention_arithmetic_is_the_stated_one(cuda_device, no_tf32, case, variant,
                                                      grads):
    """The kernels' gradients lie nearer the stated arithmetic (bf16 operands
    with float32 sums, p rounded to v's type before its product with dout,
    dS as two bf16 halves: ``flash_attention_backward_ref``) than the same
    computation with one piece changed: p left in float32 (dv), dS rounded
    once to bf16 or taken in TF32 (dq and dk).  Nearer by half: ``|kernel -
    stated| <= 0.5 |kernel - variant|`` in the Frobenius norm, each twin's
    float32 result rounded to bf16 as the kernels round theirs (a changed
    piece moves ~2^-9 to 2^-11 of a value, enough to round many entries
    otherwise; the kernels' sum order moves ~2^-22 and rounds few
    otherwise)."""
    from repro_torch.kernels import flash_attention_backward, flash_attention_train
    from repro_torch.kernels.ref import flash_attention_backward_ref

    q, k, v, do, causal = _train_attention_inputs(case, cuda_device)
    out, lse = flash_attention_train(q, k, v, causal)
    got = flash_attention_backward(q, k, v, out, lse, do, causal)
    stated = flash_attention_backward_ref(q, k, v, out, lse, do, causal)
    changed = _backward_variant(q, k, v, out, lse, do, causal, variant)
    for i in grads:
        near = (got[i].double() - stated[i].double()).norm().item()
        far = (got[i].double() - changed[i].bfloat16().double()).norm().item()
        assert near <= 0.5 * far, (i, near, far)


def test_fused_attention_width_the_kernels_do_not_take_raises_on_card(cuda_device):
    """bf16 card inputs with values wider than the q/k heads raise in the
    fused path; nothing launches and nothing falls back."""
    from repro_torch.models import layers

    q = _randn((1, 2, 64, 64), torch.bfloat16, cuda_device, 0)
    k = _randn((1, 2, 64, 64), torch.bfloat16, cuda_device, 1)
    v = _randn((1, 2, 64, 128), torch.bfloat16, cuda_device, 2)
    before = launch_counts()
    with pytest.raises(ValueError, match="head sizes"):
        layers.chunked_attention(q, k, v, causal=True)
    assert launch_counts() == before


@pytest.mark.parametrize("c", [64, 8])
def test_moe_mlp_at_jamba_widths_matches_twin(cuda_device, c):
    """jamba-1.5-large's expert widths (D 8,192, F 24,576) on two experts,
    at the largest capacity of the small-capacity path and at decode's."""
    e, d, f = 2, 8192, 24576
    gen = torch.Generator(device=cuda_device).manual_seed(c)

    def randn(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=cuda_device) * scale).bfloat16()

    x = randn((e, c, d))
    wg, wu = randn((e, d, f), d ** -0.5), randn((e, d, f), d ** -0.5)
    wd = randn((e, f, d), f ** -0.5)
    out = moe_mlp(x, wg, wu, wd)
    torch.cuda.synchronize()
    _assert_kernel_close(out, moe_mlp_ref(x, wg, wu, wd))


def _routed_slab(e, c, d, dev, seed):
    """A capacity slab as moe_ffn fills it: expert i holds its first n_i rows,
    the rest are zeros, and a third of the experts hold none."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, c + 1, e)
    counts[rng.permutation(e)[: e // 3]] = 0
    x = rng.standard_normal((e, c, d)).astype(np.float32)
    x[np.arange(c)[None, :] >= counts[:, None]] = 0.0
    return torch.from_numpy(x).to(dev, torch.bfloat16), counts


@pytest.mark.parametrize("dtype,e,c,d,f", [
    (torch.bfloat16, 8, 16, 2048, 48),    # qwen3-moe decode on 16x16: 128 / 16 experts, F 768 / 16
    (torch.float32, 8, 16, 2048, 48),
    (torch.bfloat16, 8, 200, 2048, 48),   # the same slice at a capacity above 64
    (torch.bfloat16, 1, 24, 8192, 1536),  # jamba decode on 16x16: 16 / 16 experts, F 24,576 / 16
    (torch.float32, 64, 8, 2048, 384),    # the four-card case: 128 / 2 experts, F 768 / 2, f32
], ids=["qwen3-moe-bf16", "qwen3-moe-f32", "qwen3-moe-c200", "jamba-bf16", "cards-f32"])
def test_moe_mlp_on_stationary_expert_slices_matches_twin(cuda_device, no_tf32, dtype, e, c, d, f):
    """The local slices that the stationary experts hand the kernel (E / 'model'
    experts, F / 'data' of each): F 48 is under one 64-wide tile of every
    kernel (the tensor maps zero-fill past it, the stores are masked), F 1,536
    is 24 of them.  A routed slab, with empty experts."""
    x, _ = _routed_slab(e, c, d, cuda_device, seed=f)
    x = x.to(dtype)
    wg = _randn((e, d, f), dtype, cuda_device, 1, d ** -0.5)
    wu = _randn((e, d, f), dtype, cuda_device, 2, d ** -0.5)
    wd = _randn((e, f, d), dtype, cuda_device, 3, f ** -0.5)
    before = launch_counts()["moe_mlp"]
    out = moe_mlp(x, wg, wu, wd)
    torch.cuda.synchronize()
    assert launch_counts()["moe_mlp"] == before + 1
    _assert_kernel_close(out, moe_mlp_ref(x, wg, wu, wd))


@pytest.mark.parametrize("e,c", [(16, 8), (16, 640), (12, 200), (24, 40)])
def test_moe_mlp_routed_slab_matches_twin(cuda_device, e, c):
    """qwen3-moe's widths (D 2048, F 768) on a routed slab with empty experts:
    decode (C = 8) and prefill (C = 640) capacities, and capacities that are
    not a multiple of 128 (or of 8).  Empty experts and unfilled rows are 0."""
    d, f = 2048, 768
    x, counts = _routed_slab(e, c, d, cuda_device, seed=c)
    wg = _randn((e, d, f), torch.bfloat16, cuda_device, 1, d ** -0.5)
    wu = _randn((e, d, f), torch.bfloat16, cuda_device, 2, d ** -0.5)
    wd = _randn((e, f, d), torch.bfloat16, cuda_device, 3, f ** -0.5)
    out = moe_mlp(x, wg, wu, wd)
    torch.cuda.synchronize()
    _assert_kernel_close(out, moe_mlp_ref(x, wg, wu, wd))
    filled = torch.arange(c, device=cuda_device)[None, :] < torch.from_numpy(counts).to(
        cuda_device)[:, None]
    assert bool((out[~filled] == 0).all())
    if c <= 64:  # the small-capacity path writes +0 for an empty expert
        assert not bool(torch.signbit(out[torch.from_numpy(counts == 0).to(cuda_device)]).any())


def test_bf16_kernels_use_wgmma_and_tma(cuda_device):
    """The redesigned kernels compile to Hopper's tensor-core (HGMMA) and TMA
    (UTMALDG) instructions, and so do the training attention's backward kernels."""
    for name in ("flash_attention", "flash_attention_bwd", "moe_mlp"):
        sass = _build.sass(name)
        assert "HGMMA" in sass and "UTMALDG" in sass, name


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "granite-3-8b", "mamba2-2.7b",
                                  "jamba-1.5-large-398b", "qwen2-vl-2b",
                                  "seamless-m4t-medium"])
def test_reduced_model_on_card_matches_cpu(cuda_device, no_tf32, arch):
    """Same weights and prompt: the kernels on the card against the twins on
    the CPU, through prefill and three decode steps fed the CPU's tokens.
    Float32 throughout; 1e-4 covers sums taken in other orders over 2 layers.
    The attention-free mamba2 launches no kernel (its prompt of 24 tokens
    spans two SSD chunks of 16, the second padded); the hybrid jamba (two
    periods of four) launches flash once a period and the expert FFN in its
    MoE layers; seamless launches flash in its encoder layers and twice in
    each decoder layer (self- and cross-attention) at prefill."""
    cfg = get_config(arch, reduced=True)
    cpu, card = Model(cfg, device="cpu"), Model(cfg, device=cuda_device)
    params = cpu.init(0)
    params_card = params.map(lambda _, w: w.to(cuda_device))
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(2, cfg.vocab_size, (2, 24)))
    # Three different M-RoPE streams (t constant, h = i // 8, w = i % 8), and
    # an encoder input longer than the prompt.
    i = torch.arange(24)
    inputs = prefill_inputs(cfg, prompt, rng, positions3=torch.stack([0 * i, i // 8, i % 8]),
                            enc_len=24 + 13)
    want, cache = cpu.prefill(params, inputs, 27)
    before = launch_counts()
    got, cache_card = card.prefill(params_card,
                                   {k: v.to(cuda_device) for k, v in inputs.items()}, 27)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    for i in range(3):
        tok = torch.argmax(want, -1)[:, None]
        want, cache = cpu.decode_step(params, cache, {"tokens": tok}, 24 + i)
        got, cache_card = card.decode_step(params_card, cache_card,
                                           {"tokens": tok.to(cuda_device)}, 24 + i)
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    after = launch_counts()
    flash = cfg.layer_kinds().count("attn")
    if cfg.family == "encdec":
        flash += cfg.n_encoder_layers + cfg.n_layers
    assert after["flash_attention"] == before["flash_attention"] + flash
    assert after["moe_mlp"] == before["moe_mlp"] + 4 * cfg.ffn_kinds().count("moe")


def _example(name):
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / f"torch_{name}.py"
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_on_card(cuda_device, capsys):
    """The quickstart's software-cache SpMV runs the shared-memory kernel and
    the combine on the card, within 1e-4 of the COO oracle."""
    before = launch_counts()
    err = _example("quickstart").main(["--device", "cuda"])
    after = launch_counts()
    assert err < 1e-4 and capsys.readouterr().out.rstrip().endswith("quickstart OK")
    for name in ("spmv_software_cache", "ep_combine"):
        assert after[name] == before[name] + 1, name


def test_spmv_cg_on_card(cuda_device, capsys):
    """CG behind the adaptive scheduler on the card; whichever SpMV served an
    iteration, the residual is under 1e-3 within 60 iterations.  Each
    optimized call launched the kernel and the combine once."""
    before = launch_counts()
    report = _example("spmv_cg").main(["--device", "cuda"])
    after = launch_counts()
    assert report["residual"] < 1e-3 and report["iterations"] <= 60
    assert capsys.readouterr().out.rstrip().endswith("spmv_cg OK")
    for name in ("spmv_software_cache", "ep_combine"):
        assert after[name] - before[name] == report["optimized_calls"], name


# ---------------------------------------------------------------------------
# Training on the card
# ---------------------------------------------------------------------------


def _train_batch(cfg, rng, b=4, s=32):
    from repro_torch.launch.serve import prefill_inputs

    prompt = torch.from_numpy(rng.integers(2, cfg.vocab_size, (b, s)))
    inputs = prefill_inputs(cfg, prompt, rng, enc_len=s + 5)
    inputs["labels"] = torch.from_numpy(rng.integers(2, cfg.vocab_size, (b, s)))
    return inputs


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "granite-3-8b", "mamba2-2.7b",
                                  "jamba-1.5-large-398b", "seamless-m4t-medium",
                                  "nemotron-3-nano-30b-a3b"])
def test_reduced_train_step_on_card_matches_cpu(cuda_device, no_tf32, arch):
    """One step at two microbatches on the card against the CPU, the same
    weights: the loss, each gradient leaf (relative to its largest
    magnitude) and the updated weights within 1e-4 (a learning rate of 1e-5
    keeps Adam's sign-normalised first update from amplifying rounding).
    The card's step launches AdamW's kernels alone (a norm, an update a
    leaf): the reduced configs' float32 attention takes the chunked loop."""
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.train import init_train_state, make_train_step

    cfg = get_config(arch, reduced=True)
    opt = AdamWConfig(lr=1e-5)
    cpu, card = Model(cfg, device="cpu"), Model(cfg, device=cuda_device)
    s_cpu, s_card = init_train_state(cpu, opt, 0), init_train_state(card, opt, 0)
    with torch.no_grad():
        for a, b in zip(s_card.params.parameters(), s_cpu.params.parameters()):
            a.copy_(b)
    batch = _train_batch(cfg, np.random.default_rng(0))
    before = launch_counts()
    s_card, m_card = make_train_step(card, opt, num_microbatches=2)(
        s_card, {k: v.to(cuda_device) for k, v in batch.items()})
    after = launch_counts()
    leaves = len(list(s_card.params.parameters()))
    assert {k: after[k] - before[k] for k in after} == (
        dict.fromkeys(after, 0) | {"adamw_norm": 1, "adamw_update": leaves})
    s_cpu, m_cpu = make_train_step(cpu, opt, num_microbatches=2)(s_cpu, batch)
    assert abs(float(m_card["loss"]) - float(m_cpu["loss"])) < 1e-4
    for (name, a), b in zip(s_card.params.named_parameters(), s_cpu.params.parameters()):
        scale = max(float(b.grad.abs().max()), 1e-30)
        assert float((a.grad.cpu() - b.grad).abs().max()) <= 1e-4 * scale, name
        assert float((a.detach().cpu() - b.detach()).abs().max()) <= 1e-4, name


def test_restart_is_bit_exact_on_card(cuda_device, tmp_path):
    """The reference's restart test on the card, in a process of its own with
    deterministic algorithms (``CUBLAS_WORKSPACE_CONFIG`` set before CUDA
    starts): the run that fails at step 12 ends on the uninterrupted run's
    weights bit for bit."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import json, sys, torch\n"
        "torch.use_deterministic_algorithms(True)\n"
        "from repro_torch.launch.train import run_training\n"
        "kw = dict(arch='granite-3-8b', steps=16, batch=4, seq=32, reduced=True,\n"
        "          ckpt_every=5, num_microbatches=2, device='cuda')\n"
        "a, _ = run_training(ckpt_dir=sys.argv[1] + '/a', **kw)\n"
        "b, _ = run_training(ckpt_dir=sys.argv[1] + '/b', fail_at=12, **kw)\n"
        "same = all(torch.equal(x, y) for x, y in zip(a.params.parameters(),\n"
        "                                             b.params.parameters()))\n"
        "print(json.dumps({'same': same, 'step': int(b.step)}))\n")
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = {**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":4096:8", "PYTHONPATH": src}
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {"same": True, "step": 16}


def test_kernel_wrappers_refuse_gradients_on_card(cuda_device):
    """The kernels write through ctypes into fresh outputs: with an input that
    requires grad the wrappers raise instead of returning a result cut from
    autograd's graph, and launch nothing."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn((1, 2, 64, 64), generator=gen, device=cuda_device,
                           dtype=torch.bfloat16) for _ in range(3))
    x = torch.randn((2, 64, 64), generator=gen, device=cuda_device, dtype=torch.bfloat16)
    w = [torch.randn(shape, generator=gen, device=cuda_device, dtype=torch.bfloat16)
         for shape in ((2, 64, 64), (2, 64, 64), (2, 64, 64))]
    before = launch_counts()
    with pytest.raises(RuntimeError, match="forward only"):
        flash_attention(q, k.requires_grad_(), v)
    with pytest.raises(RuntimeError, match="forward only"):
        moe_mlp(x.requires_grad_(), *w)
    assert launch_counts() == before
    with torch.no_grad():
        flash_attention(q, k, v)
        moe_mlp(x, *w)
    after = launch_counts()
    assert after["flash_attention"] == before["flash_attention"] + 1
    assert after["moe_mlp"] == before["moe_mlp"] + 1


@pytest.fixture()
def host_mesh(cuda_device):
    """A one-rank NCCL group and the 1x1 ('data', 'model') mesh over the
    card, with the serve profile installed; torn down after the test."""
    import socket

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime.axes import ActivationSharding, set_activation_sharding

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0, world_size=1)
    mesh = make_host_mesh()
    set_activation_sharding(ActivationSharding(mesh, {"batch": ("data",), "model": ("model",)}))
    try:
        yield mesh
    finally:
        set_activation_sharding(None)
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "granite-3-8b"])
def test_sharded_prefill_on_card_matches_unsharded(host_mesh, no_tf32, arch):
    """The weights as DTensors on the 1x1 mesh (the serve rules): prefill and
    two decode steps give the unsharded run's tokens and logits (1e-4), and
    launch the kernels as many times: the local shards reach the kernels,
    never a DTensor and never the twins."""
    from repro_torch.runtime.serve import make_prefill_step
    from repro_torch.runtime.sharding import distribute_params, make_sharding_rules, param_specs

    cfg = get_config(arch, reduced=True)
    model = Model(cfg, device="cuda")
    params = model.init(0)
    sharded = distribute_params(params, param_specs(params, make_sharding_rules(host_mesh,
                                                                                "serve")),
                                host_mesh)
    prompt = torch.from_numpy(np.random.default_rng(5).integers(2, cfg.vocab_size, (2, 24)))
    prefill = make_prefill_step(model, 27)
    runs = {}
    for name, p in (("plain", params), ("sharded", sharded)):
        before = launch_counts()
        with torch.no_grad():
            tok, cache = prefill(p, {"tokens": prompt.cuda()})
            logits = []
            for i in range(2):
                tok = tok.full_tensor() if hasattr(tok, "full_tensor") else tok
                lg, cache = model.decode_step(p, cache, {"tokens": tok[:, None]}, 24 + i)
                lg = lg.full_tensor() if hasattr(lg, "full_tensor") else lg
                logits.append(lg)
                tok = torch.argmax(lg, -1).to(torch.int32)
        after = launch_counts()
        runs[name] = (logits, {k: after[k] - before[k] for k in after})
    for got, want in zip(runs["sharded"][0], runs["plain"][0]):
        assert torch.equal(torch.argmax(got, -1), torch.argmax(want, -1))
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert runs["sharded"][1] == runs["plain"][1]
    assert runs["plain"][1]["flash_attention"] == cfg.n_layers


# ---------------------------------------------------------------------------
# dot_f32 on the tensor cores
# ---------------------------------------------------------------------------


def _bf16_ulp(v):
    """One bf16 ulp at each value of ``v`` (8 significant bits)."""
    exp = torch.frexp(v.float()).exponent
    return torch.ldexp(torch.ones_like(v, dtype=torch.float32), exp - 8)


@pytest.mark.parametrize("xs,ws", [((2048, 2048), (2048, 151936)),
                                   ((128, 640, 2048), (128, 2048, 768))], ids=["head", "slab"])
def test_dot_f32_tensor_cores_match_float32_product(cuda_device, no_tf32, xs, ws):
    """At the head's chunk and the experts' slab shapes, the bf16 product
    with float32 sums agrees with the float32 product of the same values:
    each output element within 1e-5 of its ``sum |x w|`` (the sums are
    taken in another order).  Its gradients agree with autograd through the
    float32 product within one bf16 ulp, beyond the split gradient's own
    error (2^-16 of ``sum |g w|``, ``sum |x g|``)."""
    from repro_torch.models.layers import dot_f32, linear

    x = _randn(xs, torch.bfloat16, cuda_device, 0).requires_grad_()
    w = _randn(ws, torch.bfloat16, cuda_device, 1, scale=ws[-2] ** -0.5).requires_grad_()
    g = _randn((*xs[:-1], ws[-1]), torch.float32, cuda_device, 2, scale=1e-4)
    out = dot_f32(x, w)
    out.backward(g)
    dx, dw = x.grad, w.grad
    x.grad = w.grad = None
    want = linear(x.float(), w.float())
    want.backward(g)
    with torch.no_grad():
        assert out.dtype == torch.float32
        scale = linear(x.float().abs(), w.float().abs())
        assert bool(((out - want).abs() <= 1e-5 * scale).all())
        del out, want, scale
        wt, xt = w.float().abs().transpose(-1, -2), x.float().abs().transpose(-1, -2)
        dx_scale, dw_scale = g.abs() @ wt, xt @ g.abs()
        for got, ref, err in ((dx, x.grad, dx_scale), (dw, w.grad, dw_scale)):
            assert got.dtype == torch.bfloat16
            diff = (got.float() - ref.float()).abs()
            assert bool((diff <= _bf16_ulp(ref) + 2.0 ** -16 * err).all())


def test_dot_f32_train_step_launches_no_float32_gemm(cuda_device):
    """A profiled train step of a 1-layer bf16 cut: inside every
    ``repro_torch.dot_f32`` range whose operands were bf16 (it holds the
    ``_DotF32`` function), and in that function's backward node, no float32
    GEMM runs (no ``sgemm`` and no ``gemm_f32f32`` kernel); a range of
    float32 operands (the router's) does run one, so the names are read."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.train import init_train_state, make_train_step

    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b", reduced=True), n_layers=1,
                              compute_dtype="bfloat16")
    model = Model(cfg, device=cuda_device)
    opt = AdamWConfig()
    state = init_train_state(model, opt, 0)
    step = make_train_step(model, opt, num_microbatches=2)
    batch = {k: v.to(cuda_device) for k, v in _train_batch(cfg, np.random.default_rng(0)).items()}
    state, _ = step(state, batch)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, _ = step(state, batch)
        torch.cuda.synchronize()

    def kernels(evt):
        names = [k.name for k in evt.kernels]
        for c in evt.cpu_children:
            names += kernels(c)
        return names

    def holds(evt, name):
        return any(c.name == name or holds(c, name) for c in evt.cpu_children)

    f32_gemm = re.compile(r"sgemm|gemm_f32f32|f32f32_f32f32")
    bf16, f32 = [], []
    for evt in prof.events():
        if evt.name == "repro_torch.dot_f32":
            (bf16 if holds(evt, "_DotF32") else f32).append(kernels(evt))
        elif evt.name.endswith("_DotF32Backward"):
            bf16.append(kernels(evt))
    # 1 layer x 2 microbatches: gate and up (forward, remat's recompute, backward),
    # the head's chunks; the router in float32.
    assert len(bf16) >= 3 * 2 * 2 and len(f32) >= 2
    assert all(ks for ks in bf16)
    bad = sorted({k for ks in bf16 for k in ks if f32_gemm.search(k)})
    assert not bad, bad
    assert any(f32_gemm.search(k) for ks in f32 for k in ks)


# ---------------------------------------------------------------------------
# AdamW's kernels (csrc/adamw.cu) against the plain loop on the card
# ---------------------------------------------------------------------------

ADAMW_SIZES = (1, 3, 4, 4_097, 1_048_583)
# Gradients of norm ~0.5 over the tree: a clip of 1.0 leaves them, 0.05 scales them.
ADAMW_GRAD_SCALE = 5e-4


def _misaligned(x):
    """A contiguous copy of ``x`` that starts 4 bytes past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    assert out.is_contiguous() and out.data_ptr() % 16
    return out


def _adamw_tree(dev, seed, scale=1.0):
    """Leaves of ragged sizes, and one misaligned slice of 4,097."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    tree = {f"w{n}": torch.randn(n, generator=gen, device=dev) * scale for n in ADAMW_SIZES}
    tree["sliced"] = _misaligned(torch.randn(4_097, generator=gen, device=dev) * scale)
    return tree


def _plain_adamw(cfg, grads, state, params, scale):
    """``optim.adamw_update``'s loop of ATen passes on CUDA leaves, with the
    clip ``scale`` given; returns the new state."""
    from repro_torch.optim import adamw as opt

    count = state["count"] + 1
    lr = cfg.lr_at(count)
    cf = count.float()
    bc1, bc2 = 1.0 - torch.pow(cfg.b1, cf), 1.0 - torch.pow(cfg.b2, cf)
    for k in params:
        opt._plain_update(cfg, params[k], grads[k], state["m"][k], state["v"][k], scale, lr,
                          bc1, bc2)
    return {"m": state["m"], "v": state["v"], "count": count}


@pytest.mark.parametrize("wd", [0.0, 0.1], ids=["no_decay", "decay"])
@pytest.mark.parametrize("clip", [None, 1.0, 0.05], ids=["no_clip", "clip_1", "clip_0.05"])
@pytest.mark.parametrize("state_dtype", [None, "bfloat16"], ids=["f32_moments", "bf16_moments"])
def test_adamw_kernels_match_the_plain_loop(cuda_device, state_dtype, clip, wd):
    """Three warm-up-cosine steps over ragged leaves (and a misaligned one),
    the kernels against the loop on the card.  The norm and the clip scale
    against ``global_norm``'s to rtol 1e-6 (partial sums in another order),
    and the same bits from a second call.  The loop then takes the kernels'
    scale: with bf16 moments a float32 ulp of the scale now and then moves a
    moment across a bf16 rounding boundary, and the next step's weight by
    lr / 256.  Weights and float32 moments to rtol 1e-6 / atol 1e-7 (a few
    float32 ulps, should ATen round a pass otherwise), bf16 moments to rtol
    1e-2 with no atol (one bf16 ulp is 2^-8 of the value; the moments are
    ~1e-5 to 1e-8 here, so an atol would pass any moment)."""
    from repro_torch.kernels import adamw_norm
    from repro_torch.models.params import tree_leaves
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, global_norm, warmup_cosine
    from repro_torch.optim.adamw import _clip_scale

    cfg = AdamWConfig(lr=warmup_cosine(1e-2, 2, 6), b1=0.9, b2=0.95, eps=1e-8,
                      weight_decay=wd, clip_norm=clip, state_dtype=state_dtype)
    params = _adamw_tree(cuda_device, 0)
    plain = {k: x.clone() for k, x in params.items()}
    state, plain_state = adamw_init(cfg, params), adamw_init(cfg, plain)
    rtol, atol = (1e-2, 0.0) if state_dtype else (1e-6, 1e-7)
    for step in range(3):
        grads = _adamw_tree(cuda_device, 10 + step, ADAMW_GRAD_SCALE)
        before = launch_counts()
        _, state, stats = adamw_update(cfg, grads, state, params)
        after = launch_counts()
        assert after["adamw_norm"] == before["adamw_norm"] + 1
        assert after["adamw_update"] == before["adamw_update"] + len(params)
        norm, scale = adamw_norm(tree_leaves(grads), clip)
        assert torch.equal(norm, stats["grad_norm"])
        plain_norm = global_norm(grads)
        assert 0.05 < float(plain_norm) < 1.0  # a clip of 0.05 scales, 1.0 does not
        torch.testing.assert_close(norm, plain_norm, rtol=1e-6, atol=0)
        torch.testing.assert_close(scale, _clip_scale(cfg, plain_norm), rtol=1e-6, atol=0)
        plain_state = _plain_adamw(cfg, grads, plain_state, plain, scale)
        assert int(state["count"]) == int(plain_state["count"]) == step + 1
        for k in params:
            torch.testing.assert_close(params[k], plain[k], rtol=1e-6, atol=1e-7)
            for name in ("m", "v"):
                got, want = state[name][k], plain_state[name][k]
                assert got.dtype == want.dtype == (torch.bfloat16 if state_dtype else torch.float32)
                torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


def test_adamw_kernels_take_bf16_masters_with_float32_gradients(cuda_device):
    """bf16 masters with float32 gradients, as ``make_train_step`` hands them
    over (it accumulates bf16 masters' gradients in float32), and bf16
    moments: three steps, the kernels against the loop, weights and moments
    to rtol 1e-2 with no atol (one bf16 ulp is 2^-8 of the value)."""
    from repro_torch.kernels import adamw_norm
    from repro_torch.models.params import tree_leaves
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, warmup_cosine

    def bf16(tree):
        return {k: _misaligned(x.bfloat16()) if k == "sliced" else x.bfloat16()
                for k, x in tree.items()}

    cfg = AdamWConfig(lr=warmup_cosine(1e-2, 2, 6), clip_norm=0.05)
    params = bf16(_adamw_tree(cuda_device, 0))
    plain = {k: x.clone() for k, x in params.items()}
    state, plain_state = adamw_init(cfg, params), adamw_init(cfg, plain)
    for step in range(3):
        grads = _adamw_tree(cuda_device, 10 + step, ADAMW_GRAD_SCALE)
        _, state, _ = adamw_update(cfg, grads, state, params)
        _, scale = adamw_norm(tree_leaves(grads), cfg.clip_norm)
        plain_state = _plain_adamw(cfg, grads, plain_state, plain, scale)
        for k in params:
            for got, want in ((params[k], plain[k]), (state["m"][k], plain_state["m"][k]),
                              (state["v"][k], plain_state["v"][k])):
                assert got.dtype == want.dtype == torch.bfloat16
                torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=0.0)


def test_adamw_counts_only_the_leaves_it_launches_on(cuda_device):
    """An empty CUDA leaf (as a rank's empty shard of an uneven split)
    launches no update and counts in neither ``adamw.fused`` nor
    ``adamw.plain``; every other leaf launches one update and counts once."""
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
    from repro_torch.runtime import spans

    cfg = AdamWConfig(lr=1e-3)
    params = _adamw_tree(cuda_device, 0) | {"empty": torch.empty(0, device=cuda_device)}
    grads = _adamw_tree(cuda_device, 1, 1e-3) | {"empty": torch.empty(0, device=cuda_device)}
    state = adamw_init(cfg, params)
    before = launch_counts()
    spans.clear()
    spans.enable()
    try:
        with spans.step(cuda_device):
            adamw_update(cfg, grads, state, params)
        (st,) = spans.steps()
    finally:
        spans.disable()
        spans.clear()
    after = launch_counts()
    assert st["counters"] == {"adamw.fused": len(params) - 1, "adamw.plain": 0}
    assert {k: after[k] - before[k] for k in after} == (
        dict.fromkeys(after, 0) | {"adamw_norm": 1, "adamw_update": len(params) - 1})


@pytest.mark.parametrize("lr", ["warmup_cosine", "constant"])
def test_adamw_update_never_waits_for_the_device(cuda_device, lr):
    """A whole ``adamw_update`` on CUDA leaves under
    ``torch.cuda.set_sync_debug_mode("error")``: no ``.item()``, no pageable
    copy to the card, nothing that makes the host wait."""
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, warmup_cosine

    cfg = AdamWConfig(lr=warmup_cosine(1e-2, 2, 6) if lr == "warmup_cosine" else 1e-3)
    params = _adamw_tree(cuda_device, 0)
    state = adamw_init(cfg, params)
    _, state, _ = adamw_update(cfg, _adamw_tree(cuda_device, 1, 1e-3), state, params)
    grads = _adamw_tree(cuda_device, 2, 1e-3)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, state, stats = adamw_update(cfg, grads, state, params)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(state["count"]) == 2 and bool(torch.isfinite(stats["grad_norm"]))


@pytest.mark.parametrize("leaf", ["transposed", "float64"])
def test_adamw_kernels_refuse_what_they_do_not_take(cuda_device, leaf):
    """A CUDA leaf the kernels do not take raises before any launch: no
    fallback to the loop."""
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update

    cfg = AdamWConfig(lr=1e-3)
    if leaf == "transposed":
        p = torch.randn(8, 16, device=cuda_device).t()
        g = torch.randn(8, 16, device=cuda_device).t()
        err, match = ValueError, "contiguous"
    else:
        p = torch.randn(64, device=cuda_device, dtype=torch.float64)
        g = torch.randn(64, device=cuda_device, dtype=torch.float64)
        err, match = TypeError, "float32 or bfloat16"
    state = adamw_init(cfg, {"w": p})
    before = launch_counts()
    with pytest.raises(err, match=match):
        adamw_update(cfg, {"w": g}, state, {"w": p})
    assert launch_counts() == before
