"""CUDA kernels against their plain twins, byte-identity, and the LM serving and
training paths on the card.

Every test here needs a CUDA device and skips without one.  The file imports
no JAX, so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import importlib
import importlib.util
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
    (UTMALDG) instructions."""
    for name in ("flash_attention", "moe_mlp"):
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
                                  "jamba-1.5-large-398b", "seamless-m4t-medium"])
def test_reduced_train_step_on_card_matches_cpu(cuda_device, no_tf32, arch):
    """One step at two microbatches on the card against the CPU, the same
    weights: the loss, each gradient leaf (relative to its largest
    magnitude) and the updated weights within 1e-4 (a learning rate of 1e-5
    keeps Adam's sign-normalised first update from amplifying rounding)."""
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
    assert launch_counts() == before  # the train path runs no kernel
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
