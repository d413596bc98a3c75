"""CUDA kernels against their plain twins, and byte-identity on the card.

Every test here needs a CUDA device and skips without one.  The file imports
no JAX, so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (  # noqa: E402
    PartitionService,
    build_pack_plan,
    edge_partition,
    synthetic_bipartite_graph,
)
from repro_torch.kernels.ops import ep_spmv  # noqa: E402
from repro_torch.runtime import GraphRequest, GraphServer  # noqa: E402

K = importlib.import_module("repro_torch.kernels.ep_spmv")

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _problem(n_rows, n_cols, nnz_per_row, k, seed=0):
    edges, rows, cols = synthetic_bipartite_graph(n_rows, n_cols, nnz_per_row, seed=seed)
    res = edge_partition(edges, k, method="ep", seed=seed)
    plan = build_pack_plan(n_rows, n_cols, rows, cols, res.labels, k, pad=8)
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
def test_card_bits_equal_cpu_twin(cuda_device, mode):
    plan, vals, x = _problem(64, 64, 4, 4)
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
