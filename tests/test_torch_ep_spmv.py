"""The port's SpMV kernels against the JAX package's Pallas kernels.

Plans are built by the reference partitioner and carried into the port with
``PackPlan.from_arrays``; values and x come from a numpy seed and go to both
packages, so the kernels are compared apart from the copied partitioner.
Here on the CPU each wrapper runs its plain PyTorch twin; the CUDA kernels
are held against the twins on the card by ``tests/test_torch_gpu.py``.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import build_pack_plan, edge_partition  # noqa: E402
from repro.core.graph import synthetic_bipartite_graph  # noqa: E402
from repro.kernels import ep_spmv as jax_ep_spmv  # noqa: E402
from repro.kernels import spmv_software_cache as jax_software_cache  # noqa: E402
from repro.kernels import spmv_streaming as jax_streaming  # noqa: E402
from repro.kernels import spmv_streaming_batched as jax_streaming_batched  # noqa: E402
from repro_torch.core import PackPlan  # noqa: E402
from repro_torch.kernels.ops import (  # noqa: E402
    BucketSpec,
    ep_spmv,
    make_ep_spmv_fn,
    pad_plan_operands,
    stack_combine_tables,
)
from repro_torch.kernels.ref import spmv_coo_ref  # noqa: E402
from test_torch_gpu import STREAM_EDGES, synthetic_tiles  # noqa: E402

# The module, not the ``kernels.ep_spmv`` function that shadows its name.
K = importlib.import_module("repro_torch.kernels.ep_spmv")
GRID = [(64, 64, 4, 4), (128, 96, 3, 8), (33, 47, 5, 3)]
TOL = {np.float32: 1e-5, np.float64: 1e-4}  # the reference's own tolerances


def _problem(n_rows, n_cols, nnz_per_row, k, seed=0, dtype=np.float32, pad=8):
    """Reference-built plan, the port's copy of it, and seeded values and x."""
    edges, rows, cols = synthetic_bipartite_graph(n_rows, n_cols, nnz_per_row, seed=seed)
    res = edge_partition(edges, k, method="ep", seed=seed)
    ref_plan = build_pack_plan(n_rows, n_cols, rows, cols, res.labels, k, pad=pad)
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal(rows.shape[0]).astype(dtype)
    x = rng.standard_normal(n_cols).astype(dtype)
    return PackPlan.from_arrays(ref_plan), ref_plan, rows, cols, vals, x


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


class TestPartialsMatchPallas:
    @pytest.mark.parametrize("n_rows,n_cols,nnz,k", GRID)
    @pytest.mark.parametrize("mode", ["software", "streaming"])
    def test_partials(self, n_rows, n_cols, nnz, k, mode):
        plan, _, _, _, vals, x = _problem(n_rows, n_cols, nnz, k)
        vp = plan.pack_values(vals)
        if mode == "software":
            xp = x[plan.x_gidx]
            want = jax_software_cache(jnp.asarray(vp), jnp.asarray(plan.x_lidx),
                                      jnp.asarray(plan.y_lidx), jnp.asarray(xp),
                                      plan.y_max, interpret=True)
            got = K.spmv_software_cache(_t(vp), _t(plan.x_lidx), _t(plan.y_lidx), _t(xp),
                                        plan.y_max)
        else:
            xg = np.take_along_axis(plan.x_gidx, plan.x_lidx, axis=1)
            want = jax_streaming(jnp.asarray(vp), jnp.asarray(xg), jnp.asarray(plan.y_lidx),
                                 jnp.asarray(x), plan.y_max, interpret=True)
            got = K.spmv_streaming(_t(vp), _t(xg), _t(plan.y_lidx), _t(x), plan.y_max)
        assert got.shape == (k, plan.y_max)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)

    def test_batched_with_all_zero_slot(self):
        plan, _, _, _, vals, _ = _problem(64, 64, 4, 4)
        rng = np.random.default_rng(7)
        b = 3
        vp = np.stack([plan.pack_values(vals * (i + 1)) for i in range(b)])
        vp[1] = 0.0  # an unused batch slot: all-zero operands
        xg = np.stack([np.take_along_axis(plan.x_gidx, plan.x_lidx, axis=1)] * b)
        xg[1] = 0
        yl = np.stack([plan.y_lidx] * b)
        yl[1] = 0
        x = rng.standard_normal((b, plan.n_cols)).astype(np.float32)
        x[1] = 0.0
        want = jax_streaming_batched(jnp.asarray(vp), jnp.asarray(xg), jnp.asarray(yl),
                                     jnp.asarray(x), plan.y_max, interpret=True)
        got = K.spmv_streaming_batched(_t(vp), _t(xg), _t(yl), _t(x), plan.y_max)
        assert got.shape == (b, plan.k, plan.y_max)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
        assert torch.equal(got[1], torch.zeros_like(got[1]))  # exactly 0


class TestStreamingEdgesMatchPallas:
    """The streaming twins on the shapes that the card tests put to the
    redesigned kernel (tests/test_torch_gpu.py), against the Pallas kernels."""

    @pytest.mark.parametrize("case", ["hub_run_over_chunk", "e_max_4225_y_max_513",
                                      "empty_tiles_zero_slot"])
    def test_synthetic_tiles(self, case):
        b, k, e_max, y_max, n_cols, counts, occupied, hub = STREAM_EDGES[case]
        v, xg, yl, x, seg = synthetic_tiles(b, k, e_max, y_max, n_cols, counts, occupied,
                                            np.float32, seed=len(case), hub=hub)
        j = [jnp.asarray(a.numpy()) for a in (v, xg, yl, x)]
        want = jax_streaming_batched(*j, y_max, interpret=True)
        got = K.spmv_streaming_batched(v, xg, yl, x, y_max, seg=seg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
        for i in range(b):
            want = jax_streaming(*(a[i] for a in j), y_max, interpret=True)
            got = K.spmv_streaming(v[i], xg[i], yl[i], x[i], y_max, seg=seg[i])
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("pad", [1, 3])
    def test_odd_pad_plans(self, pad):
        plan, ref_plan, _, _, vals, x = _problem(301, 257, 7, 5, seed=pad, pad=pad)
        assert plan.e_max % 4 != 0  # rows start off the 16-byte grid on the card
        vp = plan.pack_values(vals)
        xg = np.take_along_axis(plan.x_gidx, plan.x_lidx, axis=1)
        want = jax_streaming(jnp.asarray(vp), jnp.asarray(xg), jnp.asarray(plan.y_lidx),
                             jnp.asarray(x), plan.y_max, interpret=True)
        got = K.spmv_streaming(_t(vp), _t(xg), _t(plan.y_lidx), _t(x), plan.y_max)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
        xb = np.stack([x, -2 * x])
        stacked = [np.stack([a, a]) for a in (vp, xg, plan.y_lidx)]
        want = jax_streaming_batched(*map(jnp.asarray, stacked), jnp.asarray(xb), plan.y_max,
                                     interpret=True)
        got = K.spmv_streaming_batched(*map(_t, stacked), _t(xb), plan.y_max)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
        y = ep_spmv(x, plan, vals, mode="streaming", device="cpu")
        np.testing.assert_allclose(y.numpy(), np.asarray(jax_ep_spmv(
            jnp.asarray(x), ref_plan, vals, mode="streaming")), rtol=1e-5, atol=1e-5)


class TestEpSpmvMatchesReference:
    @pytest.mark.parametrize("n_rows,n_cols,nnz,k", GRID)
    @pytest.mark.parametrize("mode", ["software", "streaming"])
    def test_matches_jax_and_coo_ref(self, n_rows, n_cols, nnz, k, mode):
        plan, ref_plan, rows, cols, vals, x = _problem(n_rows, n_cols, nnz, k)
        y = ep_spmv(x, plan, vals, mode=mode, device="cpu")
        want = jax_ep_spmv(jnp.asarray(x), ref_plan, vals, mode=mode)
        ref = spmv_coo_ref(n_rows, rows, cols, _t(vals), _t(x))
        assert y.shape == (n_rows,)
        np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(y.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    @pytest.mark.parametrize("mode", ["software", "streaming"])
    def test_dtypes(self, dtype, mode):
        plan, ref_plan, _, _, vals, x = _problem(64, 64, 4, 4, dtype=dtype)
        y = ep_spmv(x, plan, vals, mode=mode, device="cpu")
        assert y.dtype == torch.from_numpy(vals).dtype
        want = jax_ep_spmv(jnp.asarray(x), ref_plan, vals, mode=mode)
        tol = TOL[dtype]
        np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=tol, atol=tol)

    def test_fn_reusable_and_linear(self):
        plan, _, _, _, vals, x = _problem(64, 64, 4, 4)
        fn = make_ep_spmv_fn(plan, vals, mode="software", device="cpu")
        y1 = fn(x)
        y2 = fn(x * 2)
        np.testing.assert_allclose(y2.numpy(), 2 * y1.numpy(), rtol=1e-5)

    def test_rejects_reference_plan_object(self):
        edges, rows, cols = synthetic_bipartite_graph(32, 32, 2, seed=0)
        res = edge_partition(edges, 2, method="ep", seed=0)
        ref_plan = build_pack_plan(32, 32, rows, cols, res.labels, 2, pad=8)
        with pytest.raises(TypeError):
            make_ep_spmv_fn(ref_plan, np.ones(rows.shape[0], np.float32), device="cpu")


class TestOrders:
    def test_tile_order_sorts_stably_by_y_slot(self):
        plan, _, _, _, vals, _ = _problem(128, 96, 3, 8)
        vp = _t(plan.pack_values(vals))
        # A wrapper given no runs sorts every slot, padding included, stably.
        seg, got_v, got_x = K.sort_by_y_slot(_t(plan.y_lidx), plan.y_max, vp, _t(plan.x_lidx))
        assert seg.dtype == torch.int32 and seg.shape == (plan.k, plan.y_max + 1)
        for p in range(plan.k):
            want = np.argsort(plan.y_lidx[p], kind="stable")
            assert np.array_equal(got_v[p].numpy(), vp[p].numpy()[want])
            assert np.array_equal(got_x[p].numpy(), plan.x_lidx[p][want])
            counts = np.bincount(plan.y_lidx[p], minlength=plan.y_max)
            assert np.array_equal(np.diff(seg[p].numpy()), counts)
            assert seg[p, 0] == 0 and seg[p, -1] == plan.e_max
        # The plan's own tasks are packed in y order, but its padding (y slot
        # 0) is not: tile_order takes the packed tasks only.
        with pytest.raises(ValueError, match="sorted by y_lidx"):
            K.tile_order(_t(plan.y_lidx), plan.y_max)
        sorted_y = np.sort(plan.y_lidx, axis=1, kind="stable")
        assert torch.equal(K.tile_order(_t(sorted_y), plan.y_max), seg)

    def test_tile_order_leaves_padding_out_of_every_run(self):
        plan, _, _, _, vals, x = _problem(128, 96, 3, 8)
        valid = _t(plan.edge_valid)
        seg = K.tile_order(_t(plan.y_lidx), plan.y_max, valid)
        assert torch.equal(seg[:, -1], valid.sum(1).int())
        for p in range(plan.k):
            n = int(seg[p, -1])
            assert plan.edge_valid[p, :n].all()  # the tasks come first
            counts = np.bincount(plan.y_lidx[p, :n], minlength=plan.y_max)
            assert np.array_equal(np.diff(seg[p].numpy()), counts)
        # Padding holds zero values: leaving it out changes no sum.
        vp, xp = _t(plan.pack_values(vals)), _t(x[plan.x_gidx])
        args = (vp, _t(plan.x_lidx), _t(plan.y_lidx), xp, plan.y_max)
        assert torch.equal(K.spmv_software_cache(*args, seg=seg),
                           K.spmv_software_cache(*args))

    def test_combine_table_drops_sentinel_and_keeps_order(self):
        plan, *_ = _problem(33, 47, 5, 3)
        row_ptr, src = K.combine_table(_t(plan.y_gidx), plan.n_rows)
        flat = plan.y_gidx.reshape(-1)
        assert row_ptr.shape == (plan.n_rows + 1,)
        assert int(row_ptr[-1]) == int((flat < plan.n_rows).sum())
        for r in range(plan.n_rows):
            run = src[row_ptr[r]:row_ptr[r + 1]].numpy()
            assert np.array_equal(run, np.flatnonzero(flat == r))  # ascending

    def test_stacked_tables_equal_table_of_stack(self):
        spec = BucketSpec(k=4, n_rows=256, n_cols=256, e_max=64, x_max=64, y_max=64, batch=3)
        ops = []
        for seed in (0, 1):
            plan, _, _, _, vals, _ = _problem(64, 64, 4, 4, seed=seed)
            ops.append(pad_plan_operands(plan, vals, spec))
        tables = [(_t(o.row_ptr), _t(o.src)) for o in ops] + [None]
        row_ptr, src = stack_combine_tables(tables, spec.n_rows, spec.k * spec.y_max)
        yg = np.full((3, spec.k, spec.y_max), spec.n_rows, np.int32)
        yg[0], yg[1] = ops[0].y_gidx, ops[1].y_gidx
        want_ptr, want_src = K.combine_table(_t(yg), spec.n_rows)
        assert torch.equal(row_ptr, want_ptr) and torch.equal(src, want_src)

    def test_software_cache_rejects_x_tile_over_shared_memory(self):
        rows, e_max, y_max = 1, 8, 8
        x_max = K.SMEM_LIMIT_BYTES // 4 + 1
        with pytest.raises(ValueError, match="shared-memory"):
            K.spmv_software_cache(torch.zeros(rows, e_max),
                                  torch.zeros(rows, e_max, dtype=torch.int32),
                                  torch.zeros(rows, e_max, dtype=torch.int32),
                                  torch.zeros(rows, x_max), y_max)
