"""The port's GraphServer against the JAX package's, on the CPU twins.

Mirrors ``tests/test_graph_server.py``'s serve and batching guarantees:
bucketed results match the COO oracle and are byte-identical to dedicated
serving, one built callable serves every structure in a bucket, ceilings and
oversized requests, eviction, and micro-batching with per-request tenant
attribution where the stacked batch is byte-identical to the batch of one,
and the brownout ladder over a replicated service.  The port's y, brownout
levels and ``stale``/``degraded`` flags are also held against the JAX
GraphServer's on the same requests.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as ref_core  # noqa: E402
import repro.runtime as ref_runtime  # noqa: E402
from repro.kernels.ref import spmv_coo_ref as jax_coo_ref  # noqa: E402
from repro_torch.core import (  # noqa: E402
    PartitionService,
    ReplicaGroup,
    synthetic_bipartite_graph,
)
from repro_torch.kernels.ref import spmv_coo_ref  # noqa: E402
from repro_torch.runtime import BucketPolicy, GraphRequest, GraphServer  # noqa: E402

CPU = "cpu"


@pytest.fixture()
def service():
    with PartitionService() as svc:
        yield svc


def _entry(n_rows, n_cols, nnz_per_row, seed):
    _, rows, cols = synthetic_bipartite_graph(n_rows, n_cols, nnz_per_row, seed=seed)
    rng = np.random.default_rng(seed + 1000)
    vals = rng.standard_normal(rows.shape[0]).astype(np.float32)
    x = rng.standard_normal(n_cols).astype(np.float32)
    return GraphRequest(n_rows, n_cols, rows, cols, vals, x)


def _ref(req: GraphRequest) -> np.ndarray:
    return spmv_coo_ref(req.n_rows, req.rows, req.cols, torch.from_numpy(req.vals),
                        torch.from_numpy(req.x)).numpy()


class TestServe:
    def test_bucketed_matches_ref_across_sweep(self, service):
        server = GraphServer(service, k=4, pad=8, device=CPU, start_batcher=False)
        for n_rows, n_cols, npr in [(64, 64, 3), (96, 80, 4), (150, 150, 5)]:
            for seed in range(2):
                req = _entry(n_rows, n_cols, npr, seed=seed)
                res = server.serve(req)
                assert res.info.bucket is not None
                assert res.y.shape == (n_rows,)  # de-padded
                np.testing.assert_allclose(res.y.numpy(), _ref(req), rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("mode", ["software", "streaming"])
    def test_bucketed_byte_identical_to_dedicated(self, service, mode):
        bucketed = GraphServer(service, k=4, pad=8, mode=mode, device=CPU,
                               start_batcher=False)
        dedicated = GraphServer(service, k=4, pad=8, mode=mode, device=CPU, bucketing=None,
                                start_batcher=False)
        for seed in range(3):
            req = _entry(120, 120, 4, seed=seed)
            res_b, res_d = bucketed.serve(req), dedicated.serve(req)
            assert res_b.info.bucket is not None and res_d.info.bucket is None
            assert torch.equal(res_b.y, res_d.y)  # byte-identical, not just close

    def test_same_bucket_shares_one_build(self, service):
        server = GraphServer(service, k=4, pad=8, device=CPU, start_batcher=False)
        r1 = server.serve(_entry(150, 150, 4, seed=0))
        r2 = server.serve(_entry(150, 150, 4, seed=1))  # distinct structure
        assert r1.info.bucket == r2.info.bucket
        assert not r1.info.kernel_cache_hit and r2.info.kernel_cache_hit
        stats = server.stats()
        assert stats["misses"] == 1 and stats["hits"] >= 1
        assert len(stats["buckets"]) == 1

    def test_exactly_at_ceiling_request_serves(self, service):
        server = GraphServer(service, k=4, pad=8, device=CPU, start_batcher=False)
        req = _entry(256, 256, 3, seed=0)  # n_rows/n_cols exactly at floor
        res = server.serve(req)
        assert res.info.bucket.startswith("r256c256")
        np.testing.assert_allclose(res.y.numpy(), _ref(req), rtol=1e-5, atol=1e-5)

    def test_oversized_falls_back_to_dedicated(self, service):
        pol = BucketPolicy(max_rows=64, max_cols=64, max_nnz=128)
        server = GraphServer(service, k=4, pad=8, device=CPU, bucketing=pol,
                             start_batcher=False)
        req = _entry(96, 96, 4, seed=0)
        res = server.serve(req)
        assert res.info.bucket is None and res.info.batch_size == 1
        np.testing.assert_allclose(res.y.numpy(), _ref(req), rtol=1e-5, atol=1e-5)
        assert server.stats()["buckets"] == {}

    def test_eviction_surfaced_in_metrics(self, service):
        server = GraphServer(service, k=4, pad=8, device=CPU, bucketing=None,
                             compile_cache_entries=1, start_batcher=False)
        server.serve(_entry(64, 64, 3, seed=0))
        server.serve(_entry(64, 64, 3, seed=1))
        cc = server.metrics().compile_cache
        assert cc["misses"] == 2 and cc["evictions"] >= 1
        assert cc["entries"] == 1

    def test_default_device_needs_cuda(self, service, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            GraphServer(service, k=4, pad=8, start_batcher=False)


class TestBatching:
    @pytest.mark.parametrize("mode", ["software", "streaming"])
    def test_mixed_tenant_batch_attribution(self, service, mode):
        reqs = []
        for i, tenant in enumerate(["acme", "globex", "initech"]):
            req = _entry(100, 100, 4, seed=20 + i)
            req.tenant = tenant
            reqs.append(req)
        with GraphServer(service, k=4, pad=8, mode=mode, device=CPU, max_batch=4,
                         max_wait_ms=300.0) as server:
            # Warm plans + the bucket callable so the submits below land
            # inside one batch window.
            warm = {id(r): server.serve(r).y for r in reqs}
            handles = [server.submit(r) for r in reqs]
            results = [h.wait(60.0) for h in handles]
            hist = server.stats()["batch_hist"]
        for req, res in zip(reqs, results):
            assert res.info.tenant == req.tenant  # per-request attribution
            assert res.info.bucket is not None
            assert res.info.batch_size == 3
            # Stacked launch, de-padded: byte-identical to the batch-of-1.
            assert torch.equal(res.y, warm[id(req)])
        assert hist.get(3, 0) >= 1

    def test_submit_after_close_raises(self, service):
        server = GraphServer(service, k=4, pad=8, device=CPU)
        server.close()
        with pytest.raises(RuntimeError):
            server.submit(_entry(64, 64, 3, seed=0))


class TestAgainstJaxServer:
    @pytest.mark.parametrize("mode", ["software", "streaming"])
    @pytest.mark.parametrize("bucketed", [True, False])
    def test_y_matches_jax_graph_server(self, mode, bucketed):
        reqs = [_entry(96, 80, 4, seed=s) for s in range(2)]
        policy = {} if bucketed else {"bucketing": None}
        with ref_core.PartitionService() as ref_svc, PartitionService() as svc:
            ref_server = ref_runtime.GraphServer(ref_svc, k=4, pad=8, mode=mode,
                                                 start_batcher=False, **policy)
            server = GraphServer(svc, k=4, pad=8, mode=mode, device=CPU,
                                 start_batcher=False, **policy)
            for req in reqs:
                ref_req = ref_runtime.GraphRequest(req.n_rows, req.n_cols, req.rows,
                                                   req.cols, req.vals, req.x)
                want = ref_server.serve(ref_req)
                got = server.serve(req)
                assert got.info.fingerprint == want.info.fingerprint
                assert got.info.bucket == want.info.bucket
                np.testing.assert_allclose(got.y.numpy(), np.asarray(want.y),
                                           rtol=1e-5, atol=1e-5)
                oracle = jax_coo_ref(req.n_rows, jnp.asarray(req.rows), jnp.asarray(req.cols),
                                     jnp.asarray(req.vals), jnp.asarray(req.x))
                np.testing.assert_allclose(got.y.numpy(), np.asarray(oracle),
                                           rtol=1e-5, atol=1e-5)


class TestBrownout:
    """The brownout ladder of ``tests/test_graph_server.py``, with every
    level and flag held against the JAX GraphServer on the same sequence."""

    def test_ladder_levels_and_window_recovery(self, service):
        import time

        knobs = dict(brownout_window_s=0.25, brownout_hedge_off=2, brownout_stale_only=4)
        with ref_core.PartitionService() as ref_svc:
            servers = [GraphServer(service, k=4, pad=8, device=CPU, start_batcher=False,
                                   **knobs),
                       ref_runtime.GraphServer(ref_svc, k=4, pad=8, start_batcher=False,
                                               **knobs)]
            levels = [[] for _ in servers]

            def read():
                for got, server in zip(levels, servers):
                    got.append(server.brownout_level())

            read()
            for _ in range(4):
                for server in servers:
                    server._note_rejection()
                read()
            for got, server in zip(levels, servers):
                got.append(server.stats()["brownout_level"])
            time.sleep(0.3)
            read()
        assert levels[0] == [0, 0, 1, 1, 2, 2, 0]
        assert levels[0] == levels[1]

    def test_hedge_rung_disables_and_restores_group_hedging(self):
        import time

        knobs = dict(brownout_window_s=0.25, brownout_hedge_off=1, brownout_stale_only=99)
        req = _entry(96, 96, 3, seed=0)
        ref_req = ref_runtime.GraphRequest(req.n_rows, req.n_cols, req.rows, req.cols,
                                           req.vals, req.x)
        with ReplicaGroup(2) as g, ref_core.ReplicaGroup(2) as rg:
            server = GraphServer(service=g, k=4, device=CPU, start_batcher=False, **knobs)
            ref_server = ref_runtime.GraphServer(service=rg, k=4, start_batcher=False, **knobs)
            hedges = []
            for step in range(3):
                if step == 1:
                    server._note_rejection()
                    ref_server._note_rejection()
                if step == 2:
                    time.sleep(0.3)
                got, want = server.serve(req), ref_server.serve(ref_req)
                np.testing.assert_allclose(got.y.numpy(), np.asarray(want.y),
                                           rtol=1e-5, atol=1e-5)
                hedges.append((g.hedge, rg.hedge))
        assert hedges == [(True, True), (False, False), (True, True)]

    def test_stale_only_serves_cached_degraded_and_rejects_cold(self):
        from repro_torch.core import AdmissionRejectedError

        knobs = dict(brownout_window_s=5.0, brownout_hedge_off=1, brownout_stale_only=2,
                     brownout_priority_floor=1)

        def pair(seed, priority=None):
            req = _entry(96, 96, 3, seed=seed)
            req.priority = priority
            return req, ref_runtime.GraphRequest(req.n_rows, req.n_cols, req.rows, req.cols,
                                                 req.vals, req.x, priority=priority)

        with ReplicaGroup(2, hedge=False) as g, ref_core.ReplicaGroup(2, hedge=False) as rg:
            server = GraphServer(service=g, k=4, device=CPU, start_batcher=False, **knobs)
            ref_server = ref_runtime.GraphServer(service=rg, k=4, start_batcher=False, **knobs)

            def both(req, ref_req):
                got, want = server.serve(req), ref_server.serve(ref_req)
                assert (got.info.stale, got.info.degraded) == (want.info.stale,
                                                                want.info.degraded)
                np.testing.assert_allclose(got.y.numpy(), np.asarray(want.y),
                                           rtol=1e-5, atol=1e-5)
                return got

            hot = pair(1)  # default priority 0 < floor
            res = both(*hot)
            assert not res.info.degraded
            for _ in range(2):
                server._note_rejection()
                ref_server._note_rejection()
            res2 = both(*hot)
            assert res2.info.degraded and res2.info.as_dict()["degraded"] is True
            assert torch.equal(res2.y, res.y)
            cold, ref_cold = pair(2)
            with pytest.raises(AdmissionRejectedError) as ei:
                server.serve(cold)
            with pytest.raises(ref_core.AdmissionRejectedError) as ref_ei:
                ref_server.serve(ref_cold)
            assert ei.value.reason == ref_ei.value.reason == "brownout"
            assert ei.value.retry_after_s == ref_ei.value.retry_after_s == 5.0
            assert not both(*pair(3, priority=1)).info.degraded
            stats, ref_stats = server.stats(), ref_server.stats()
            for key in ("degraded_serves", "brownout_rejects", "brownout_level"):
                assert stats[key] == ref_stats[key], key
            assert (stats["degraded_serves"], stats["brownout_rejects"],
                    stats["brownout_level"]) == (1, 1, 2)
