"""The port's ReplicaGroup: failover, hedging, stale serve and breakers.

Mirrors ``tests/test_replica.py`` on ``repro_torch.core`` (a verbatim copy
of ``src/repro/core/replica.py``), driven by the same deterministic
:class:`FaultInjector` schedules.  With two healthy replicas the first
request's primary lane lands on ``r1``; where a schedule stalls both
replicas, the primary is read from the injector's event log.  Every wait
carries its own timeout.  The port's ``GraphServer`` over a port group is
also held against the JAX package's ``GraphServer`` over a reference group
on the same requests: y within 1e-5, the same ``stale`` flags.
"""
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as ref_core  # noqa: E402
import repro.runtime as ref_runtime  # noqa: E402
from repro_torch.core import (  # noqa: E402
    AdmissionRejectedError,
    FaultInjector,
    PartitionService,
    ReplicaExhaustedError,
    ReplicaGroup,
    ServiceClosedError,
    affinity_graph_from_coo,
    synthetic_mesh_graph,
    synthetic_random_graph,
)
from repro_torch.runtime import GraphRequest, GraphServer  # noqa: E402


def _coo(n_rows, n_cols, shift, nnz_per_row=3):
    """COO with exactly ``n_rows * nnz_per_row`` entries; each ``shift``
    gives another structure of the same shape and nnz."""
    rows = np.repeat(np.arange(n_rows), nnz_per_row)
    offs = np.tile(np.arange(nnz_per_row) * (shift + 1) + shift, n_rows)
    cols = (rows + offs) % n_cols
    return rows.astype(np.int64), cols.astype(np.int64)


def _wait(pred, timeout=10.0, dt=0.005):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred():
            return True
        time.sleep(dt)
    return pred()


def _primary_rid(injector, timeout=10.0):
    """The replica that dispatched the first (stalled) job."""
    assert _wait(lambda: any(e[0] == "stall" for e in injector.events), timeout)
    return next(e[1] for e in injector.events if e[0] == "stall")


def _other(group, rid):
    return next(r for r in group.replica_ids() if r != rid)


def _join_all(threads, timeout=60.0):
    for t in threads:
        t.join(timeout)
    assert not any(t.is_alive() for t in threads)


class TestBasics:
    def test_cold_then_warm_and_anti_entropy(self):
        with ReplicaGroup(2, sync_interval_s=0.0) as g:
            e = synthetic_random_graph(96, 300, seed=1)
            t1 = g.submit(e, 4)
            sp = t1.result(60)
            assert not t1.cache_hit and not t1.stale
            assert t1.replica in g.replica_ids()
            t2 = g.submit(e, 4)
            assert t2.cache_hit and t2.done()
            assert t2.result(5) is sp
            g.pump()
            for rid in g.replica_ids():
                assert g._by_rid[rid].svc.plan_cache.peek(sp.fingerprint) is not None
            rm = g.replica_metrics()
            assert rm.lost == 0 and rm.store_publishes == 1

    def test_submit_after_close_fails_typed(self):
        g = ReplicaGroup(2)
        g.close()
        t = g.submit(synthetic_mesh_graph(12, seed=0), 4)
        with pytest.raises(ServiceClosedError):
            t.result(5)

    def test_plan_equals_reference_group_plan(self):
        e_port = synthetic_random_graph(128, 500, seed=4)
        e_ref = ref_core.synthetic_random_graph(128, 500, seed=4)
        with ReplicaGroup(2) as g, ref_core.ReplicaGroup(2) as rg:
            sp, rsp = g.get(e_port, 4, timeout=60), rg.get(e_ref, 4, timeout=60)
        assert sp.fingerprint == rsp.fingerprint
        np.testing.assert_array_equal(sp.result.labels, rsp.result.labels)


class TestFailover:
    def test_kill_primary_midflight_fails_over(self):
        inj = (FaultInjector().stall_jobs("r0", 0.4, first=0, last=0)
               .stall_jobs("r1", 0.4, first=0, last=0))
        with ReplicaGroup(2, injector=inj, hedge=False) as g:
            t = g.submit(synthetic_random_graph(128, 500, seed=4), 4)
            primary = _primary_rid(inj)
            g.kill(primary)
            sp = t.result(60)
            assert sp.result.k == 4
            assert t.replica == _other(g, primary)
            assert t.retries >= 1
            rm = g.replica_metrics()
            assert rm.failovers >= 1 and rm.lost == 0
            row = next(r for r in rm.replicas if r.replica == primary)
            assert row.state == "crashed" and row.weight == 0.0
            assert row.failovers_from >= 1

    def test_queued_tickets_on_killed_replica_fail_over(self):
        inj = (FaultInjector().stall_jobs("r0", 0.3, first=0, last=0)
               .stall_jobs("r1", 0.3, first=0, last=0))
        with ReplicaGroup(2, injector=inj, hedge=False) as g:
            graphs = [synthetic_mesh_graph(14 + 2 * i, seed=i) for i in range(4)]
            tickets = [g.submit(e, 4) for e in graphs]
            g.kill(_primary_rid(inj))
            plans = [t.result(60) for t in tickets]
            assert all(p.result.k == 4 for p in plans)
            assert g.replica_metrics().lost == 0

    def test_stalled_primary_goes_suspect_and_drains_routing(self):
        inj = FaultInjector().stall_jobs("r1", 0.8, first=0, last=0)
        with ReplicaGroup(2, injector=inj, hedge=False, heartbeat_deadline_s=0.15) as g:
            t = g.submit(synthetic_random_graph(128, 500, seed=5), 4)
            assert _primary_rid(inj) == "r1"
            assert _wait(lambda: "r1" in g.registry.dead, timeout=10.0)
            sp = t.result(60)
            assert sp.result.k == 4 and t.replica == "r0"
            rm = g.replica_metrics()
            assert rm.failovers >= 1 and rm.lost == 0
            assert _wait(lambda: (g.pump(), "r1" not in g.registry.dead)[1], timeout=10.0)

    def test_dropped_heartbeats_mark_suspect_then_recover_on_beat(self):
        inj = FaultInjector().drop_heartbeats("r0", 8).drop_heartbeats("r1", 8)
        with ReplicaGroup(2, injector=inj, heartbeat_deadline_s=0.05) as g:
            def states():
                g.pump()
                return {r.replica: r.state for r in g.replica_metrics().replicas}
            assert _wait(lambda: all(s == "suspect" for s in states().values()),
                         timeout=10.0, dt=0.01)
            assert _wait(lambda: all(s == "healthy" for s in states().values()),
                         timeout=10.0, dt=0.01)
            assert any(e[0] == "drop_beat" for e in inj.events)

    def test_coalesced_ticket_failover_multiple_waiters(self):
        inj = FaultInjector().stall_jobs("r0", 0.4).stall_jobs("r1", 0.4)
        with ReplicaGroup(2, injector=inj, hedge=False) as g:
            e = synthetic_random_graph(150, 600, seed=6)
            results = []
            ts = [threading.Thread(target=lambda: results.append(g.get(e, 4, timeout=60)))
                  for _ in range(3)]
            for th in ts:
                th.start()
            primary = _primary_rid(inj)
            assert _wait(lambda: g.replica_metrics().coalesced == 2)
            g.kill(primary)
            _join_all(ts)
            assert len(results) == 3
            assert results[0] is results[1] is results[2]
            rm = g.replica_metrics()
            assert rm.failovers == 1
            assert rm.submitted == 3 and rm.resolved == 3 and rm.lost == 0

    def test_retry_budget_exhaustion_raises_typed_error(self):
        with ReplicaGroup(2, retry_budget=2, backoff_base_s=0.001, hedge=False) as g:
            def boom(*a, **kw):
                raise RuntimeError("injected submit failure")
            for rid in g.replica_ids():
                g._by_rid[rid].svc.submit = boom
            t = g.submit(synthetic_mesh_graph(16, seed=7), 4)
            with pytest.raises(ReplicaExhaustedError, match="budget"):
                t.result(30)
            rm = g.replica_metrics()
            assert rm.failed == 1 and rm.retries >= 2 and rm.lost == 0


class TestHedging:
    def test_hedge_wins_over_straggler(self):
        inj = FaultInjector().stall_jobs("r1", 0.6, first=0, last=0)
        with ReplicaGroup(2, injector=inj, hedge_delay_s=0.03) as g:
            t0 = time.monotonic()
            t = g.submit(synthetic_random_graph(128, 500, seed=8), 4)
            sp = t.result(60)
            assert sp.result.k == 4
            assert t.hedged and t.replica == "r0"
            assert time.monotonic() - t0 < 0.55
            rm = g.replica_metrics()
            assert rm.hedges_fired == 1 and rm.hedges_won == 1
            assert rm.hedges_lost == 0 and rm.lost == 0

    def test_hedge_fires_but_primary_wins(self):
        inj = (FaultInjector().stall_jobs("r0", 0.3, first=0, last=0)
               .stall_jobs("r1", 0.3, first=0, last=0))
        with ReplicaGroup(2, injector=inj, hedge_delay_s=0.05) as g:
            t = g.submit(synthetic_random_graph(150, 600, seed=9), 4)
            sp = t.result(60)
            assert sp.result.k == 4
            assert t.hedged and t.replica == "r1"
            rm = g.replica_metrics()
            assert rm.hedges_fired == 1
            assert rm.hedges_won == 0 and rm.hedges_lost == 1
            assert rm.store_publishes == 1 and len(g.store) == 1
            m = g._by_rid["r0"].svc.metrics()
            assert m.cancelled_queued + m.cancelled_inflight >= 1

    def test_hedge_delay_derives_from_p99(self):
        with ReplicaGroup(2, hedge_min_delay_s=0.02, hedge_p99_factor=2.0) as g:
            assert g._hedge_delay() == pytest.approx(0.02)
            with g._lock:
                for _ in range(100):
                    g._latencies.append(0.05)
            assert g._hedge_delay() == pytest.approx(0.10)

    def test_hedge_clamped_to_request_deadline(self):
        inj = FaultInjector().stall_jobs("r1", 0.3, first=0, last=0)
        with ReplicaGroup(2, injector=inj, hedge_delay_s=0.02, hedge_min_delay_s=10.0) as g:
            t = g.submit(synthetic_random_graph(128, 500, seed=21), 4, timeout=5.0)
            assert t.result(60).result.k == 4
            assert not t.hedged and t.replica == "r1"
            assert g.replica_metrics().hedges_fired == 0

    def test_no_hedge_when_single_healthy_replica(self):
        inj = FaultInjector().stall_jobs("r0", 0.2, first=0, last=0)
        with ReplicaGroup(2, injector=inj, hedge_delay_s=0.0) as g:
            g.kill("r1")
            assert g.get(synthetic_mesh_graph(20, seed=10), 4, timeout=60).result.k == 4
            assert g.replica_metrics().hedges_fired == 0


class TestStaleServe:
    def test_all_down_serves_freshest_compatible_plan_stale(self):
        with ReplicaGroup(2, retry_budget=1, backoff_base_s=0.001) as g:
            n = 96
            rows_a, cols_a = _coo(n, n, shift=0)
            sp_a = g.get_spmv_plan(n, n, rows_a, cols_a, 4, timeout=60)
            for rid in g.replica_ids():
                g.kill(rid)
            rows_b, cols_b = _coo(n, n, shift=5)
            tb = g.submit(affinity_graph_from_coo(n, n, rows_b, cols_b), 4,
                          coo=(n, n, rows_b, cols_b))
            assert tb.result(30) is sp_a and tb.stale
            assert g.replica_metrics().stale_serves == 1
            ta = g.submit(affinity_graph_from_coo(n, n, rows_a, cols_a), 4,
                          coo=(n, n, rows_a, cols_a))
            assert ta.cache_hit and not ta.stale
            assert ta.result(5) is sp_a

    def test_incompatible_shape_is_never_served_stale(self):
        with ReplicaGroup(2, retry_budget=1, backoff_base_s=0.001) as g:
            rows, cols = _coo(96, 96, shift=0)
            g.get_spmv_plan(96, 96, rows, cols, 4, timeout=60)
            for rid in g.replica_ids():
                g.kill(rid)
            rows2, cols2 = _coo(64, 64, shift=0)
            t = g.submit(affinity_graph_from_coo(64, 64, rows2, cols2), 4,
                         coo=(64, 64, rows2, cols2))
            with pytest.raises(ReplicaExhaustedError):
                t.result(30)

    def test_all_down_update_serves_base_stale(self):
        with ReplicaGroup(2) as g:
            sp = g.get(synthetic_random_graph(200, 800, seed=13), 4, timeout=60)
            for rid in g.replica_ids():
                g.kill(rid)
            t = g.update_async(sp.fingerprint, 4, insert_u=np.array([0]),
                               insert_v=np.array([3]))
            assert t.result(30) is sp and t.stale

    def test_all_down_nothing_compatible_raises_exhausted(self):
        with ReplicaGroup(2, retry_budget=1, backoff_base_s=0.001) as g:
            for rid in g.replica_ids():
                g.kill(rid)
            t = g.submit(synthetic_mesh_graph(18, seed=14), 4)
            with pytest.raises(ReplicaExhaustedError):
                t.result(30)

    def test_stale_disabled_raises_even_with_store(self):
        with ReplicaGroup(2, retry_budget=1, backoff_base_s=0.001, allow_stale=False) as g:
            sp = g.get(synthetic_random_graph(96, 300, seed=15), 4, timeout=60)
            for rid in g.replica_ids():
                g.kill(rid)
            t = g.update_async(sp.fingerprint, 4, insert_u=np.array([0]),
                               insert_v=np.array([1]))
            with pytest.raises(ReplicaExhaustedError):
                t.result(30)


class TestRequestDeadline:
    def test_deadline_beats_retry_budget(self):
        inj = FaultInjector(seed=0).stall_jobs("r0", 0.6).stall_jobs("r1", 0.6)
        with ReplicaGroup(2, injector=inj, hedge=False, retry_budget=100,
                          backoff_base_s=0.001, allow_stale=False) as g:
            t = g.submit(synthetic_mesh_graph(18, seed=3), 4, timeout=0.15)
            t0 = time.monotonic()
            with pytest.raises(ReplicaExhaustedError, match="deadline"):
                t.result(30)
            assert time.monotonic() - t0 < 0.5


class TestOverloadBreakers:
    def test_sustained_rejections_trip_breaker_fail_fast_then_recover(self):
        g = ReplicaGroup(1, hedge=False, allow_stale=False, retry_budget=1,
                         backoff_base_s=0.001, backoff_cap_s=0.002,
                         breaker_failures=4, breaker_cooldown_s=0.25,
                         workers=1, max_queue_depth=1)
        gate = threading.Event()
        try:
            started = threading.Event()
            sched = g._replicas[0].svc.scheduler

            def hook(_key):
                started.set()
                gate.wait(10)

            sched.pre_job_hook = hook
            graphs = [synthetic_mesh_graph(14 + 2 * i, seed=30 + i) for i in range(5)]
            t_run = g.submit(graphs[0], 4)
            assert started.wait(10)
            t_q = g.submit(graphs[1], 4)
            assert _wait(lambda: sched.metrics_snapshot()
                         .admission["occupancy"].get("default", 0) == 1)
            t = g.submit(graphs[2], 4)
            with pytest.raises(AdmissionRejectedError) as ei:
                t.result(30)
            assert ei.value.reason == "queue_full" and ei.value.retry_after_s > 0
            t = g.submit(graphs[3], 4)
            with pytest.raises(AdmissionRejectedError) as ei:
                t.result(30)
            assert ei.value.reason == "breaker_open"
            assert g.breaker_states()["r0"] == "open"
            t = g.submit(graphs[4], 4)
            with pytest.raises(AdmissionRejectedError) as ei:
                t.result(30)
            assert ei.value.reason == "breaker_open" and ei.value.retry_after_s > 0
            row = g.replica_metrics().replicas[0]
            assert row.rejections == 4
            assert row.breakers_open == 1 and row.breaker_trips >= 1
            gate.set()
            t_run.result(30)
            t_q.result(30)
            time.sleep(0.3)
            assert g.get(graphs[4], 4, timeout=30).result.k == 4
            assert g.breaker_states()["r0"] == "closed"
        finally:
            gate.set()
            g.close()


def _request_pair(n, shift, seed):
    rows, cols = _coo(n, n, shift=shift)
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal(rows.shape[0]).astype(np.float32)
    x = rng.standard_normal(n).astype(np.float32)
    return (GraphRequest(n, n, rows, cols, vals, x),
            ref_runtime.GraphRequest(n, n, rows, cols, vals, x))


class TestGraphServerAgainstJax:
    @pytest.mark.parametrize("mode", ["software", "streaming"])
    def test_y_and_stale_flags_match_jax_server_over_groups(self, mode):
        """The same requests through the port's GraphServer over a port group
        and the JAX GraphServer over a reference group: equal fingerprints,
        y within 1e-5, and after every replica is killed the same stale
        serve of a same-shape request."""
        n = 96
        with ReplicaGroup(2, retry_budget=1, backoff_base_s=0.001) as g, \
                ref_core.ReplicaGroup(2, retry_budget=1, backoff_base_s=0.001) as rg:
            server = GraphServer(service=g, k=4, pad=8, mode=mode, device="cpu",
                                 start_batcher=False)
            ref_server = ref_runtime.GraphServer(service=rg, k=4, pad=8, mode=mode,
                                                 start_batcher=False)

            def both(shift, seed):
                req, ref_req = _request_pair(n, shift, seed)
                got, want = server.serve(req), ref_server.serve(ref_req)
                assert got.info.fingerprint == want.info.fingerprint
                assert (got.info.stale, got.info.degraded) == (want.info.stale,
                                                                want.info.degraded)
                np.testing.assert_allclose(got.y.numpy(), np.asarray(want.y),
                                           rtol=1e-5, atol=1e-5)
                return got

            for seed in range(2):
                assert not both(0, seed).info.stale
            assert both(2, 5).info.cache_hit is False
            for group in (g, rg):
                for rid in group.replica_ids():
                    group.kill(rid)
            # Same shape and nnz, another structure: served from a stale plan.
            assert both(5, 7).info.stale
            assert g.replica_metrics().stale_serves == rg.replica_metrics().stale_serves

    def test_stale_disabled_server_raises_when_all_down(self):
        n = 96
        req, _ = _request_pair(n, 0, 1)
        with ReplicaGroup(2, retry_budget=1, backoff_base_s=0.001, allow_stale=False) as g:
            server = GraphServer(service=g, k=4, device="cpu", start_batcher=False)
            assert server.serve(req).info.stale is False
            for rid in g.replica_ids():
                g.kill(rid)
            other, _ = _request_pair(n, 5, 1)
            with pytest.raises(ReplicaExhaustedError):
                server.serve(other)

    def test_explicit_services_and_metrics_flow(self):
        with ReplicaGroup([PartitionService(max_entries=16) for _ in range(2)]) as g:
            server = GraphServer(service=g, k=4, device="cpu", start_batcher=False)
            req, _ = _request_pair(64, 0, 3)
            res = server.serve(req)
            assert res.info.as_dict()["stale"] is False
            assert server.metrics().workers == 2
