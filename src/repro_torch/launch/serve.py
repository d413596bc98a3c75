"""Serving drivers of the port: LM prefill/decode and service-backed EP-SpMV serving.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b \
        --reduced --batch 4 --prompt-len 32 --gen 16

    PYTHONPATH=src python -m repro_torch.launch.serve --graph --requests 16 --churn 0.01

    PYTHONPATH=src python -m repro_torch.launch.serve --graph --batched \
        --clients 4 --graphs 48 --max-batch 8 --max-wait-ms 2

    PYTHONPATH=src python -m repro_torch.launch.serve --graph --tenants 3 \
        --cache-budget-mb 1.0 --workers 2

    PYTHONPATH=src python -m repro_torch.launch.serve --graph --replicas 2 \
        --kill-after 4 --transport process

    PYTHONPATH=src python -m repro_torch.launch.serve --graph --overload --queue-bound 4

Port of the ``--arch`` and ``--graph`` modes of ``src/repro/launch/serve.py``.
The ``--arch`` mode prefills a batch of seeded random prompts on a randomly
initialised model of that architecture (the ``dense`` and ``moe`` families)
and greedily decodes from it, through the flash-attention and expert-FFN
kernels.  The ``--graph`` mode demonstrates the
paper-§4.2 serving architecture: a stream of SpMV requests over a (mostly)
repeated matrix hits the PartitionService's fingerprint cache; a churn batch
triggers an *async* incremental repartition on the optimization thread while
requests keep being served under the old plan from a double buffer, which
swaps when the new plan lands.  With ``--batched``, concurrent clients push
distinct small matrices through ``GraphServer.submit``, and same-bucket
requests share one stacked kernel launch.

With ``--tenants N`` (N > 1), N tenants share one PartitionService with
per-tenant plan-cache byte budgets (``--cache-budget-mb``) and a
``--workers``-wide pool: tenant 0 floods the cache with one-shot matrices
while the others re-request their hot matrix, and the report shows the
per-tenant hit/miss/eviction isolation.  With ``--replicas N`` (N > 1) the
stream is served through a ``ReplicaGroup`` of N plan services and one of
them is killed after ``--kill-after`` requests; ``--transport process`` puts
each replica in its own OS process behind the loopback TCP transport
(``launch.replica_worker``, which imports neither torch nor JAX) and the
kill is a real ``SIGKILL``.  With ``--overload`` a low-priority tenant
floods a service whose queue is bounded at ``--queue-bound`` while a
high-priority victim keeps re-requesting its warm matrix: the victim stays
on warm hits, the flooder absorbs typed rejections, and the GraphServer's
brownout ladder turns hedging off, then answers the flooder from cache only.

All run on the CUDA device (the functions take ``device="cpu"`` to run
the plain PyTorch versions).  Every timing ends in a device synchronize.
"""
from __future__ import annotations

import argparse
import dataclasses
import threading
import time

import numpy as np

import torch

from ..configs import get_config
from ..core import (
    AdmissionRejectedError,
    DoubleBuffer,
    PartitionService,
    ReplicaGroup,
    synthetic_bipartite_graph,
)
from ..device import resolve_device, synchronize
from ..kernels import make_ep_spmv_fn, spmv_hbm_traffic_model
from ..models import Model
from ..models.transformer import check_supported
from ..runtime import GraphRequest, GraphServer, make_decode_step, make_prefill_step

__all__ = ["run_serving", "serve_config", "run_graph_serving", "run_batched_graph_serving",
           "run_multitenant_graph_serving", "run_replicated_graph_serving",
           "run_overload_graph_serving", "main"]


def run_serving(
    arch: str,
    batch: int = 4,
    prompt_len: int = 32,
    gen: int = 16,
    reduced: bool = True,
    seed: int = 0,
    device=None,
):
    """Prefill a batch of prompts, then greedy-decode ``gen`` tokens.

    Returns (tokens (B, gen), timing dict)."""
    tokens, stats, _ = serve_config(get_config(arch, reduced=reduced), batch, prompt_len, gen,
                                    seed, device)
    return tokens, stats


def serve_config(cfg, batch: int, prompt_len: int, gen: int, seed: int = 0, device=None):
    """:func:`run_serving` on a resolved config (a caller may cut its depth).

    The compute copies of the master weights are cast once, before the
    prompts arrive (``cast_s``), and every step runs on them.  Returns
    ``(tokens (B, gen), timing dict, state)``; ``state`` holds the
    ``model``, its master ``params``, their ``compute`` copies and the
    ``prompt`` for a caller that goes on with them.  Every timing ends in a
    device synchronize.
    """
    dev = resolve_device(device)
    model = Model(cfg, device=dev)
    params = model.init(seed)
    max_len = prompt_len + gen
    prompt = torch.from_numpy(np.random.default_rng(seed).integers(
        2, cfg.vocab_size, (batch, prompt_len))).to(dev)
    prefill = make_prefill_step(model, max_len=max_len)
    decode = make_decode_step(model)

    synchronize(dev)
    t_cast = time.perf_counter()
    compute = model.compute_params(params)
    synchronize(dev)
    t0 = time.perf_counter()
    tok, cache = prefill(compute, {"tokens": prompt})
    tok = tok[:, None]
    synchronize(dev)
    t_prefill = time.perf_counter() - t0

    out = [tok]
    t1 = time.perf_counter()
    for i in range(gen - 1):
        tok, cache = decode(compute, cache, tok, prompt_len + i)
        out.append(tok)
    synchronize(dev)
    t_decode = time.perf_counter() - t1
    stats = {
        "device": str(dev),
        "cast_s": t0 - t_cast,
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "tok_per_s": batch * (gen - 1) / max(t_decode, 1e-9),
    }
    state = {"model": model, "params": params, "compute": compute, "prompt": prompt}
    return torch.cat(out, dim=1), stats, state


def run_graph_serving(
    n_rows: int = 1024,
    n_cols: int = 1024,
    nnz_per_row: int = 6,
    k: int = 32,
    requests: int = 16,
    churn: float = 0.01,
    pad: int = 128,
    seed: int = 0,
    mode: str = "software",
    device=None,
    keep_samples: bool = False,
):
    """Serve a stream of EP-SpMV requests through the PartitionService.

    Phases: (1) cold request — full partition + pack + operands to the
    device; (2) warm requests — fingerprint cache hits, kernels only; (3)
    churn — ``churn`` fraction of the nnz is deleted and replaced, the
    incremental repartition runs on the optimization thread behind a
    DoubleBuffer while warm requests continue against the old plan; (4) a
    post-swap request through a dedicated per-plan callable of the refreshed
    plan.  Returns a timing/stats dict.

    With ``keep_samples``, the dict also holds ``samples``: for the first
    warm request, the first request served during the repartition and the
    post-swap request, the matrix it was served on (``rows, cols, vals``),
    its float32 ``x`` and its ``y`` as numpy arrays, so a caller can check
    each answer.
    """
    dev = resolve_device(device)
    _, rows, cols = synthetic_bipartite_graph(n_rows, n_cols, nnz_per_row, seed=seed)
    rng = np.random.default_rng(seed + 1)
    vals = rng.standard_normal(rows.shape[0]).astype(np.float32)

    with PartitionService() as svc:
        server = GraphServer(svc, k=k, pad=pad, mode=mode, device=dev, start_batcher=False)

        samples = {}
        old = (rows, cols, vals)

        def serve_once(x, sample=None):
            res = server.serve(GraphRequest(n_rows, n_cols, rows, cols, vals, x))
            synchronize(dev)
            if keep_samples and sample is not None and sample not in samples:
                samples[sample] = (old, x.astype(np.float32), res.y.cpu().numpy())
            return res

        t0 = time.perf_counter()
        info0 = serve_once(rng.standard_normal(n_cols)).info
        cold_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        n_warm = max(requests - 1, 1)
        for _ in range(n_warm):
            res = serve_once(rng.standard_normal(n_cols), "warm")
            assert res.info.cache_hit
        warm_s = (time.perf_counter() - t0) / n_warm

        # Churn batch: delete + insert churn*m edges, repartition ASYNC while
        # the old plan keeps serving from the double buffer.
        m = rows.shape[0]
        n_churn = max(int(churn * m), 1)
        delete_ids = rng.choice(m, size=n_churn, replace=False)
        ins_rows = rng.integers(0, n_rows, n_churn)
        ins_cols = rng.integers(0, n_cols, n_churn)
        buffer = DoubleBuffer()
        t0 = time.perf_counter()
        ticket = svc.update_async(
            info0.fingerprint,
            k,
            insert_u=ins_cols.astype(np.int64),
            insert_v=(n_cols + ins_rows).astype(np.int64),
            delete_ids=delete_ids,
            pad=pad,
            buffer=buffer,
        )
        overlapped = 0
        while not ticket.done():  # old plan keeps serving — §4.2 overlap
            serve_once(rng.standard_normal(n_cols), "during_repartition")
            overlapped += 1
        new_plan = ticket.result()
        incr_s = time.perf_counter() - t0
        swapped, gen = buffer.current()
        assert swapped is new_plan and gen == 1

        # Values follow the churn: surviving nnz keep theirs, insertions get new.
        vals_new = np.concatenate(
            [np.delete(vals, delete_ids), rng.standard_normal(n_churn).astype(np.float32)]
        )
        fn = make_ep_spmv_fn(new_plan.plan, vals_new, mode=mode, device=dev)
        x = rng.standard_normal(n_cols).astype(np.float32)
        t0 = time.perf_counter()
        y = fn(x)
        synchronize(dev)
        post_swap_s = time.perf_counter() - t0
        if keep_samples:
            new = (np.concatenate([np.delete(rows, delete_ids), ins_rows]),
                   np.concatenate([np.delete(cols, delete_ids), ins_cols]), vals_new)
            samples["post_swap"] = (new, x, y.cpu().numpy())

        stats = {
            "device": str(dev),
            "mode": mode,
            "cold_s": cold_s,
            "warm_s": warm_s,
            "warm_speedup": cold_s / max(warm_s, 1e-9),
            "incremental_s": incr_s,
            "incremental_source": new_plan.source,
            "requests_overlapped_with_repartition": overlapped,
            "post_swap_s": post_swap_s,
            "traffic": spmv_hbm_traffic_model(new_plan.plan, mode),
            "service": dataclasses.asdict(svc.stats),
            "compile_cache": server.stats(),
        }
    if keep_samples:
        stats["samples"] = {
            name: {"rows": m[0], "cols": m[1], "vals": m[2], "x": x, "y": y}
            for name, (m, x, y) in samples.items()
        }
    return stats


def run_batched_graph_serving(
    clients: int = 4,
    graphs: int = 48,
    requests_per_client: int = 24,
    max_batch: int = 8,
    max_wait_ms: float = 2.0,
    n_rows: int = 192,
    n_cols: int = 192,
    nnz_per_row: int = 4,
    k: int = 8,
    pad: int = 128,
    seed: int = 0,
    mode: str = "software",
    device=None,
):
    """Concurrent clients through the bucketed micro-batched serve path.

    ``clients`` threads each fire ``requests_per_client`` requests drawn
    from a pool of ``graphs`` distinct small matrices (all landing in a
    handful of shape buckets).  Requests go through ``GraphServer.submit``,
    so same-bucket arrivals inside the ``max_wait_ms`` window share one
    stacked kernel launch.  Reports request rate and latency (each request
    ends when its result is on the host), distinct bucket builds, and the
    batch-size histogram.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    pool = []
    for g in range(graphs):
        _, rows, cols = synthetic_bipartite_graph(n_rows, n_cols, nnz_per_row, seed=seed + g)
        vals = rng.standard_normal(rows.shape[0]).astype(np.float32)
        pool.append((rows, cols, vals))

    with PartitionService(max_entries=graphs + 8) as svc:
        with GraphServer(
            svc, k=k, pad=pad, mode=mode, device=dev,
            max_batch=max_batch, max_wait_ms=max_wait_ms,
        ) as server:
            # Warm the plan cache so the measured phase is serving, not
            # partitioning (the §4.2 split: optimization off the hot path).
            for rows, cols, vals in pool:
                server.serve(GraphRequest(n_rows, n_cols, rows, cols, vals,
                                          np.zeros(n_cols, np.float32)))
            synchronize(dev)
            latencies: list[float] = []
            lat_lock = threading.Lock()

            def client(cid: int) -> None:
                crng = np.random.default_rng(1000 + cid)
                for _ in range(requests_per_client):
                    rows, cols, vals = pool[crng.integers(0, len(pool))]
                    x = crng.standard_normal(n_cols).astype(np.float32)
                    t0 = time.perf_counter()
                    server.submit(
                        GraphRequest(n_rows, n_cols, rows, cols, vals, x,
                                     tenant=f"client{cid}")
                    ).wait(60.0).y.cpu()
                    with lat_lock:
                        latencies.append(time.perf_counter() - t0)

            threads = [threading.Thread(target=client, args=(c,)) for c in range(clients)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            elapsed = time.perf_counter() - t0
            stats = server.stats()
    n_req = clients * requests_per_client
    if len(latencies) != n_req:
        raise RuntimeError(f"{n_req - len(latencies)} of {n_req} requests did not complete")
    lat = np.asarray(sorted(latencies))
    return {
        "device": str(dev),
        "mode": mode,
        "requests": n_req,
        "elapsed_s": elapsed,
        "req_per_s": n_req / max(elapsed, 1e-9),
        "p50_ms": float(lat[int(0.50 * (len(lat) - 1))]) * 1e3,
        "p99_ms": float(lat[int(0.99 * (len(lat) - 1))]) * 1e3,
        "kernel_compiles": stats["misses"],
        "kernel_cache_hits": stats["hits"],
        "buckets": list(stats["buckets"]),
        "batch_hist": stats["batch_hist"],
    }


def _sample(req, res) -> dict:
    """A served request as host arrays, for a caller that checks the answer."""
    return {"rows": req.rows, "cols": req.cols, "vals": req.vals, "x": req.x,
            "y": res.y.cpu().numpy(), "cache_hit": res.info.cache_hit,
            "stale": res.info.stale, "degraded": res.info.degraded}


def run_multitenant_graph_serving(
    tenants: int = 3,
    cache_budget_mb: float = 1.0,
    workers: int = 2,
    rounds: int = 4,
    n_rows: int = 256,
    n_cols: int = 256,
    nnz_per_row: int = 4,
    k: int = 16,
    pad: int = 128,
    seed: int = 0,
    device=None,
    keep_samples: bool = False,
):
    """Drive K tenants through one PartitionService under cache contention.

    Tenant 0 is the *flooder*: every round it serves a brand-new one-shot
    matrix (cache pollution).  Tenants 1..K-1 are *victims*: each owns one
    hot matrix and re-requests it every round.  With per-tenant byte
    budgets the flood can only evict the flooder's own entries, so every
    victim round after the first is a warm hit.  Returns a dict with
    per-tenant serving stats and the ServiceMetrics snapshot; each latency
    ends in a device synchronize.  With ``keep_samples`` it also holds
    ``samples``: per tenant, every request's matrix, x and y (host arrays).
    """
    dev = resolve_device(device)
    budget = int(cache_budget_mb * 1e6)
    rng = np.random.default_rng(seed)
    samples: dict[str, list] = {f"tenant{t}": [] for t in range(tenants)}
    with PartitionService(workers=workers, default_tenant_budget=budget) as svc:
        server = GraphServer(svc, k=k, pad=pad, device=dev, start_batcher=False)

        def serve(rows, cols, vals, x, tenant):
            req = GraphRequest(n_rows, n_cols, rows, cols, vals, x, tenant=tenant)
            t0 = time.perf_counter()
            res = server.serve(req)
            synchronize(dev)
            dt = time.perf_counter() - t0
            if keep_samples:
                samples[tenant].append(_sample(req, res))
            return dt, res.info

        hot = {}
        for t in range(1, tenants):
            _, rows, cols = synthetic_bipartite_graph(
                n_rows, n_cols, nnz_per_row, seed=100 + t)
            vals = rng.standard_normal(rows.shape[0]).astype(np.float32)
            hot[f"tenant{t}"] = (rows, cols, vals)
        per_round: dict[str, list] = {f"tenant{t}": [] for t in range(tenants)}
        flood_seed = 0
        for _ in range(rounds):
            flood_seed += 1
            _, rows, cols = synthetic_bipartite_graph(
                n_rows, n_cols, nnz_per_row, seed=1000 + flood_seed)
            vals = rng.standard_normal(rows.shape[0]).astype(np.float32)
            dt, info = serve(rows, cols, vals, rng.standard_normal(n_cols), "tenant0")
            per_round["tenant0"].append((dt, info.cache_hit))
            for name, (rows, cols, vals) in hot.items():
                dt, info = serve(rows, cols, vals, rng.standard_normal(n_cols), name)
                per_round[name].append((dt, info.cache_hit))
        snap = svc.metrics()
        report = {"device": str(dev), "tenants": {},
                  "metrics": dataclasses.asdict(snap)}
        for name, rts in per_round.items():
            warm = [dt for dt, hit in rts[1:] if hit]
            report["tenants"][name] = {
                "requests": len(rts),
                "warm_hits_after_round1": sum(hit for _, hit in rts[1:]),
                "warm_hit_rate_after_round1": (
                    sum(hit for _, hit in rts[1:]) / max(len(rts) - 1, 1)),
                "median_warm_ms": float(np.median(warm)) * 1e3 if warm else None,
                "evictions": snap.tenants.get(name, {}).get("evictions", 0),
            }
    if keep_samples:
        report["samples"] = samples
    return report


def run_replicated_graph_serving(
    replicas: int = 2,
    kill_after: int | None = 4,
    requests: int = 12,
    matrices: int = 4,
    n_rows: int = 256,
    n_cols: int = 256,
    nnz_per_row: int = 4,
    k: int = 16,
    pad: int = 128,
    seed: int = 0,
    transport: str = "thread",
    heartbeat_deadline_s: float | None = None,
    mode: str = "software",
    device=None,
    keep_samples: bool = False,
):
    """Serve an EP-SpMV stream through a ReplicaGroup, crashing one replica
    mid-stream.

    The stream cycles through ``matrices`` distinct matrices; after
    ``kill_after`` requests one replica is killed.  Requests keep being
    served — in-flight plans fail over, warm requests hit the shared plan
    store — and the report carries per-request outcomes plus the group's
    per-replica health/failover table.

    ``transport="thread"`` (default) runs the replicas in-process; the
    mid-stream kill is a graceful-drain crash.  ``transport="process"``
    spawns one worker OS process per replica behind the TCP transport
    (``launch.replica_worker``) and the kill is a real ``SIGKILL`` — the
    stream must survive on wire errors and missed heartbeats alone.
    ``heartbeat_deadline_s`` (default: 1 s for worker processes, the
    group's 2 s for threads) must exceed the longest cold partition: a busy
    replica beats only when a job completes, and with every replica suspect
    the group serves a stale plan of the same shape.  Each latency ends in
    a device synchronize; with ``keep_samples`` the report also holds
    ``samples``, every request's matrix, x and y.
    """
    if transport not in ("thread", "process"):
        raise ValueError(f"unknown transport {transport!r}")
    dev = resolve_device(device)

    rng = np.random.default_rng(seed)
    pool = []
    for g in range(matrices):
        _, rows, cols = synthetic_bipartite_graph(n_rows, n_cols, nnz_per_row,
                                                  seed=seed + g)
        vals = rng.standard_normal(rows.shape[0]).astype(np.float32)
        pool.append((rows, cols, vals))

    hb = heartbeat_deadline_s if heartbeat_deadline_s is not None else (
        1.0 if transport == "process" else 2.0)
    if transport == "process":
        from .replica_worker import spawn_process_group
        group_cm = spawn_process_group(replicas, heartbeat_deadline_s=hb)
    else:
        group_cm = ReplicaGroup(replicas, heartbeat_deadline_s=hb)
    samples = []
    with group_cm as group:
        server = GraphServer(group, k=k, pad=pad, mode=mode, device=dev,
                             start_batcher=False)
        killed = None
        per_request = []
        t_all = time.perf_counter()
        for i in range(requests):
            if kill_after is not None and i == kill_after and killed is None:
                killed = group.replica_ids()[0]
                if transport == "process":
                    # kill -9 the worker process: no drain, no goodbye.
                    group._by_rid[killed].svc.sigkill()
                else:
                    group.kill(killed)
            rows, cols, vals = pool[i % len(pool)]
            x = rng.standard_normal(n_cols).astype(np.float32)
            req = GraphRequest(n_rows, n_cols, rows, cols, vals, x)
            t0 = time.perf_counter()
            res = server.serve(req)
            synchronize(dev)
            per_request.append({
                "latency_ms": (time.perf_counter() - t0) * 1e3,
                "cache_hit": res.info.cache_hit,
                "stale": res.info.stale,
            })
            if keep_samples:
                samples.append(_sample(req, res))
        elapsed = time.perf_counter() - t_all
        rm = group.replica_metrics()
    report = {
        "device": str(dev),
        "mode": mode,
        "replicas": replicas,
        "transport": transport,
        "killed_replica": killed,
        "requests": requests,
        "elapsed_s": elapsed,
        "served_after_kill": sum(1 for r in per_request[kill_after or 0:]),
        "stale_serves": rm.stale_serves,
        "lost_tickets": rm.lost,
        "failovers": rm.failovers,
        "retries": rm.retries,
        "hedges_fired": rm.hedges_fired,
        "per_request": per_request,
        "replica_table": [r.as_dict() for r in rm.replicas],
    }
    if keep_samples:
        report["samples"] = samples
    return report


def run_overload_graph_serving(
    queue_bound: int = 4,
    flood_clients: int = 6,
    flood_requests_each: int = 4,
    victim_rounds: int = 10,
    stall_s: float = 0.03,
    heartbeat_deadline_s: float = 2.0,
    n_rows: int = 192,
    n_cols: int = 192,
    nnz_per_row: int = 4,
    k: int = 8,
    pad: int = 128,
    seed: int = 0,
    device=None,
    keep_samples: bool = False,
):
    """Overload-protection demo: a flooding tenant against bounded admission.

    One low-priority tenant fires cold one-shot matrices from
    ``flood_clients`` threads at a service whose scheduler queue is bounded
    at ``queue_bound`` (drain artificially slowed by ``stall_s`` per job so
    the flood actually queues).  A high-priority victim keeps re-requesting
    its warm matrix throughout.  The report shows the ladder working:
    victims stay on warm-hit latency with zero rejections; the flooder
    absorbs ``AdmissionRejectedError`` with ``retry_after_s`` hints; under
    sustained rejection pressure the :class:`GraphServer` browns out —
    hedging off first, then the low-priority tenant goes cache-only.
    ``heartbeat_deadline_s`` must exceed the longest cold partition (the
    one replica beats only when a job completes).  Each victim latency ends
    in a device synchronize; with ``keep_samples`` the
    report also holds ``samples``: the victim's and every admitted flooder
    request's matrix, x and y.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    _, vrows, vcols = synthetic_bipartite_graph(n_rows, n_cols, nnz_per_row,
                                                seed=seed)
    vvals = rng.standard_normal(vrows.shape[0]).astype(np.float32)
    samples: dict[str, list] = {"victim": [], "flooder": []}

    with ReplicaGroup(
        1, hedge=False, workers=1, retry_budget=1,
        heartbeat_deadline_s=heartbeat_deadline_s,
        backoff_base_s=0.002, backoff_cap_s=0.005,
        breaker_cooldown_s=0.2,
        max_queue_depth=queue_bound,
    ) as group:
        server = GraphServer(group, k=k, pad=pad, device=dev,
                             start_batcher=False,
                             brownout_hedge_off=2, brownout_stale_only=4,
                             brownout_window_s=2.0)

        def victim_req(x):
            req = GraphRequest(n_rows, n_cols, vrows, vcols, vvals, x, tenant="victim",
                               priority=1)
            res = server.serve(req)
            synchronize(dev)
            return req, res

        victim_req(rng.standard_normal(n_cols))  # warm the hot matrix
        # Slow the drain so the flood queues instead of racing through.
        group._replicas[0].svc.scheduler.pre_job_hook = (
            lambda _key: time.sleep(stall_s))

        admitted = [0]
        rejections: list[float] = []
        brownout_rejects = [0]
        out_lock = threading.Lock()

        def flooder(cid: int) -> None:
            crng = np.random.default_rng(5000 + cid)
            for j in range(flood_requests_each):
                _, rows, cols = synthetic_bipartite_graph(
                    n_rows, n_cols, nnz_per_row,
                    seed=9000 + cid * 100 + j)
                vals = crng.standard_normal(rows.shape[0]).astype(np.float32)
                x = crng.standard_normal(n_cols).astype(np.float32)
                req = GraphRequest(n_rows, n_cols, rows, cols, vals, x, tenant="flooder",
                                   priority=0)
                try:
                    res = server.serve(req)
                    with out_lock:
                        admitted[0] += 1
                        if keep_samples:
                            samples["flooder"].append(_sample(req, res))
                except AdmissionRejectedError as e:
                    with out_lock:
                        if e.reason == "brownout":
                            brownout_rejects[0] += 1
                        else:
                            rejections.append(e.retry_after_s)

        threads = [threading.Thread(target=flooder, args=(c,))
                   for c in range(flood_clients)]
        for t in threads:
            t.start()
        victim_lat = []
        for _ in range(victim_rounds):
            t0 = time.perf_counter()
            req, res = victim_req(rng.standard_normal(n_cols))
            victim_lat.append(time.perf_counter() - t0)
            assert res.info.cache_hit and not res.info.degraded
            if keep_samples:
                samples["victim"].append(_sample(req, res))
            time.sleep(0.01)
        for t in threads:
            t.join()
        lat = np.asarray(sorted(victim_lat))
        snap = group.metrics()
        stats = server.stats()
        report = {
            "device": str(dev),
            "queue_bound": queue_bound,
            "victim_p50_ms": float(lat[int(0.50 * (len(lat) - 1))]) * 1e3,
            "victim_p99_ms": float(lat[int(0.99 * (len(lat) - 1))]) * 1e3,
            "victim_rejections": 0,  # any rejection would have raised above
            "flooder_admitted": admitted[0],
            "flooder_rejections": len(rejections),
            "flooder_brownout_rejects": brownout_rejects[0],
            "min_retry_after_s": min(rejections) if rejections else None,
            "queue_depth_max": snap.queue_depth_max,
            "rejected": snap.rejected,
            "shed_deadline": snap.shed_deadline,
            "brownout_level_final": stats["brownout_level"],
            "degraded_serves": stats["degraded_serves"],
            "breakers": group.breaker_states("flooder"),
        }
    if keep_samples:
        report["samples"] = samples
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--graph", action="store_true",
                    help="serve EP-SpMV requests through the PartitionService")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--churn", type=float, default=0.01)
    ap.add_argument("--k", type=int, default=32)
    ap.add_argument("--batched", action="store_true",
                    help="with --graph: drive the bucketed micro-batched "
                         "serve path with concurrent clients")
    ap.add_argument("--clients", type=int, default=4,
                    help="concurrent client threads for --batched")
    ap.add_argument("--graphs", type=int, default=48,
                    help="distinct matrices in the --batched request pool")
    ap.add_argument("--max-batch", type=int, default=8,
                    help="micro-batch width for --batched")
    ap.add_argument("--max-wait-ms", type=float, default=2.0,
                    help="micro-batch coalescing window for --batched")
    ap.add_argument("--tenants", type=int, default=1,
                    help="with --graph: drive N tenants under cache "
                         "contention through one service (N > 1)")
    ap.add_argument("--cache-budget-mb", type=float, default=1.0,
                    help="per-tenant plan-cache byte budget (MB)")
    ap.add_argument("--workers", type=int, default=2,
                    help="partition worker pool size for the tenant demo")
    ap.add_argument("--replicas", type=int, default=1,
                    help="with --graph: serve through a ReplicaGroup of N "
                         "PartitionService replicas (N > 1)")
    ap.add_argument("--kill-after", type=int, default=4,
                    help="with --replicas: crash one replica after this "
                         "many requests (negative disables)")
    ap.add_argument("--overload", action="store_true",
                    help="with --graph: flood a bounded-admission service "
                         "with one tenant and show victims staying fast "
                         "while the flooder absorbs typed rejections")
    ap.add_argument("--queue-bound", type=int, default=4,
                    help="scheduler queue bound for --overload")
    ap.add_argument("--transport", choices=["thread", "process"],
                    default="thread",
                    help="with --replicas: 'thread' keeps replicas "
                         "in-process; 'process' spawns one worker OS "
                         "process per replica behind the TCP transport "
                         "and the mid-stream kill becomes a real SIGKILL")
    args = ap.parse_args(argv)
    if args.arch:
        try:
            check_supported(get_config(args.arch, reduced=args.reduced))
        except KeyError as exc:
            ap.error(str(exc))
        except NotImplementedError as exc:
            ap.error(f"--arch {args.arch}: not ported yet to repro_torch ({exc}); "
                     "use python -m repro.launch.serve")
    if not args.graph:
        if not args.arch:
            ap.error("--arch is required unless --graph is given")
        tokens, stats = run_serving(args.arch, batch=args.batch, prompt_len=args.prompt_len,
                                    gen=args.gen, reduced=args.reduced)
        print(f"generated {tuple(tokens.shape)} tokens; {stats}")
        return 0
    if args.overload:
        stats = run_overload_graph_serving(queue_bound=args.queue_bound, k=args.k)
    elif args.replicas > 1:
        stats = run_replicated_graph_serving(
            replicas=args.replicas,
            kill_after=args.kill_after if args.kill_after >= 0 else None,
            requests=args.requests, k=args.k,
            transport=args.transport,
        )
        for row in stats.pop("replica_table"):
            print(f"  replica {row['replica']}: state={row['state']} "
                  f"beats={row['beats']} jobs={row['jobs_completed']} "
                  f"failovers_from={row['failovers_from']} "
                  f"p99_ms={row['p99_ms']:.1f}")
        for r in stats.pop("per_request"):
            print(f"  req: {r['latency_ms']:8.2f}ms cache_hit={r['cache_hit']} "
                  f"stale={r['stale']}")
    elif args.batched:
        stats = run_batched_graph_serving(
            clients=args.clients, graphs=args.graphs,
            max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
        )
    elif args.tenants > 1:
        report = run_multitenant_graph_serving(
            tenants=args.tenants, cache_budget_mb=args.cache_budget_mb,
            workers=args.workers, k=args.k,
        )
        for name, row in report["tenants"].items():
            print(f"  {name}: {row}")
        m = report["metrics"]
        print(f"  scheduler: workers={m['workers']} "
              f"utilization={m['utilization']:.2f} "
              f"completed={m['jobs_completed']} coalesced={m['coalesced']} "
              f"p99_latency_s={m['latency_s'].get('p99', 0.0):.4f}")
        return 0
    else:
        stats = run_graph_serving(requests=args.requests, churn=args.churn, k=args.k)
    for key, val in stats.items():
        print(f"  {key}: {val}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
