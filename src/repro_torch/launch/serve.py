"""Serving drivers of the port: LM prefill/decode and service-backed EP-SpMV serving.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b \
        --reduced --batch 4 --prompt-len 32 --gen 16

    PYTHONPATH=src python -m repro_torch.launch.serve --graph --requests 16 --churn 0.01

    PYTHONPATH=src python -m repro_torch.launch.serve --graph --batched \
        --clients 4 --graphs 48 --max-batch 8 --max-wait-ms 2

Port of the ``--arch``, ``--graph`` and ``--graph --batched`` modes of
``src/repro/launch/serve.py``.  The ``--arch`` mode prefills a batch of
seeded random prompts on a randomly initialised model of that architecture
(the ``dense`` and ``moe`` families) and greedily decodes from it, through
the flash-attention and expert-FFN kernels.  The ``--graph`` mode demonstrates the
paper-§4.2 serving architecture: a stream of SpMV requests over a (mostly)
repeated matrix hits the PartitionService's fingerprint cache; a churn batch
triggers an *async* incremental repartition on the optimization thread while
requests keep being served under the old plan from a double buffer, which
swaps when the new plan lands.  With ``--batched``, concurrent clients push
distinct small matrices through ``GraphServer.submit``, and same-bucket
requests share one stacked kernel launch.

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
from ..core import DoubleBuffer, PartitionService, synthetic_bipartite_graph
from ..device import resolve_device, synchronize
from ..kernels import make_ep_spmv_fn, spmv_hbm_traffic_model
from ..models import Model
from ..models.transformer import check_supported
from ..runtime import GraphRequest, GraphServer, make_decode_step, make_prefill_step

__all__ = ["run_serving", "serve_config", "run_graph_serving", "run_batched_graph_serving",
           "main"]

# Drivers of the reference's --graph family that this port does not carry yet.
_NOT_PORTED = ("--tenants", "--replicas", "--overload")


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
    for flag in _NOT_PORTED:
        ap.add_argument(flag, nargs="?", const=True, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    given = [f for f in _NOT_PORTED if getattr(args, f[2:]) is not None]
    if given:
        ap.error(f"{', '.join(given)}: not ported yet to repro_torch "
                 "(use python -m repro.launch.serve)")
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
    if args.batched:
        stats = run_batched_graph_serving(
            clients=args.clients, graphs=args.graphs,
            max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
        )
    else:
        stats = run_graph_serving(requests=args.requests, churn=args.churn, k=args.k)
    for key, val in stats.items():
        print(f"  {key}: {val}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
