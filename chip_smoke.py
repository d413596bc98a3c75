#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one GPU and check them.

    python3 chip_smoke.py

Builds the kernels from ``src/repro_torch/kernels/csrc`` (nvcc, one process
per source, all at once), then drives the port's two main paths through the
entry points a user calls, each with the kernels' launch counts set to 0
just before it and read just after.

The EP-SpMV path, in six phases:

  dedicated      GraphServer(PartitionService(), k=1024, pad=128) on a
                 262,144 x 262,144 matrix with 16 nnz per row (4.2M nnz, the
                 scale of the paper's in-2004 / cant): too big for a bucket,
                 so the dedicated lane; 1 cold + 4 warm requests in each mode;
  graph_serving  run_graph_serving at 65,536 x 65,536 x 16 (1M nnz, the
                 paper's scircuit scale), k=256: the bucketed software lane,
                 a 1% churn repartitioned behind a double buffer, and a
                 post-swap dedicated launch;
  batched        8 distinct 16,384 x 16,384 x 16 matrices, k=64, submitted
                 concurrently through the micro-batcher in each mode;
  multitenant    run_multitenant_graph_serving at 16,384 x 16,384 x 16, k=64:
                 3 tenants, 4 rounds, 2 partition workers; tenant0 floods a
                 new matrix each round against a per-tenant cache budget of
                 1.5x the largest victim plan, and the victims must stay warm;
  replicated     run_replicated_graph_serving at the same size in streaming
                 mode: 2 replica worker processes behind the TCP transport,
                 6 matrices cycled over 12 requests, one worker SIGKILLed
                 after request 4; the two cold requests after the kill must
                 be re-dispatched away from the dead worker; nothing lost,
                 nothing stale;
  overload       run_overload_graph_serving at the same size: queue bound 4,
                 6 flooding clients x 4 cold matrices against a warm victim;
                 the victim stays warm and undegraded, and every flooder
                 request is admitted, rejected or browned out.

Every y served in the dedicated, batched and the last three phases, and in
graph_serving a warm y, a y served during the repartition and the post-swap
y, is held against a float64 COO product on the host (rtol = atol = 1e-5);
each of the last three phases counts its own launches and fails unless its
lane's kernels ran (``PATH_KERNELS``); a stacked
batch must equal each batch of one bit for bit, and in
software mode the bucketed lane must equal the dedicated lane bit for bit.
Then each SpMV kernel is run at the main path's shapes, held against its
plain PyTorch twin on the same card tensors (and the two streaming kernels
bit for bit against the twin run on the CPU, on host copies of the same
tensors), and timed with CUDA events over
back-to-back launches (and alone, from the profiler's trace) beside its
bound (the bytes this run's data needs: valid tasks, the x entries they
read, the y runs and the output, over the card's memory rate), its twin
and one PyTorch library call that computes the same product; and one
warm request in each lane is profiled: its wall time, the host's heaviest
functions (cProfile) and the device's busy time by kernel and copy
(torch.profiler), whose ratio to the wall time is the device's idle share.

The LM serving path (``lm_serving``): qwen3-moe-30b-a3b at its published
widths (d_model 2048, 32/4 heads of 128, 128 experts top-8 of d_ff 768,
vocab 151,936), cut to 8 of its 48 layers, f32 master weights and bf16
compute copies drawn on the card from a seed, serves a batch of 4 prompts
of 2,048 tokens and greedily decodes 32 tokens through ``serve_config`` (what
``run_serving`` runs).  Flash attention must have run once per layer in
prefill and the expert FFN once per layer per step.  Then each kernel is
held against its twin at the shapes that run gave it (bf16: 5e-2, and
1e-2 |want| + 5e-2 rms(row) elementwise) and in
float32 at a smaller shape (2e-5), and timed beside its bound (the larger
of its bytes over the memory rate and its products over the bf16 tensor-core
rate), its twin and one library call (SDPA; three ``bmm`` and a SiLU):
flash attention on the un-repeated K/V prefill passes (4 kv heads) and on
head-repeated K/V, the expert FFN at the prefill capacity and at the decode
capacity on a dense slab and on a slab routed through layer 0's router, whose
bound counts only the experts that hold a pair; a warm
prefill and a warm decode step are profiled (wall, device busy by kernel,
idle share); and the model is checked end to end in float32: reduced
qwen3-moe and granite on the card against the CPU (1e-4), and prefill +
decode against teacher forcing at full width, 2 layers (2e-4).

The SSM serving path (``ssm_serving``): mamba2-2.7b at its published widths
and depth (64 layers, d_model 2560, 80 SSD heads of 64, d_state 128, chunk
256, vocab 50,280, tied embeddings; 2.70 B parameters), f32 masters and bf16
compute copies drawn on the card from a seed, serves a batch of 4 prompts of
2,048 tokens and greedily decodes 32 tokens through ``serve_config``, after
the LM phases have released their memory.  The path is attention-free and
expert-free: it must launch none of the kernels.  A warm prefill and decode
step are profiled as the LM's are (``ssm_profile``), and ``lm_checks`` also
holds reduced mamba2 card against CPU and mamba2 at full width, 2 layers,
against teacher forcing over a prompt of 300 (two SSD chunks, padded).

The hybrid, M-RoPE and encoder-decoder paths, each at its published widths
through ``serve_config`` with B = 4 prompts of 2,048 tokens and 32 greedy
tokens, counts set to 0 just before each and read just after:
``hybrid_serving`` serves jamba-1.5-large-398b's layers 0-4 (four Mamba
layers with MLP, MoE, MLP, MoE FFNs, then attention with an MLP) as one
period of five, 23,992,172,544 bf16 parameters (a whole period of eight
would be 90.3 GB): flash once, the expert FFN in both MoE layers at every
step; ``mrope_serving`` serves qwen2-vl-2b's 28 layers behind the vision
stub (embeddings and M-RoPE positions): flash once a layer;
``encdec_serving`` serves seamless-m4t-medium's 12 + 12 layers behind the
audio stub: flash in each encoder layer and twice in each decoder layer
(self- and cross-attention) at prefill.  Each prints its cast, prefill and
decode times, tokens/s and peak memory, and is profiled as the LM is
(``*_profile``); every profile line also holds the path's bounds
(``_serving_bounds``, with the experts the served decode steps read
counted from their recorded routing).  ``zoo_kernels`` holds flash and the
expert FFN against their twins at the new shapes (jamba's prefill and
routed decode slab; flash at jamba's, qwen2-vl's group of 6 and
seamless's Dh 64 causal and non-causal shapes) and times them beside their
bounds and library calls; each such shape's launches are those of the path
that runs it.  ``lm_checks`` also holds the three reduced models card
against CPU and each at full width against teacher forcing.

The training path (``training``): ``run_training`` on qwen3-moe-30b-a3b at
its published widths, layers 0-3 (3,114,814,464 parameters), f32 masters,
bf16 compute, remat, its own AdamW and warmup-cosine, 6 steps of 8 x 2,048
synthetic tokens in 2 microbatches, counts set to 0 just before and read
just after: every loss and grad norm finite, no kernel launched but
AdamW's (a norm a step, an update a leaf) and the training attention's
(the reference trains through no Pallas kernel, and
the port's einsum experts are differentiable PyTorch; its bf16 attention
takes the flash training forward and backward, a forward each for the pass
and for remat's recompute and a backward each, a layer and microbatch),
every leaf a nonzero gradient; each
step's loss, grad norm, lr and wall ms, the steady step and tokens/s, the
peak memory, the step's bound (the products over the bf16 rate plus
AdamW's bytes over the memory rate) and one profiled step.
``train_kernels``: the training attention's forward (with the rows'
log-sum-exp) and backward at the per-call shapes of the benchmark's two
training cells (``TRAIN_ATTENTION``) against their twins (the log-sum-exp
to LSE_TOL; the backward's twin from the kernel's output and the twin's
log-sum-exp), two backward calls bit-equal, timed beside their bound, the
twins and SDPA (a yardstick only); the qwen3-moe shape is the training
path's, the Moonlight shape a nested entry that no path runs.
``train_checks``: ``forward_train``'s last hidden state against
``forward_prefill``'s (through the kernels) at published widths in float32,
and one train step of every registered reduced config on the card against
the CPU, each within E2E_TOL; ``train_restart``: the reference's restart
test on the card under deterministic algorithms, in a process of its own
beside ``train_checks`` and ``examples``, bit-exact.

The distribution layer: ``sharded`` (in a process of its own, a one-rank
NCCL group, the 1x1 mesh over the card, deterministic algorithms): the
``lm_serving`` cut served unsharded twice (the control) and then with its
weights placed by the serve rules and the serve profile installed, so the
kernels are reached through ``local_map`` on local shards: the same 32
tokens, the prefill logits within E2E_TOL, the same launches; one train
step at the ``training`` cut in float32 compute, unsharded and under the
train rules: loss and gradients within E2E_TOL, no launch; and that state
after a second step checkpointed on the local disk and restored onto a
sharded and a plain template, bit for bit, the next step too.  ``dryrun``:
``python -m repro_torch.launch.dryrun`` for eight production cells (qwen3-moe
train_4k and decode_32k on 16x16 and 2x16x16, jamba decode_32k, mamba2
long_500k, mamba2 and jamba prefill_32k), each in a process of its own
started before ``train_checks`` and running beside them on the host's
cores: every cell ``ok``, one line each with the modeled per-device GB,
roofline terms and ``mfu``, its collective bytes and the part of them whose
input is parameter storage, which must be 0 in every decode cell (the serve
rules' weights stay where they are put; decode moves activations), and the
two prefill cells at most the reference's dry-run's collective bytes
(``DRYRUN_REFERENCE_BYTES``: the Mamba mixer moves its projection once); and the
dry-run's predictions on a 1x1 mesh for the two ``sharded`` cuts beside the
card's own peak memory and wall time there.

The ``examples`` phase runs the port's four examples through their
``main(["--device", "cuda"])``: the quickstart (EP-SpMV within 1e-4 of the
COO oracle, through the software-cache kernel and the combine), CG behind
the adaptive scheduler (residual under 1e-3; the kernel runs on the
iterations the scheduler gives it), serve_lm with its default reduced
granite-3-8b (flash attention), with reduced mamba2-2.7b and with reduced
jamba-1.5-large-398b, and train_lm (reduced qwen3-moe-30b-a3b, 20 steps,
the loss falls, AdamW's kernels alone launched).

The build phase also counts the HGMMA (wgmma) and UTMALDG (TMA load)
instructions in each kernel of the flash-attention and expert-FFN libraries,
and the 16-byte global loads (LDG.E...128) in each SpMV kernel
(``cuobjdump -sass``), and fails if a bf16 kernel lacks either of the first
two or the streaming SpMV kernel the third.

Any failure raises, so the exit code is not 0.  Without a CUDA device, or
without the repository beside it, the script prints no result and exits 1.
The line before the last lists every kernel's numbers; the last line is the
device record.
"""
from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import threading
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM bf16 tensor cores, dense
TOL = 1e-5
# The reference's kernel tolerances (tests/test_kernels.py): bf16 and float32.
BF16_TOL, F32_TOL = 5e-2, 2e-5
# A bf16 kernel is also held elementwise to BF16_RTOL * |want| + BF16_ROW * the
# RMS of want's row (last axis).  The reference's 5e-2 is as large as a typical
# output of causal attention at 2,048 tokens (row i's output has a std of about
# sqrt(e / i)), so it says little of the late rows; a fixed limit far below it
# fails a right kernel on the first rows, whose outputs are O(1) and whose p
# the kernel and its twin round to bf16 (2^-8) at different scales.  Scaled by
# the row, the limit is about 2e-3 at row 2,048 and 5e-2 at the first rows;
# one bf16 ulp of the output is at most 2^-7 of it.
BF16_RTOL, BF16_ROW = 1e-2, 5e-2
# The training forward's float32 row log-sum-exp, O(log T) (about 8 at 2,048
# keys): float32 sums in another order move it by a few 1e-6; a wrong log
# base, a missing scale or a row of another q tile moves it by 0.1 or more.
LSE_TOL = 1e-4
# Reduced float32 models on the card against the CPU: sums in other orders
# over 2 layers move logits by a few 1e-6; a fault moves them by 1e-2 or more.
E2E_TOL = 1e-4
# Teacher forcing, the reference's own tolerance (tests/test_models.py).
TF_TOL = 2e-4
# (matrix side, clusters k[, batch]) of the three serving phases
DEDICATED = (262_144, 1024)
SERVING = (65_536, 256)
BATCHED = (16_384, 64, 8)
# The multitenant, replicated and overload phases: the batched phase's scale.
SLICE_MATRIX = {"n_rows": 16_384, "n_cols": 16_384, "nnz_per_row": 16, "k": 64, "pad": 128}
# A busy replica beats only when a job completes, and a cold partition at
# this scale takes 1.2-1.4 s in a worker on the H100 host (2.5 s on a slow
# CPU): the drivers' defaults (1 s and 2 s, sized for 256 x 256 matrices)
# would mark a replica suspect mid-job, and with no replica healthy the
# group serves a stale plan of the same shape.  The deadline stays short
# enough that a SIGKILLed worker goes suspect within the phase.
HEARTBEAT_DEADLINE_S = 5.0
MULTITENANT = {"tenants": 3, "rounds": 4, "workers": 2}
# Six matrices, so requests 4 and 5 are cold and come after the kill.
REPLICATED = {"replicas": 2, "transport": "process", "mode": "streaming", "matrices": 6,
              "requests": 12, "kill_after": 4, "heartbeat_deadline_s": HEARTBEAT_DEADLINE_S}
OVERLOAD = {"queue_bound": 4, "flood_clients": 6, "flood_requests_each": 4,
            "victim_rounds": 10, "stall_s": 0.03, "heartbeat_deadline_s": HEARTBEAT_DEADLINE_S}
# The LM serving paths, each at its published widths: path -> (arch, changes
# to its config, (batch, prompt tokens, generated tokens)).  qwen3-moe-30b-a3b
# is cut to 8 of its 48 layers (its 48 layers' f32 masters take 122 GB);
# mamba2-2.7b, qwen2-vl-2b and seamless-m4t-medium are served whole.
# jamba-1.5-large's whole period of 8 layers is 45.14 B parameters, 90.3 GB of
# bf16, more than one card holds: the hybrid path serves layers 0-4 of the
# published stack (Mamba x4, then attention at its published offset 4; FFNs
# MLP, MoE, MLP, MoE, MLP) as one period of five, 23,992,172,544 parameters.
LM_ARCH, SSM_ARCH = "qwen3-moe-30b-a3b", "mamba2-2.7b"
HYBRID_ARCH, MROPE_ARCH, ENCDEC_ARCH = "jamba-1.5-large-398b", "qwen2-vl-2b", "seamless-m4t-medium"
LM_TRAFFIC = (4, 2048, 32)
LM_PATHS = {"lm_serving": (LM_ARCH, {"n_layers": 8}, LM_TRAFFIC),
            "ssm_serving": (SSM_ARCH, {}, LM_TRAFFIC),
            "hybrid_serving": (HYBRID_ARCH, {"n_layers": 5, "attn_every": 5}, LM_TRAFFIC),
            "mrope_serving": (MROPE_ARCH, {}, LM_TRAFFIC),
            "encdec_serving": (ENCDEC_ARCH, {}, LM_TRAFFIC)}
HYBRID_PARAMS = 23_992_172_544  # the hybrid cut, as param_count counts it
# Teacher forcing of mamba2 at full width: a prompt that crosses the SSD
# chunk of 256 and is padded to two chunks.
SSM_TF_PROMPT = 300
# Teacher forcing of jamba at full width in float32: a period of two (a Mamba
# layer with its MLP, then attention with MoE) with 4 of the 16 experts,
# 4,651,657,216 parameters (18.6 GB).
JAMBA_TF = {"n_layers": 2, "attn_every": 2, "attn_offset": 1, "param_dtype": "float32",
            "compute_dtype": "float32"}
JAMBA_TF_EXPERTS = {"n_experts": 4, "capacity_factor": 16.0}
DEVICE = "cuda"
SPMV_KERNELS = ("spmv_software_cache", "spmv_streaming", "spmv_streaming_batched", "ep_combine")
# The kernels each serving phase after ``batched`` must launch: the bucketed
# lane in its mode, then the combine.
PATH_KERNELS = {"multitenant": ("spmv_software_cache", "ep_combine"),
                "replicated": ("spmv_streaming_batched", "ep_combine"),
                "overload": ("spmv_software_cache", "ep_combine")}
LM_KERNELS = ("flash_attention", "moe_mlp")
# The CUDA kernels each wrapper launches (bf16 for the LM ones), as the
# profiler names them.
SYMBOLS = {"spmv_software_cache": ("smem_kernel",), "spmv_streaming": ("stream_kernel",),
           "spmv_streaming_batched": ("stream_kernel",), "ep_combine": ("combine_kernel",),
           "flash_attention": ("flash_bf16_kernel",),
           "moe_mlp": ("gemm_bf16_kernel", "gemm_swap_bf16_kernel"),
           "flash_attention_train": ("flash_bf16_kernel",),
           "flash_attention_backward": ("dot_rows_kernel", "flash_dkv_kernel", "flash_dq_kernel"),
           "adamw_norm": ("adamw_norm_partial_kernel", "adamw_norm_sum_kernel",
                          "adamw_norm_finish_kernel"),
           "adamw_update": ("adamw_update_kernel",)}
# The libraries, each built from csrc/<name>.cu
LIBRARIES = ("adamw", "ep_spmv", "flash_attention", "flash_attention_bwd", "moe_mlp")
# The SASS instructions counted in every kernel (cuobjdump -sass), by name
# and pattern: Hopper's tensor-core and TMA-load instructions, and 16-byte
# global loads with any cache qualifier.  A kernel whose name holds a key of
# SASS_NEEDS must contain each of its instructions: the bf16 LM kernels run
# on wgmma and TMA, the streaming SpMV kernel streams its tasks and AdamW's
# norm and update their tensors 16 bytes a load.
SASS_OPS = {"HGMMA": r"\bHGMMA\b", "UTMALDG": r"\bUTMALDG\b",
            "LDG.128": r"\bLDG\.E\.(?:\w+\.)*128\b"}
SASS_NEEDS = {"bf16": ("HGMMA", "UTMALDG"), "flash_dkv_kernel": ("HGMMA", "UTMALDG"),
              "flash_dq_kernel": ("HGMMA", "UTMALDG"), "stream_kernel": ("LDG.128",),
              "adamw_norm_partial_kernel": ("LDG.128",), "adamw_update_kernel": ("LDG.128",)}
# The training attention at each benchmark cell's per-call shape: (B, H, Hkv,
# S = T, Dh, Dv), causal self-attention.
TRAIN_ATTENTION = {"qwen3moe.train": (4, 32, 4, 2048, 128, 128),
                   "moonlight.train-8k": (1, 16, 16, 8192, 192, 128)}
CHUNKED_ATTENTION = "src/repro/models/layers.py chunked_attention (pure JAX, under autograd)"


_T0 = time.perf_counter()


def _emit(obj) -> None:
    """One JSON line; a phase's line also holds the seconds since the script
    started (``at_s``)."""
    if "phase" in obj:
        obj = {**obj, "at_s": time.perf_counter() - _T0}
    print(json.dumps(obj, default=str), flush=True)


def _is_kernel(name, key) -> bool:
    """Whether the profiler's kernel ``key`` is one that wrapper ``name`` launches."""
    return any(sym in key for sym in SYMBOLS[name])


def sass_counts(name) -> dict:
    """SASS_OPS instructions in each kernel of ``csrc/<name>.cu``'s library
    (``cuobjdump -sass``), by the kernel's mangled name."""
    import re

    from repro_torch.kernels import _build

    counts, fn = {}, None
    for line in _build.sass(name).splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = counts.setdefault(m.group(1), dict.fromkeys(SASS_OPS, 0))
        elif fn is not None:
            for op, pattern in SASS_OPS.items():
                fn[op] += re.search(pattern, line) is not None
    return counts


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _coo_f64(n_rows, rows, cols, vals, x):
    import numpy as np

    return np.bincount(rows, weights=vals.astype(np.float64) * x.astype(np.float64)[cols],
                       minlength=n_rows)


def _check_y(y, n_rows, rows, cols, vals, x, what):
    import numpy as np

    got = y.double().cpu().numpy() if hasattr(y, "cpu") else y.astype(np.float64)
    if got.shape != (n_rows,) or not np.isfinite(got).all():
        raise AssertionError(f"{what}: y of shape {got.shape} is not {n_rows} finite values")
    np.testing.assert_allclose(got, _coo_f64(n_rows, rows, cols, vals, x), rtol=TOL, atol=TOL,
                               err_msg=what)


def _matrix(n_rows, n_cols, nnz_per_row, seed):
    import numpy as np

    from repro_torch.core import synthetic_bipartite_graph

    _, rows, cols = synthetic_bipartite_graph(n_rows, n_cols, nnz_per_row, seed=seed)
    vals = np.random.default_rng(seed + 1).standard_normal(rows.shape[0]).astype(np.float32)
    return rows, cols, vals


def phase_dedicated(svc, rng):
    import numpy as np
    import torch

    from repro_torch.runtime import GraphRequest, GraphServer

    n, k = DEDICATED
    rows, cols, vals = _matrix(n, n, 16, seed=0)
    out = {"phase": "dedicated", "n_rows": n, "n_cols": n, "nnz": int(rows.shape[0]), "k": k}
    for mode in ("software", "streaming"):
        server = GraphServer(svc, k=k, pad=128, mode=mode, start_batcher=False)
        times, plan_hits = [], []
        for i in range(5):
            x = rng.standard_normal(n).astype(np.float32)
            t0 = time.perf_counter()
            res = server.serve(GraphRequest(n, n, rows, cols, vals, x))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            plan_hits.append(res.info.cache_hit)
            if res.info.bucket is not None:
                raise AssertionError("the 4.2M-nnz matrix must take the dedicated lane")
            _check_y(res.y, n, rows, cols, vals, x, f"dedicated {mode} request {i}")
        plan = svc.lookup(res.info.fingerprint).plan
        out[mode] = {"cold_s": times[0], "warm_s": times[1:], "plan_cache_hits": plan_hits}
    out["tiles"] = {"e_max": plan.e_max, "x_max": plan.x_max, "y_max": plan.y_max}
    _emit(out)
    return plan, rows, cols, vals


def phase_graph_serving():
    from repro_torch.launch.serve import run_graph_serving

    n, k = SERVING
    stats = run_graph_serving(n_rows=n, n_cols=n, nnz_per_row=16, k=k, requests=8, churn=0.01,
                              keep_samples=True)
    if len(stats["compile_cache"]["buckets"]) != 1:
        raise AssertionError("the 1M-nnz matrix must take one bucket")
    samples = stats.pop("samples")
    if set(samples) != {"warm", "during_repartition", "post_swap"}:
        raise AssertionError(f"graph_serving kept samples {sorted(samples)}")
    for name, s in samples.items():  # the old matrix, then the churned one
        _check_y(s["y"], n, s["rows"], s["cols"], s["vals"], s["x"], f"graph_serving {name}")
    _emit({"phase": "graph_serving", "y_checked": sorted(samples), **stats})


def phase_batched(svc):
    import numpy as np
    import torch

    from repro_torch.runtime import GraphRequest, GraphServer

    n, k, b = BATCHED
    reqs, mats = [], []
    for i in range(b):
        rows, cols, vals = _matrix(n, n, 16, seed=100 + i)
        x = np.random.default_rng(200 + i).standard_normal(n).astype(np.float32)
        reqs.append(GraphRequest(n, n, rows, cols, vals, x))
        mats.append((rows, cols, vals, x))
    out = {"phase": "batched", "graphs": b, "n": n, "k": k}
    for mode in ("software", "streaming"):
        with GraphServer(svc, k=k, pad=128, mode=mode, max_batch=b,
                         max_wait_ms=300.0) as server:
            alone = [server.serve(r).y.cpu() for r in reqs]  # warms plans and operands
            barrier, results = threading.Barrier(b), [None] * b

            def client(i):
                barrier.wait()
                results[i] = server.submit(reqs[i]).wait(120.0)

            threads = [threading.Thread(target=client, args=(i,)) for i in range(b)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(180.0)
            elapsed = time.perf_counter() - t0
            if any(t.is_alive() for t in threads) or any(r is None for r in results):
                raise AssertionError(f"batched {mode}: a submitted request did not finish")
            sizes = [r.info.batch_size for r in results]
            if max(sizes) < 2:
                raise AssertionError(f"batched {mode}: no batch of more than one ({sizes})")
            for i, (r, y1) in enumerate(zip(results, alone)):
                _check_y(r.y, n, *mats[i], f"batched {mode} request {i}")
                if not torch.equal(r.y.cpu(), y1):
                    raise AssertionError(f"batched {mode}: stacked y != batch-of-1 y ({i})")
            spec = next(iter(server.stats()["buckets"].values()))
            plans = [(svc.lookup(r.info.fingerprint), req) for r, req in zip(results, reqs)]
        same_as_dedicated = None
        if mode == "software":
            dedicated = GraphServer(svc, k=k, pad=128, mode=mode, bucketing=None,
                                    start_batcher=False)
            for i, r in enumerate(reqs):
                if not torch.equal(dedicated.serve(r).y.cpu(), alone[i]):
                    raise AssertionError(f"bucketed y != dedicated y (request {i})")
            same_as_dedicated = True
        out[mode] = {"batch_sizes": sizes, "elapsed_s": elapsed,
                     "bucketed_equals_dedicated": same_as_dedicated,
                     "stacked_equals_batch_of_1": True, "bucket": spec}
    _emit(out)
    return plans


def _check_samples(samples, n, what) -> int:
    """Hold every sample that is not stale against the COO product; returns
    how many were checked."""
    checked = 0
    for i, smp in enumerate(samples):
        if smp["stale"]:
            continue
        _check_y(smp["y"], n, smp["rows"], smp["cols"], smp["vals"], smp["x"], f"{what} {i}")
        checked += 1
    return checked


def phase_multitenant():
    """Tenants competing for the plan cache; victims must stay warm."""
    from repro_torch.core import PartitionService, affinity_graph_from_coo
    from repro_torch.launch.serve import run_multitenant_graph_serving

    m, n = SLICE_MATRIX, SLICE_MATRIX["n_rows"]
    t0 = time.perf_counter()
    # The budget: 1.5x the largest victim plan's bytes as the plan cache
    # counts them (victim t serves seed 100 + t's matrix in the driver).
    with PartitionService(workers=2) as svc:
        tickets = []
        for t in range(1, MULTITENANT["tenants"]):
            rows, cols, _ = _matrix(n, n, m["nnz_per_row"], seed=100 + t)
            tickets.append(svc.submit(affinity_graph_from_coo(n, n, rows, cols), m["k"],
                                      pad=m["pad"], coo=(n, n, rows, cols)))
        victim_bytes = [tk.result(600).nbytes() for tk in tickets]
    budget_mb = 1.5 * max(victim_bytes) / 1e6
    t_budget = time.perf_counter() - t0
    report = run_multitenant_graph_serving(**MULTITENANT, **m, cache_budget_mb=budget_mb,
                                           keep_samples=True)
    samples = report.pop("samples")
    checked = sum(_check_samples(s, n, f"multitenant {name} request")
                  for name, s in samples.items())
    victims = {name: row for name, row in report["tenants"].items() if name != "tenant0"}
    for name, row in victims.items():
        if row["warm_hit_rate_after_round1"] != 1.0 or row["evictions"]:
            raise AssertionError(f"multitenant: victim {name} lost its warm plan: {row}")
    metrics = report.pop("metrics")
    return {"phase": "multitenant", **MULTITENANT, **m, "victim_plan_bytes": victim_bytes,
            "cache_budget_mb": budget_mb, "budget_s": t_budget, "y_checked": checked,
            "median_warm_ms": {name: row["median_warm_ms"]
                               for name, row in report["tenants"].items()},
            "tenant_cache": metrics["tenants"], **report,
            "seconds": time.perf_counter() - t0}


def phase_replicated():
    """Two replica worker processes, one SIGKILLed mid-stream."""
    from repro_torch.launch.serve import run_replicated_graph_serving

    m, n = SLICE_MATRIX, SLICE_MATRIX["n_rows"]
    t0 = time.perf_counter()
    report = run_replicated_graph_serving(**REPLICATED, **m, keep_samples=True)
    samples = report.pop("samples")
    checked = _check_samples(samples, n, "replicated request")
    if len(report["per_request"]) != REPLICATED["requests"] or checked != len(samples):
        raise AssertionError(f"replicated: {len(report['per_request'])} served, "
                             f"{checked} fresh of {REPLICATED['requests']}")
    if report["lost_tickets"] or report["stale_serves"] or report["killed_replica"] is None:
        raise AssertionError(f"replicated: lost {report['lost_tickets']}, stale "
                             f"{report['stale_serves']}, killed {report['killed_replica']}")
    # The group must have seen the kill: a cold request re-dispatched away
    # from the dead worker, or the worker drained from routing.
    killed = next(r for r in report["replica_table"] if r["replica"] == report["killed_replica"])
    if report["retries"] + report["failovers"] == 0 and killed["state"] == "healthy":
        raise AssertionError(f"replicated: the group never saw the kill of {killed}")
    return {"phase": "replicated", **m, "y_checked": checked, **report,
            "seconds": time.perf_counter() - t0}


def phase_overload():
    """A flooding tenant against bounded admission and the brownout ladder."""
    from repro_torch.launch.serve import run_overload_graph_serving

    m, n = SLICE_MATRIX, SLICE_MATRIX["n_rows"]
    t0 = time.perf_counter()
    report = run_overload_graph_serving(**OVERLOAD, **m, keep_samples=True)
    samples = report.pop("samples")
    flood = OVERLOAD["flood_clients"] * OVERLOAD["flood_requests_each"]
    answered = (report["flooder_admitted"] + report["flooder_rejections"]
                + report["flooder_brownout_rejects"])
    if answered != flood or len(samples["flooder"]) != report["flooder_admitted"]:
        raise AssertionError(f"overload: {answered} of {flood} flooder requests answered")
    victim = samples["victim"]
    if len(victim) != OVERLOAD["victim_rounds"] or not all(
            s["cache_hit"] and not s["degraded"] for s in victim):
        raise AssertionError(f"overload: {len(victim)} victim serves, not all warm and whole")
    checked = {who: _check_samples(s, n, f"overload {who} request")
               for who, s in samples.items()}
    if checked["flooder"] != report["flooder_admitted"]:
        raise AssertionError("overload: an admitted flooder request was served stale")
    return {"phase": "overload", **OVERLOAD, **m, "y_checked": checked, **report,
            "seconds": time.perf_counter() - t0}


def phase_profile(svc, big, small):
    """Where one warm request's time goes, in each lane.

    Wall time per request on the host clock (ending in a synchronize); the
    host's heaviest functions by self time (cProfile); and the device's busy
    time by kernel, memset and copy (torch.profiler), from which the idle
    share of the wall time follows.
    """
    import cProfile
    import pstats

    import numpy as np
    import torch

    from repro_torch.runtime import GraphRequest, GraphServer

    n, k = DEDICATED
    x = np.random.default_rng(9).standard_normal(n).astype(np.float32)
    lanes = {
        "dedicated": (GraphServer(svc, k=k, pad=128, start_batcher=False),
                      GraphRequest(n, n, *big, x)),
        "bucketed": (GraphServer(svc, k=BATCHED[1], pad=128, start_batcher=False), small),
    }
    reps = 3
    out = {"phase": "profile", "requests_per_lane": reps}

    def serve_all(server, req):
        for _ in range(reps):
            server.serve(req)
        torch.cuda.synchronize()

    for lane, (server, req) in lanes.items():
        serve_all(server, req)  # warm: plan, operands and callable cached
        t0 = time.perf_counter()
        serve_all(server, req)
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps

        host = cProfile.Profile()
        host.runcall(serve_all, server, req)
        stats = pstats.Stats(host).stats
        top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:10]
        host_top = [{"fn": f"{Path(f).name}:{line}({fn})", "self_ms": tt * 1e3 / reps,
                     "cum_ms": ct * 1e3 / reps} for (f, line, fn), (_, _, tt, ct, _) in top]

        device = _device_ms(lambda: server.serve(req), reps)
        busy_ms = sum(device.values()) if device else None  # None: the trace had no device
        out[lane] = {
            "nnz": int(req.rows.shape[0]), "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": None if busy_ms is None else 1.0 - busy_ms / wall_ms,
            "device_top": sorted(device.items(), key=lambda kv: -kv[1])[:8],
            "host_top_self": host_top,
        }
    _emit(out)


def _device_ms(fn, reps):
    """Device time per call of ``fn``, by kernel, memset and copy (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out[e.key] = out.get(e.key, 0.0) + e.self_device_time_total / 1e3 / reps
    return out


def _time_ms(fn, iters):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _bound(nbytes, flops, peak_flops=F32_FLOPS):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak_flops
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def _csr(n_rows, n_cols, rows, cols, vals, dev):
    """The matrix as one torch.sparse_csr_tensor (the library yardstick)."""
    import numpy as np
    import torch

    order = np.lexsort((cols, rows))
    crow = np.zeros(n_rows + 1, dtype=np.int64)
    crow[1:] = np.cumsum(np.bincount(rows, minlength=n_rows))
    return torch.sparse_csr_tensor(
        torch.from_numpy(crow), torch.from_numpy(cols[order].astype(np.int64)),
        torch.from_numpy(vals[order]), (n_rows, n_cols), check_invariants=False).to(dev)


def phase_kernels(plan, big, batched_plans, launches):
    """Each SpMV kernel at the main path's shapes against its twin, timed."""
    import importlib

    import numpy as np
    import torch

    from repro_torch.kernels.ops import pad_plan_operands
    from repro_torch.runtime import BucketPolicy

    K = importlib.import_module("repro_torch.kernels.ep_spmv")
    dev = torch.device(DEVICE)
    cu = "src/repro_torch/kernels/csrc/ep_spmv.cu"
    entries = []

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def entry(name, replaces, run, plain, nbytes, flops, library, shapes):
        entries.append(_kernel_entry(name, replaces, cu, launches[name], run, plain, library,
                                     nbytes, flops, shapes, tol=TOL, peak_flops=F32_FLOPS,
                                     iters=100))

    # Bounds count the bytes this run's data needs, each read or written
    # once: per valid task its value and x index (8 B; plan padding is in no
    # run, so no kernel reads it), one run offset per occupied y slot (4 B),
    # each x entry some task reads (4 B) and the (k, y_max) output (4 B each).
    def spmv_bytes(tasks, y_used, x_used, out):
        return 8 * tasks + 4 * y_used + 4 * x_used + 4 * out

    # Kernels 1, 2 and the combine at the dedicated phase's plan.
    rows, cols, vals = big
    k, e_max, x_max, y_max = plan.k, plan.e_max, plan.x_max, plan.y_max
    n_rows, n_cols = plan.n_rows, plan.n_cols
    tasks, y_used = int(plan.e_count.sum()), int(plan.y_count.sum())
    x = t(np.random.default_rng(5).standard_normal(n_cols).astype(np.float32))
    vp = t(plan.pack_values(vals))
    xl, yl = t(plan.x_lidx.astype(np.int32)), t(plan.y_lidx.astype(np.int32))
    xg = t(plan.x_gidx.astype(np.int32))
    x_packed = x[xg.long()]
    xg_task = torch.gather(xg, 1, xl.long())
    seg = K.tile_order(yl, y_max, t(plan.edge_valid))  # as make_ep_spmv_fn builds it
    a = _csr(n_rows, n_cols, rows, cols, vals, dev)
    xcol = x.unsqueeze(1)
    shapes = {"k": k, "e_max": e_max, "x_max": x_max, "y_max": y_max, "n_cols": n_cols,
              "valid_tasks": tasks, "y_used": y_used}
    entry("spmv_software_cache", "src/repro/kernels/ep_spmv.py:65",
          lambda: K.spmv_software_cache(vp, xl, yl, x_packed, y_max, seg=seg),
          lambda: K.software_cache_plain(vp, xl, yl, x_packed, y_max, seg),
          spmv_bytes(tasks, y_used, int(plan.x_count.sum()), k * y_max), 2 * tasks,
          lambda: a @ xcol, {**shapes, "x_used": int(plan.x_count.sum())})
    cols_used = int(np.unique(cols).size)
    entry("spmv_streaming", "src/repro/kernels/ep_spmv.py:90",
          lambda: K.spmv_streaming(vp, xg_task, yl, x, y_max, seg=seg),
          lambda: K.streaming_plain(vp, xg_task, yl, x, y_max, seg),
          spmv_bytes(tasks, y_used, cols_used, k * y_max), 2 * tasks,
          lambda: a @ xcol, {**shapes, "x_used": cols_used})

    # Kernel 3 at the batched phase's bucket: 8 plans stacked, streaming mode.
    policy = BucketPolicy()
    spec = policy.bucket_for(batched_plans[0][0].padding, "streaming").spec(
        len(batched_plans), pad=128, slack=policy.balance_slack)
    ops = [pad_plan_operands(sp.plan, req.vals, spec) for sp, req in batched_plans]
    v3, yl3 = t(np.stack([o.vals for o in ops])), t(np.stack([o.y_lidx for o in ops]))
    xg3 = torch.gather(t(np.stack([o.x_gidx for o in ops])), 2,
                       t(np.stack([o.x_lidx for o in ops])).long())
    x3 = torch.zeros((spec.batch, spec.n_cols), device=dev)  # zero-padded to the bucket
    for i, (_, req) in enumerate(batched_plans):
        x3[i, : req.n_cols] = t(req.x)
    seg3 = t(np.stack([o.seg for o in ops]))
    tasks3 = sum(int(sp.plan.e_count.sum()) for sp, _ in batched_plans)
    y_used3 = sum(int(sp.plan.y_count.sum()) for sp, _ in batched_plans)
    cols_used3 = sum(int(np.unique(req.cols).size) for _, req in batched_plans)
    nb = batched_plans[0][1].n_rows
    brows = np.concatenate([req.rows + i * nb for i, (_, req) in enumerate(batched_plans)])
    bcols = np.concatenate([req.cols + i * nb for i, (_, req) in enumerate(batched_plans)])
    bvals = np.concatenate([req.vals for _, req in batched_plans])
    a3 = _csr(nb * spec.batch, nb * spec.batch, brows, bcols, bvals, dev)
    x3col = x3[:, :nb].reshape(-1, 1)
    entry("spmv_streaming_batched", "src/repro/kernels/ep_spmv.py:127",
          lambda: K.spmv_streaming_batched(v3, xg3, yl3, x3, spec.y_max, seg=seg3),
          lambda: K.streaming_batched_plain(v3, xg3, yl3, x3, spec.y_max, seg3),
          spmv_bytes(tasks3, y_used3, cols_used3, spec.batch * spec.k * spec.y_max),
          2 * tasks3, lambda: a3 @ x3col,
          {"batch": spec.batch, "k": spec.k, "e_max": spec.e_max, "y_max": spec.y_max,
           "n_cols": spec.n_cols, "valid_tasks": tasks3, "y_used": y_used3,
           "x_used": cols_used3})

    # The streaming kernels keep the twin's bits: each y slot sums its run in
    # task order with the same roundings, so the card's partials equal the
    # twin's run on the CPU on host copies of the same tensors.
    def cpu(*ts):
        return [a.cpu() for a in ts]

    streams = {
        "spmv_streaming": (
            K.spmv_streaming(vp, xg_task, yl, x, y_max, seg=seg),
            K.streaming_plain(*cpu(vp, xg_task, yl, x), y_max, seg.cpu())),
        "spmv_streaming_batched": (
            K.spmv_streaming_batched(v3, xg3, yl3, x3, spec.y_max, seg=seg3),
            K.streaming_batched_plain(*cpu(v3, xg3, yl3, x3), spec.y_max, seg3.cpu())),
    }
    for en in entries:
        if en["name"] in streams:
            got, want = streams[en["name"]]
            got = got.cpu()
            if not torch.equal(got, want):
                raise AssertionError(f"{en['name']}: partials differ from the CPU twin's bits "
                                     f"(max abs {(got - want).abs().max().item()})")
            en["bits_equal_cpu_twin"] = True
    del streams

    # The combine of the dedicated phase's partials: per table entry one
    # partial and its index (8 B), the row pointers and y (4 B each).
    partials = K.spmv_software_cache(vp, xl, yl, x_packed, y_max, seg=seg)
    yg = t(plan.y_gidx.astype(np.int32))
    row_ptr, src = K.combine_table(yg, n_rows)
    n_entries = int(src.shape[0])
    y_acc = torch.zeros(n_rows + 1, device=dev)
    yg_flat, p_flat = yg.reshape(-1).long(), partials.reshape(-1)
    entry("ep_combine", "src/repro/kernels/ops.py:288",
          lambda: K.ep_combine(partials, row_ptr, src, n_rows),
          lambda: K.combine_plain(partials, row_ptr, src, n_rows),
          8 * n_entries + 4 * (n_rows + 1) + 4 * n_rows, n_entries,
          lambda: y_acc.index_add_(0, yg_flat, p_flat),
          {"k": k, "y_max": y_max, "n_rows": n_rows, "entries": n_entries})
    return entries


# ---------------------------------------------------------------------------
# LM serving: prefill + greedy decode of qwen3-moe-30b-a3b
# ---------------------------------------------------------------------------


def phase_serving(path):
    """One LM serving path of ``LM_PATHS`` through ``serve_config`` (what
    ``run_serving`` hands a resolved config to), launches counted.

    Weights drawn on the card from seed 0 (f32 masters and bf16 compute
    copies, routers and SSD rates kept f32, cast once before the prompts:
    ``cast_ms``; jamba's masters are bf16 as published, so its copies are the
    masters), a batch of seeded prompts behind the config's front-end stub,
    prefill, then greedy decode.  ``lm_serving``: qwen3-moe-30b-a3b (d_model
    2,048, 32 / 4 heads of 128, 128 experts top-8 of 768, vocab 151,936), 8
    layers.  ``ssm_serving``: mamba2-2.7b whole (64 layers, d_model 2,560,
    80 SSD heads of 64, d_state 128, chunk 256, vocab 50,280).
    ``hybrid_serving``: jamba-1.5-large (d_model 8,192; 64 / 8 heads of 128;
    d_ff 24,576; 16 experts top-2 of 24,576; SSD d_inner 16,384 in 256 heads
    of 64; vocab 65,536), layers 0-4 as one period of five.
    ``mrope_serving``: qwen2-vl-2b whole (28 layers), behind the vision stub
    (embeddings, M-RoPE positions).  ``encdec_serving``: seamless-m4t-medium
    whole (12 + 12 layers), behind the audio stub (the encoder's frames, the
    decoder's tokens).  Counts are set to 0 just before and read just after,
    and must equal :func:`_expected_launches`; the parameters must number
    what the config counts.  The expert ids each MoE layer routed to are
    recorded (``recorded_routing``), and the experts each served decode step
    read are returned, step by step and MoE layer by MoE layer.
    """
    import dataclasses

    import torch

    from repro_torch.configs import get_config, param_count
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import serve_config
    from repro_torch.models.moe import recorded_routing
    from repro_torch.models.transformer import moe_capacity

    arch, changes, (b, s, gen) = LM_PATHS[path]
    cfg = dataclasses.replace(get_config(arch), **changes)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    with recorded_routing() as routed:
        tokens, stats, state = serve_config(cfg, b, s, gen, seed=0)
    launches = launch_counts()
    n_moe = cfg.ffn_kinds().count("moe")
    if len(routed) != n_moe * gen:
        raise AssertionError(f"{path}: {len(routed)} routings, expected {n_moe} a step")
    experts_read = [[int(torch.unique(ids).numel()) for ids in routed[i:i + n_moe]]
                    for i in range(n_moe, len(routed), n_moe)] if n_moe else []  # decode steps
    del routed
    want = _expected_launches(cfg, gen)
    if any(launches[name] != want.get(name, 0) for name in launches):
        raise AssertionError(f"{path} launches {launches}, expected {want}")
    if (tuple(tokens.shape) != (b, gen) or int(tokens.min()) < 0
            or int(tokens.max()) >= cfg.vocab_size):
        raise AssertionError(f"{path} tokens {tuple(tokens.shape)} out of range")
    n_params = sum(p.numel() for p in state["params"].parameters())
    # param_count (copied verbatim from the reference) leaves out encdec's
    # enc_final_norm, d_model weights.
    counted = param_count(cfg)["total"] + (cfg.d_model if cfg.family == "encdec" else 0)
    if n_params != counted or (path == "hybrid_serving" and n_params != HYBRID_PARAMS):
        raise AssertionError(f"{path}: {n_params} parameters, the config counts {counted}")
    capacity = cfg.moe and {"prefill": moe_capacity(cfg, b * s), "decode": moe_capacity(cfg, b)}
    _emit({"phase": path, "arch": cfg.name, "layers": cfg.n_layers,
           "of_layers": get_config(arch).n_layers, "encoder_layers": cfg.n_encoder_layers,
           "layer_kinds": cfg.layer_kinds(), "ffn_kinds": cfg.ffn_kinds(),
           "d_model": cfg.d_model, "vocab": cfg.vocab_size,
           "ssm": cfg.ssm and dataclasses.asdict(cfg.ssm), "capacity": capacity,
           "params": n_params, "param_dtype": cfg.param_dtype,
           "inputs": {k: list(v.shape) for k, v in state["inputs"].items()},
           "batch": b, "prompt_len": s, "gen": gen,
           "cast_ms": stats["cast_s"] * 1e3, "prefill_ms": stats["prefill_s"] * 1e3,
           "decode_ms_per_token": stats["decode_s"] * 1e3 / (gen - 1),
           "tok_per_s": stats["tok_per_s"], "launches": launches,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "tokens_head": tokens[0, :8].tolist()})
    return cfg, state, launches, experts_read


def bf16_scaled_err(got, want, whole=False) -> float:
    """The worst ``|got - want| / (BF16_RTOL |want| + BF16_ROW rms(want's row))``:
    at most 1 passes.  With ``whole`` the rms is the whole tensor's, not a
    row's (a gradient's row may be exactly zero where the kernel's holds
    rounding: the first query's dS is p (dP - D) = 0)."""
    import torch

    w = want.double()
    err = (got.double() - w).abs()
    rms = w.square().mean().sqrt() if whole else w.square().mean(-1, keepdim=True).sqrt()
    limit = BF16_RTOL * w.abs() + BF16_ROW * rms
    return torch.where(err == 0, 0.0, err / limit).max().item()


def _held_to(label, got, want, tol, whole):
    """``got`` against ``want``: finite, within ``tol`` (relative and
    absolute) and, in bf16, within :func:`bf16_scaled_err`'s limit.
    Returns the largest absolute error and the scaled error (None unless
    bf16)."""
    import torch

    if not torch.isfinite(got).all():
        raise AssertionError(f"{label}: non-finite output")
    err = (got.double() - want.double()).abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol,
                               msg=lambda m: f"{label}: {m}")
    scaled = bf16_scaled_err(got, want, whole) if got.dtype == torch.bfloat16 else None
    if scaled is not None and scaled > 1:
        raise AssertionError(f"{label}: error up to {scaled:.3g} times "
                             f"{BF16_RTOL} |want| + {BF16_ROW} rms")
    return err, scaled


def _kernel_entry(name, replaces, source, launches, run, plain, library, nbytes, flops,
                  shapes, *, tol, peak_flops, iters, outputs=None, whole=False, wrappers=None):
    """One kernel against its twin on the same card tensors, then timed.

    ``ms`` is CUDA events over ``iters`` back-to-back launches (never below
    the wrapper's host cost per launch); ``device_ms`` the kernel alone (the
    kernels of every wrapper in ``wrappers``, default ``name``'s) from
    the profiler's trace; ``bound_ms`` the larger of ``nbytes`` over the
    memory rate and ``flops`` over ``peak_flops``.  Each output is held to
    :func:`_held_to` (``whole``: the scaled limit over the whole tensor's
    rms).  Where ``run`` and ``plain`` return tuples, ``outputs`` names
    their parts, ``tol`` is a dict by name, and the errors are dicts.
    """
    import torch

    got, want = run(), plain()
    torch.cuda.synchronize()
    if outputs is None:
        err, scaled = _held_to(f"{name} {shapes}", got, want, tol, whole)
    else:
        held = {o: _held_to(f"{name} {o} {shapes}", g, w, tol[o], whole)
                for o, g, w in zip(outputs, got, want, strict=True)}
        err = {o: e for o, (e, _) in held.items()}
        scaled = {o: sc for o, (_, sc) in held.items()}
    del got, want
    ms = _time_ms(run, iters)
    reps = max(5, iters // 5)
    for _ in range(3):  # a trace now and then holds no device events of a short kernel
        device_ms = sum(v for key, v in _device_ms(run, reps).items()
                        if any(_is_kernel(w, key) for w in wrappers or (name,)))
        if device_ms:
            break
    bound_ms, bound_by = _bound(nbytes, flops, peak_flops)
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": err, "tol": tol, "scaled_err": scaled,
            "ms": ms,
            "device_ms": device_ms or None, "plain_ms": _time_ms(plain, max(3, iters // 5)),
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": _time_ms(library, iters),
            "bytes": nbytes, "flops": flops, "shapes": shapes}


def _randn(gen, shape, dtype=None, scale=1.0):
    """Seeded normal values drawn on the card (bf16 unless ``dtype``)."""
    import torch

    return (torch.randn(shape, generator=gen, device=gen.device) * scale).to(
        dtype or torch.bfloat16)


def _flash_entry(q, k, v, causal, launches, iters=20, **library_kw):
    """flash_attention on ``q (B, H, S, Dh)`` over un-repeated ``k, v (B, Hkv,
    T, Dh)`` against its twin, timed.  Bound: the two products over the
    pairs it must compute (i >= j when causal) on the tensor cores; q, k, v
    read and o written once.  Library: SDPA."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref

    b, h, s, dh = q.shape
    t = k.shape[2]
    pairs = sum(min(i + 1, t) for i in range(s)) if causal else s * t
    return _kernel_entry(
        "flash_attention", "src/repro/kernels/flash_attention.py:77",
        "src/repro_torch/kernels/csrc/flash_attention.cu", launches,
        lambda: flash_attention(q, k, v, causal=causal),
        lambda: flash_attention_ref(q, k, v, causal),
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal, **library_kw),
        2 * (q.numel() + k.numel() + v.numel() + q.numel()), 4 * b * h * dh * pairs,
        {"B": b, "H": h, "Hkv": k.shape[1], "S": s, "T": t, "Dh": dh, "causal": causal},
        tol=BF16_TOL, peak_flops=BF16_FLOPS, iters=iters)


def _moe_entry(x, wg, wu, wd, launches, iters, experts=None, rows=None, twin_chunk=None):
    """moe_mlp on the slab ``x (E, C, D)`` against its twin, timed.  Bound:
    three products per slab row that holds a token (``rows``, all E * C by
    default) on the tensor cores; x read, the output written and the weights
    of every expert that has to be computed (``experts``, all E by default)
    read once.  Library: three ``bmm`` and a SiLU.  ``twin_chunk`` runs the
    twin (which upcasts every weight to float32) that many experts at a time,
    where the whole upcast would not fit beside the model."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import moe_mlp
    from repro_torch.kernels.ref import moe_mlp_ref

    e, cap, d = x.shape
    f = wg.shape[-1]
    experts = e if experts is None else experts
    rows = e * cap if rows is None else rows
    step = twin_chunk or e

    def plain():
        return torch.cat([moe_mlp_ref(x[i:i + step], wg[i:i + step], wu[i:i + step],
                                      wd[i:i + step]) for i in range(0, e, step)])

    def library():
        return torch.bmm(F.silu(torch.bmm(x, wg)) * torch.bmm(x, wu), wd)

    return _kernel_entry(
        "moe_mlp", "src/repro/kernels/moe_mlp.py:37",
        "src/repro_torch/kernels/csrc/moe_mlp.cu", launches,
        lambda: moe_mlp(x, wg, wu, wd), plain, library,
        2 * (2 * e * cap * d + 3 * experts * d * f), 6 * rows * d * f,
        {"E": e, "C": cap, "D": d, "F": f, "experts_computed": experts, "rows": rows},
        tol=BF16_TOL, peak_flops=BF16_FLOPS, iters=iters)


def _routed_decode_entry(moe, cfg, b, gen, launches, twin_chunk=None):
    """moe_mlp on a decode slab routed as moe_ffn routes it: ``b`` tokens
    through ``moe``'s router, dispatched at the decode capacity; the bound
    counts only the experts that hold a pair."""
    import torch

    from repro_torch.models.moe import dispatch, route
    from repro_torch.models.transformer import moe_capacity

    e = moe.w_gate.shape[0]
    tokens = _randn(gen, (b, moe.w_gate.shape[1]), moe.w_gate.dtype)
    _, _, ids = route(tokens, moe.router, cfg.moe.top_k)
    slab, _, keep = dispatch(tokens, ids, e, moe_capacity(cfg, b))
    occupied = int(torch.unique(ids).numel())
    return _moe_entry(slab, moe.w_gate, moe.w_up, moe.w_down, launches, 20,
                      experts=occupied, rows=int(keep.sum()), twin_chunk=twin_chunk), occupied


def phase_train_kernels():
    """The training attention's kernels at each cell's per-call shape
    (``TRAIN_ATTENTION``), bf16, against their twins, timed: the forward
    with its log-sum-exp (``flash_attention_train``) and the backward
    (``flash_attention_backward``: D, dK and dV, dQ).

    Each is held by :func:`_kernel_entry` to its twin: the forward's output
    as the prefill's, its float32 ``lse`` (natural log, O(log T)) to
    ``LSE_TOL``; the backward's dq, dk and dv (scaled by each tensor's rms)
    against the twin given the kernel's output (an input of the backward,
    which the two forwards round at different places: p before or after
    its normalisation) and the twin's own ``lse`` (a function of q and k
    alone), so a wrong ``lse`` shows in the gradients too.  Two backward
    calls must give the same bits.  Bounds on the tensor cores: the
    forward's two products over the causal pairs, ``2 pairs (Dh + Dv)``
    operations; the backward's seven (S, dP, dV, and dK and dQ as two bf16
    halves of dS each), ``2 pairs (5 Dh + 2 Dv)``; the design's second S
    and dP (one in each of its two kernels) are its own cost, not the
    bound's.  Bytes: each input read and
    each output written once.  The plain versions are the twins (one head
    at a time); the library, as a yardstick only, SDPA's forward and, for
    the backward, SDPA's backward pass alone (its graph kept and run again);
    the port never calls it.  The first cell's shape is the training path's
    (``training``); the others are nested entries that no path runs.
    Returns the two entries."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention_backward, flash_attention_train
    from repro_torch.kernels.ref import flash_attention_backward_ref, flash_attention_train_ref

    gen = torch.Generator(device=DEVICE).manual_seed(29)
    entries = {}
    for cell, (b, h, hkv, s, dh, dv) in TRAIN_ATTENTION.items():
        q, k = _randn(gen, (b, h, s, dh)), _randn(gen, (b, hkv, s, dh))
        v, do = _randn(gen, (b, hkv, s, dv)), _randn(gen, (b, h, s, dv))
        pairs = b * h * s * (s + 1) // 2
        gqa = {"enable_gqa": True} if hkv != h else {}
        shapes = {"cell": cell, "B": b, "H": h, "Hkv": hkv, "S": s, "T": s, "Dh": dh, "Dv": dv,
                  "causal": True}
        out, lse = flash_attention_train(q, k, v, True)
        _, want_lse = flash_attention_train_ref(q, k, v, True)
        grads = flash_attention_backward(q, k, v, out, lse, do, True)
        again = flash_attention_backward(q, k, v, out, lse, do, True)
        if not all(torch.equal(x, y) for x, y in zip(grads, again)):
            raise AssertionError(f"{cell}: two backward calls differ")
        del grads, again
        qg, kg, vg = (x.detach().clone().requires_grad_() for x in (q, k, v))
        lib_out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True, **gqa)
        forward = _kernel_entry(
            "flash_attention_train", CHUNKED_ATTENTION, "src/repro_torch/kernels/csrc/"
            "flash_attention.cu", 0, lambda: flash_attention_train(q, k, v, True),
            lambda: flash_attention_train_ref(q, k, v, True),
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, **gqa),
            2 * (q.numel() + k.numel() + v.numel() + out.numel()) + 4 * lse.numel(),
            2 * pairs * (dh + dv), shapes, tol={"out": BF16_TOL, "lse": LSE_TOL},
            peak_flops=BF16_FLOPS, iters=10, outputs=("out", "lse"))
        backward = _kernel_entry(
            "flash_attention_backward", CHUNKED_ATTENTION, "src/repro_torch/kernels/csrc/"
            "flash_attention_bwd.cu", 0,
            lambda: flash_attention_backward(q, k, v, out, lse, do, True),
            lambda: flash_attention_backward_ref(q, k, v, out, want_lse, do, True),
            lambda: lib_out.backward(do, retain_graph=True),
            2 * (2 * (q.numel() + k.numel() + v.numel()) + 2 * out.numel()) + 8 * lse.numel(),
            2 * pairs * (5 * dh + 2 * dv), shapes, tol=dict.fromkeys(("dq", "dk", "dv"), BF16_TOL),
            peak_flops=BF16_FLOPS, iters=10, outputs=("dq", "dk", "dv"), whole=True)
        for en in (forward, backward):
            _emit({"phase": "train_kernels", **en})
            if entries.get(en["name"]) is None:
                entries[en["name"]] = en
            else:
                entries[en["name"]][cell] = {**en, "path": None}
        del q, k, v, do, out, lse, want_lse, qg, kg, vg, lib_out
        torch.cuda.empty_cache()
    adamw = _adamw_entry()
    _emit({"phase": "train_kernels", **adamw})
    return [*entries.values(), adamw]


def _adamw_entry():
    """AdamW's kernels (``adamw_norm``, then ``adamw_update`` on each leaf) at
    the qwen cell's own leaf shapes (``TRAIN``'s cut: 51 float32 leaves,
    3,114,814,464 parameters), one optimizer step timed, against the loop
    of ATen passes (``global_norm`` and ``_plain_update``, the kernels' twin)
    on the same tensors.  Each run returns the norm, which both hold to
    ``TOL``; the update itself is held on copies of the four smallest leaves
    and the largest (``update_err``: of p, m and v, the largest difference
    between the kernel's change and the loop's over the loop's largest
    change, given the same clip scale, to ``TOL``: a dropped decay or a
    wrong lr reads ~0.1 or more, however small the step).  Bound: 32 bytes a
    parameter (g read for the norm; p, g, m, v read and p, m, v written).
    The library, as a yardstick only, ``torch._fused_adamw_`` on the same
    tensors (no norm, no clip); the port never calls it."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import adamw_norm, adamw_update
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig, global_norm, warmup_cosine
    from repro_torch.optim.adamw import _clip_scale, _plain_update

    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=TRAIN["n_layers"])
    shapes = [p.shape for p in Model(cfg, "meta").init(0).parameters()]
    opt = AdamWConfig(lr=warmup_cosine(3e-4, 2, TRAIN["steps"]))
    gen = torch.Generator(device=DEVICE).manual_seed(31)
    ps = [_randn(gen, sh, torch.float32) for sh in shapes]
    gs = [_randn(gen, sh, torch.float32, 1e-4) for sh in shapes]
    ms = [_randn(gen, sh, torch.float32, 1e-5) for sh in shapes]
    vs = [_randn(gen, sh, torch.float32, 1e-5).square_() for sh in shapes]
    count = torch.full((), 7, dtype=torch.int32, device=DEVICE)
    lr, cf = opt.lr_at(count), count.float()
    bc1, bc2 = 1.0 - torch.pow(opt.b1, cf), 1.0 - torch.pow(opt.b2, cf)
    hyper = {"b1": opt.b1, "b2": opt.b2, "eps": opt.eps, "weight_decay": opt.weight_decay}
    n = sum(p.numel() for p in ps)

    def fused():
        norm, scale = adamw_norm(gs, opt.clip_norm)
        for leaf in zip(ps, gs, ms, vs):
            adamw_update(*leaf, scale, lr, bc1, bc2, **hyper)
        return norm

    def plain():
        norm = global_norm(gs)
        scale = _clip_scale(opt, norm)
        for leaf in zip(ps, gs, ms, vs):
            _plain_update(opt, *leaf, scale, lr, bc1, bc2)
        return norm

    steps = [torch.full((), 7.0, device=DEVICE) for _ in ps]

    def library():
        torch._fused_adamw_(ps, gs, ms, vs, [], steps, lr=3e-4, beta1=opt.b1, beta2=opt.b2,
                            weight_decay=opt.weight_decay, eps=opt.eps, amsgrad=False,
                            maximize=False)

    order = sorted(range(len(ps)), key=lambda i: ps[i].numel())
    _, scale = adamw_norm(gs, opt.clip_norm)
    errs = []
    for i in order[:4] + order[-1:]:
        a = [x[i].clone() for x in (ps, gs, ms, vs)]
        b = [x.clone() for x in a]
        adamw_update(*a, scale, lr, bc1, bc2, **hyper)
        _plain_update(opt, *b, scale, lr, bc1, bc2)
        for j, old in ((0, ps[i]), (2, ms[i]), (3, vs[i])):  # p, m and v: their changes
            da, db = a[j].sub_(old), b[j].sub_(old)
            errs.append(float((da - db).abs().max() / db.abs().max().clamp(min=1e-30)))
        del a, b
    if max(errs) > TOL:
        raise AssertionError(f"adamw_update against the loop: {max(errs)}")
    entry = _kernel_entry(
        "adamw_update", "none: src/repro/optim/adamw.py adamw_update (plain jnp)",
        "src/repro_torch/kernels/csrc/adamw.cu", 0, fused, plain, library, 32 * n, 0,
        {"cell": "qwen3moe.train", "leaves": len(ps), "params": n, "dtype": "float32"},
        tol=TOL, peak_flops=F32_FLOPS, iters=5, wrappers=("adamw_norm", "adamw_update"))
    entry["update_err"] = max(errs)
    del ps, gs, ms, vs
    torch.cuda.empty_cache()
    return entry


def phase_lm_kernels(cfg, state, launches):
    """flash_attention and moe_mlp at the lm_serving shapes, bf16, against
    their twins (5e-2, and 1e-2 |want| + 5e-2 rms(row) elementwise), timed beside their
    bounds and one library call; and each in float32 at a smaller shape
    against its twin (2e-5, no TF32).

    Flash attention on the un-repeated K/V the prefill passes (Hkv = 4; the
    main entry) and on head-repeated K/V (``head_repeated``, the reference's layout).
    The expert FFN at the prefill capacity (the main entry), and at the
    decode capacity on a dense random slab (``decode``, every expert busy) and on a
    routed slab built as moe_ffn builds it, 4 tokens through layer 0's router
    (``decode_routed``), whose bound counts only the experts that hold a pair.
    """
    import torch

    from repro_torch.kernels import flash_attention, moe_mlp
    from repro_torch.kernels.ref import flash_attention_ref, moe_mlp_ref
    from repro_torch.models.transformer import moe_capacity

    dev = torch.device(DEVICE)
    b, s, _ = LM_PATHS["lm_serving"][2]
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    gen = torch.Generator(device=dev).manual_seed(7)

    def randn(shape, dtype=torch.bfloat16, scale=1.0):
        return _randn(gen, shape, dtype, scale)

    entries = []
    q, k, v = randn((b, h, s, dh)), randn((b, hkv, s, dh)), randn((b, hkv, s, dh))
    flash = _flash_entry(q, k, v, True, launches["flash_attention"], enable_gqa=True)
    g = h // hkv
    flash["head_repeated"] = _flash_entry(q, k.repeat_interleave(g, 1).contiguous(),
                                          v.repeat_interleave(g, 1).contiguous(), True,
                                          launches["flash_attention"])
    flash["head_repeated"]["path"] = None  # the reference's layout; no path runs it
    entries.append(flash)
    del q, k, v

    # The expert FFN on layer 0's bf16 expert weights.
    moe = state["compute"].blocks[0].ffn.moe
    wg, wu, wd = moe.w_gate, moe.w_up, moe.w_down
    e, d, f = wg.shape
    n = launches["moe_mlp"]
    prefill = _moe_entry(randn((e, moe_capacity(cfg, b * s), d), wg.dtype), wg, wu, wd, n, 10)
    prefill["decode"] = _moe_entry(randn((e, moe_capacity(cfg, b), d), wg.dtype), wg, wu, wd,
                                   n, 20)
    routed, occupied = _routed_decode_entry(moe, cfg, b, gen, n)
    routed["bound_all_experts_ms"] = prefill["decode"]["bound_ms"]
    prefill["decode_routed"] = routed
    prefill["decode"]["path"] = routed["path"] = "lm_serving"
    entries.append(prefill)

    # float32 at smaller shapes, no TF32 in the twins' products.
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    f32 = {}
    q = randn((1, 4, 256, dh), torch.float32)
    k, v = (randn((1, 2, 256, dh), torch.float32) for _ in range(2))  # 2 kv heads
    got, want = flash_attention(q, k, v, causal=True), flash_attention_ref(q, k, v, True)
    torch.testing.assert_close(got, want, rtol=F32_TOL, atol=F32_TOL)
    f32["flash_attention"] = {"shape": [1, 4, 256, dh], "kv_heads": 2,
                              "max_abs_err": (got - want).abs().max().item(),
                              "out_abs_max": got.abs().max().item()}
    x = randn((8, 64, d), torch.float32)
    w = [randn(shape, torch.float32, shape[1] ** -0.5)
         for shape in ((8, d, f), (8, d, f), (8, f, d))]
    got, want = moe_mlp(x, *w), moe_mlp_ref(x, *w)
    torch.testing.assert_close(got, want, rtol=F32_TOL, atol=F32_TOL)
    f32["moe_mlp"] = {"shape": [8, 64, d, f], "max_abs_err": (got - want).abs().max().item(),
                      "out_abs_max": got.abs().max().item()}
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    _emit({"phase": "lm_kernels", "tol": {"bf16": BF16_TOL, "bf16_rtol": BF16_RTOL,
                                          "bf16_row": BF16_ROW, "f32": F32_TOL},
           "f32": f32,
           "bf16": {en["name"]: [en["max_abs_err"], en["scaled_err"]] for en in entries},
           "flash_head_repeated_bf16": [flash["head_repeated"]["max_abs_err"],
                                        flash["head_repeated"]["scaled_err"]],
           "moe_decode_bf16": [prefill["decode"]["max_abs_err"],
                               prefill["decode"]["scaled_err"]],
           "moe_decode_routed_bf16": [routed["max_abs_err"], routed["scaled_err"]],
           "occupied_experts": occupied})
    return entries


def phase_lm_profile(cfg, state, path, experts_read):
    """Where a warm prefill and a warm decode step of ``path`` spend their time.

    Wall time on the host clock (ending in a synchronize), and the device's
    busy time by kernel from torch.profiler, whose ratio to the wall time
    gives the device's idle share.  The warm prefill's logits are checked
    for shape and finiteness.  The line also holds :func:`_serving_bounds`,
    whose decode bound counts the experts the served decode steps read
    (``experts_read``, from :func:`phase_serving`).
    """
    import time as _time

    import torch

    model, params, inputs = state["model"], state["compute"], state["inputs"]
    b, s, gen = LM_PATHS[path][2]
    phase = path.replace("serving", "profile")
    out = {"phase": phase}
    cache = None

    def prefill():
        nonlocal cache
        logits, cache = model.prefill(params, inputs, s + gen)
        return logits

    def decode():
        tok = torch.zeros((b, 1), dtype=torch.long, device=state["prompt"].device)
        return model.decode_step(params, cache, {"tokens": tok}, s)[0]

    for name, fn in (("prefill", prefill), ("decode_step", decode)):
        t0 = _time.perf_counter()
        logits = fn()
        torch.cuda.synchronize()
        wall_ms = (_time.perf_counter() - t0) * 1e3
        if tuple(logits.shape) != (b, cfg.vocab_size) or not torch.isfinite(logits).all():
            raise AssertionError(f"lm {name}: logits {tuple(logits.shape)} not finite")
        device = _device_ms(fn, 1)
        busy = sum(device.values())
        ours = {k: sum(v for key, v in device.items() if _is_kernel(k, key)) for k in LM_KERNELS}
        out[name] = {"wall_ms": wall_ms, "device_busy_ms": busy,
                     "idle_share": 1.0 - busy / wall_ms, "kernels_ms": ours,
                     "device_kernels": len(device),
                     "device_top": sorted(device.items(), key=lambda kv: -kv[1])[:12]}
    out["bounds"] = _serving_bounds(cfg, b, s, experts_read)
    _emit(out)


def mrope_grid_streams(s):
    """Three different M-RoPE position streams over ``s`` tokens (t
    constant, h = i // 8, w = i % 8).  With equal streams M-RoPE is plain
    RoPE, and a wrong section split would not show."""
    import torch

    i = torch.arange(s)
    return torch.stack([0 * i, i // 8, i % 8])


def phase_lm_checks():
    """The model end to end, float32, against the twins and against itself.

    (1) Reduced qwen3-moe-30b-a3b, granite-3-8b, mamba2-2.7b,
    jamba-1.5-large-398b (two periods of four), qwen2-vl-2b (embeddings and
    :func:`mrope_grid_streams`) and seamless-m4t-medium (an encoder input
    13 frames longer than the prompt), batches from ``prefill_inputs``: the
    same weights (drawn on the CPU) and prompt through prefill and three
    decode steps, fed the CPU's tokens, on the card (kernels) and on the
    CPU (twins).  (2) Teacher forcing at full
    width, B = 2: prefill(S) then decode of token S equals prefill(S + 1)'s
    last logits, for qwen3-moe-30b-a3b (2 layers, S = 256, capacity factor
    16: nothing dropped), mamba2-2.7b (2 layers, S = SSM_TF_PROMPT),
    jamba-1.5-large-398b (JAMBA_TF: a period of two, a Mamba layer with its
    MLP then attention with MoE, 4 of the 16 experts; the served cut in
    float32 would take 96 GB, so a smaller float32 stack stands in for it;
    S = 300 crosses an SSD chunk), qwen2-vl-2b (2 layers, S = 256, M-RoPE
    streams all equal, as decode puts them at ``pos``) and
    seamless-m4t-medium (2 + 2 layers, S = 256, an encoder input of 300).
    """
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import prefill_inputs
    from repro_torch.models import Model

    dev = torch.device(DEVICE)
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    out = {"phase": "lm_checks", "tf32": False, "tol": {"card_vs_cpu": E2E_TOL,
                                                       "teacher_forcing": TF_TOL}}
    for arch in (LM_ARCH, "granite-3-8b", SSM_ARCH, HYBRID_ARCH, MROPE_ARCH, ENCDEC_ARCH):
        cfg = get_config(arch, reduced=True)
        cpu, card = Model(cfg, device="cpu"), Model(cfg, device=dev)
        params = cpu.init(0)
        params_card = params.map(lambda _, w: w.to(dev))
        rng = np.random.default_rng(0)
        prompt = torch.from_numpy(rng.integers(2, cfg.vocab_size, (2, 24)))
        inputs = prefill_inputs(cfg, prompt, rng, positions3=mrope_grid_streams(24),
                                enc_len=24 + 13)
        want, cache = cpu.prefill(params, inputs, 27)
        got, cache_card = card.prefill(params_card, {k: v.to(dev) for k, v in inputs.items()},
                                       27)
        errs = [(got.cpu() - want).abs().max().item()]
        for i in range(3):
            tok = torch.argmax(want, -1)[:, None]
            want, cache = cpu.decode_step(params, cache, {"tokens": tok}, 24 + i)
            got, cache_card = card.decode_step(params_card, cache_card,
                                               {"tokens": tok.to(dev)}, 24 + i)
            errs.append((got.cpu() - want).abs().max().item())
        if max(errs) > E2E_TOL:
            raise AssertionError(f"{arch} reduced: card vs CPU logits differ by {errs}")
        out[f"{arch}_reduced_max_abs_err"] = errs

    def teacher_forcing(cfg, s, enc_len=0):
        model = Model(cfg, device=dev)
        params = model.init(1)
        rng = np.random.default_rng(1)
        tokens = torch.from_numpy(rng.integers(2, cfg.vocab_size, (2, s + 1))).to(dev)
        whole, prefix = {"tokens": tokens}, {"tokens": tokens[:, :s]}
        if cfg.mrope:
            p3 = torch.arange(s + 1, dtype=torch.int32, device=dev).expand(3, 2, s + 1)
            whole["positions3"], prefix["positions3"] = p3, p3[..., :s]
        if enc_len:
            whole["enc_embeds"] = prefix["enc_embeds"] = torch.from_numpy(
                rng.standard_normal((2, enc_len, cfg.d_model)).astype(np.float32)).to(dev)
        full, _ = model.prefill(params, whole, s + 1)
        _, cache = model.prefill(params, prefix, s + 1)
        step, _ = model.decode_step(params, cache, {"tokens": tokens[:, s:]}, s)
        err = (step - full).abs().max().item()
        if not torch.isfinite(step).all() or err > TF_TOL:
            raise AssertionError(f"{cfg.name}: teacher forcing at full width: logits differ "
                                 f"by {err}")
        n_params = sum(p.numel() for p in params.parameters())
        del model, params, cache
        torch.cuda.empty_cache()
        return {"layers": cfg.n_layers, "batch": 2, "prompt": s, "max_abs_err": err,
                "logit_abs_max": full.abs().max().item(), "params": n_params}

    full = get_config(LM_ARCH)
    out["teacher_forcing"] = teacher_forcing(
        dataclasses.replace(full, n_layers=2, compute_dtype="float32",
                            moe=dataclasses.replace(full.moe, capacity_factor=16.0)), 256)
    ssm = dataclasses.replace(get_config(SSM_ARCH), n_layers=2, compute_dtype="float32")
    out["teacher_forcing_ssm"] = {**teacher_forcing(ssm, SSM_TF_PROMPT),
                                  "chunk": ssm.ssm.chunk}
    jamba = get_config(HYBRID_ARCH)
    out["teacher_forcing_hybrid"] = teacher_forcing(dataclasses.replace(
        jamba, **JAMBA_TF, moe=dataclasses.replace(jamba.moe, **JAMBA_TF_EXPERTS)), 300)
    out["teacher_forcing_mrope"] = teacher_forcing(
        dataclasses.replace(get_config(MROPE_ARCH), n_layers=2, compute_dtype="float32"), 256)
    out["teacher_forcing_encdec"] = teacher_forcing(
        dataclasses.replace(get_config(ENCDEC_ARCH), n_layers=2, n_encoder_layers=2,
                            compute_dtype="float32"), 256, enc_len=300)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    _emit(out)


# ---------------------------------------------------------------------------
# The hybrid, M-RoPE and encoder-decoder paths
# ---------------------------------------------------------------------------


def _expected_launches(cfg, gen) -> dict:
    """Kernel launches of one request of ``gen`` tokens: flash attention in
    every attention layer of the prefill (for ``encdec`` also in each encoder
    layer and each decoder layer's cross-attention; decode attention is plain
    PyTorch), the expert FFN in every MoE layer of the prefill and of each of
    the ``gen - 1`` decode steps."""
    flash = cfg.layer_kinds().count("attn")
    if cfg.family == "encdec":
        flash += cfg.n_encoder_layers + cfg.n_layers
    return {"flash_attention": flash, "moe_mlp": cfg.ffn_kinds().count("moe") * gen}


def _ssd_flops(cfg, b, s, layers):
    """The products of ``layers`` Mamba2 layers over ``b`` prompts of ``s``
    tokens: the projections' (bf16) and the chunked SSD's (float32, as the
    reference sums them)."""
    m = cfg.ssm
    d, di = cfg.d_model, m.expand * cfg.d_model
    h, p, n, g, chunk = di // m.head_dim, m.head_dim, m.d_state, m.n_groups, m.chunk
    nc = -(-s // chunk)
    proj = 2 * b * s * (d * (2 * di + 2 * g * n + h) + di * d) * layers
    # C·Bᵀ per chunk, the decayed scores against x, the end states, the off-diagonal term.
    ssd = 2 * b * nc * (g * chunk * chunk * n + h * chunk * chunk * p
                        + 2 * h * p * n * chunk) * layers
    return proj, ssd


def _serving_bounds(cfg, b, s, experts_read):
    """The least time a prefill of ``b`` prompts of ``s`` tokens and a decode
    step could take here.

    Prefill: the bf16 products over the tensor-core rate (projections, MLPs,
    each token's top_k experts, the attention products over the pairs
    attended: causal self-attention, the encoder's and the cross-attention's
    S x S, and the last position's logits) plus the chunked SSD's products
    and the routers, which the reference sums in float32, over the float32
    rate.  Decode: the bytes a step must move, each once, over the memory
    rate: the bf16 weights it reads (B rows of an untied embedding table; of
    the experts, those that held a pair: ``experts_read[step][layer]`` over
    the served decode steps, whose mean the bound counts), the K/V prefix
    it attends (and the cross-attention's cache), and the SSD states it
    reads and writes in float32.
    """
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    kinds, ffns = cfg.layer_kinds(), cfg.ffn_kinds()
    n_attn, n_mamba = kinds.count("attn"), kinds.count("mamba")
    n_mlp, n_moe, n_enc = ffns.count("mlp"), ffns.count("moe"), cfg.n_encoder_layers
    tokens = b * s
    attn_w, mlp_w = 2 * d * (hq + hkv) * dh, 3 * d * cfg.d_ff
    bf16 = (2 * tokens * (n_attn * attn_w + n_mlp * mlp_w)
            + 4 * b * hq * dh * (s * (s + 1) // 2) * n_attn + 2 * b * d * cfg.vocab_size)
    f32 = 0
    read = n_attn * attn_w + n_mlp * mlp_w + d * cfg.vocab_size
    if not cfg.tie_embeddings:
        read += b * d
    cache_bytes = 2 * n_attn * 2 * b * (s + 1) * hkv * dh
    if n_mamba:
        m = cfg.ssm
        proj, ssd = _ssd_flops(cfg, b, s, n_mamba)
        bf16, f32 = bf16 + proj, f32 + ssd
        di = m.expand * d
        read += n_mamba * (d * (2 * di + 2 * m.n_groups * m.d_state + di // m.head_dim) + di * d)
        cache_bytes += n_mamba * 2 * 4 * b * di * m.d_state
    if n_moe:
        e = cfg.moe
        expert_w = 3 * d * e.d_ff_expert
        bf16 += 2 * tokens * e.top_k * expert_w * n_moe
        f32 += 2 * tokens * d * e.n_experts * n_moe
        per_step = [sum(step) for step in experts_read]
        read += sum(per_step) / len(per_step) * expert_w + n_moe * d * e.n_experts
    if cfg.family == "encdec":  # the encoder and the cross-attention, over S frames
        bf16 += (2 * tokens * (n_enc * (attn_w + mlp_w) + cfg.n_layers * attn_w)
                 + 4 * b * hq * dh * s * s * (n_enc + cfg.n_layers))
        read += cfg.n_layers * 2 * d * hq * dh  # the cross-attention's q and o
        cache_bytes += 2 * cfg.n_layers * 2 * b * s * hkv * dh
    decode_bytes = 2 * read + cache_bytes
    return {"prefill_bf16_flops": bf16, "prefill_f32_flops": f32,
            "prefill_bound_ms": (bf16 / BF16_FLOPS + f32 / F32_FLOPS) * 1e3,
            "decode_experts_per_step": [sum(step) for step in experts_read],
            "decode_experts_per_layer": [min(map(min, experts_read), default=0),
                                         max(map(max, experts_read), default=0)],
            "decode_bytes": decode_bytes,
            "decode_bound_ms": decode_bytes / HBM_BYTES_PER_S * 1e3}


# flash_attention at the prefill shape of each zoo path: (entry, path,
# causal).  seamless's encoder self-attention has its cross-attention's shape
# (S = T = 2,048, non-causal); its decoder self-attention is causal.
ZOO_FLASH = (("jamba", "hybrid_serving", True), ("qwen2_vl", "mrope_serving", True),
             ("seamless_self", "encdec_serving", True),
             ("seamless_cross", "encdec_serving", False))


def phase_zoo_kernels(cfg, state):
    """flash_attention and moe_mlp at the shapes the hybrid, M-RoPE and
    encdec paths give them, bf16, against their twins (as ``lm_kernels``),
    timed beside their bounds and one library call.  Returns ``{kernel:
    {shape: entry}}``, each entry naming the path that runs its shape.

    The expert FFN on the hybrid path's first MoE layer's weights at its
    prefill capacity (``jamba_prefill``: E = 16, C = 1,280, D = 8,192, F =
    24,576) and on a decode slab routed through that layer's router
    (``jamba_decode_routed``); the twin, which upcasts the weights to float32,
    runs one expert at a time beside the 48 GB model.  Flash attention at
    each shape of ``ZOO_FLASH``: jamba's (64 q / 8 kv heads of 128, causal),
    qwen2-vl's (12 q / 2 kv heads of 128, a group of 6, causal) and
    seamless's (16 heads of 64; causal, and non-causal over the encoder's
    2,048 frames), B = 4 and S = T = 2,048 as the paths run them.
    """
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import moe_capacity

    gen = torch.Generator(device=DEVICE).manual_seed(8)
    b, s, _ = LM_PATHS["hybrid_serving"][2]
    moe = state["compute"].periods[0].moe[0].moe
    wg, wu, wd = moe.w_gate, moe.w_up, moe.w_down
    e, d, _ = wg.shape
    x = _randn(gen, (e, moe_capacity(cfg, b * s), d), wg.dtype)
    experts = {"jamba_prefill": _moe_entry(x, wg, wu, wd, 0, 10, twin_chunk=1)}
    del x
    experts["jamba_decode_routed"], occupied = _routed_decode_entry(moe, cfg, b, gen, 0,
                                                                    twin_chunk=1)
    for en in experts.values():
        en["path"] = "hybrid_serving"
    flash = {}
    for shape, path, causal in ZOO_FLASH:
        arch, changes, (b, s, _) = LM_PATHS[path]
        c = dataclasses.replace(get_config(arch), **changes)
        q = _randn(gen, (b, c.n_heads, s, c.d_head))
        k, v = (_randn(gen, (b, c.n_kv_heads, s, c.d_head)) for _ in range(2))
        gqa = {"enable_gqa": True} if c.n_kv_heads != c.n_heads else {}
        flash[shape] = {**_flash_entry(q, k, v, causal, 0, **gqa), "path": path}
        del q, k, v
    out = {"flash_attention": flash, "moe_mlp": experts}
    _emit({"phase": "zoo_kernels", "occupied_experts": occupied,
           "bf16": {f"{name}/{shape}": [en["max_abs_err"], en["scaled_err"]]
                    for name, by_shape in out.items() for shape, en in by_shape.items()}})
    return out


# ---------------------------------------------------------------------------
# The training path
# ---------------------------------------------------------------------------

# qwen3-moe-30b-a3b at its published widths, layers 0-3: 622,331,904
# embedding, head and final-norm parameters plus 4 x 623,120,640 a layer
# (param_count's total).  f32 masters, bf16 compute, remat on;
# run_training's own AdamW and warmup_cosine(3e-4); SyntheticPipeline
# batches of 8 x 2,048 tokens in 2 microbatches of 4.
TRAIN = {"n_layers": 4, "steps": 6, "batch": 8, "seq": 2048, "microbatches": 2}
TRAIN_PARAMS = 3_114_814_464
# Train against serve: published widths in float32, layers 0-1, B 2 x 2,048.
TRAIN_VS_SERVE = {"n_layers": 2, "batch": 2, "seq": 2048}
# The reference's restart test (tests/test_fault.py:171-185), run on the card.
RESTART = {"arch": "granite-3-8b", "steps": 16, "batch": 4, "seq": 32, "reduced": True,
           "ckpt_every": 5, "num_microbatches": 2}
RESTART_FAIL_AT = 12
# The reduced configs' one step, card against CPU: a learning rate small
# enough that Adam's first update (lr * g / |g| for every element) cannot
# turn a gradient's rounding-level sign difference into a weight difference
# near E2E_TOL; the gradients themselves are compared directly.
CHECK_LR = 1e-5


def _product_params(cfg):
    """The weights each token is multiplied by in a MoE stack: attention's four
    projections, the router and the top-k experts' three matrices in each
    layer, and the head (the embedding is a gather, the norms elementwise)."""
    d, dh, e = cfg.d_model, cfg.d_head, cfg.moe
    attn = 2 * d * cfg.n_heads * dh + 2 * d * cfg.n_kv_heads * dh
    ffn = d * e.n_experts + e.top_k * 3 * d * e.d_ff_expert
    return cfg.n_layers * (attn + ffn) + d * cfg.vocab_size


def _train_bound(cfg, tokens, batch, seq, n_params):
    """The step's least time on the card: the model's products (6 x the
    weights a token is multiplied by x tokens, plus causal attention's two
    products, 3 x 2 B H S^2 Dh a layer) over the bf16 tensor-core rate, plus
    AdamW's bytes (28 a parameter: read the master, gradient, m and v; write
    the master, m and v) over the memory rate."""
    active = _product_params(cfg)
    attn = 3 * 2 * batch * cfg.n_heads * seq * seq * cfg.d_head * cfg.n_layers
    flops = 6 * active * tokens + attn
    adam_bytes = 28 * n_params
    return {"active_params": active, "flops": flops, "adamw_bytes": adam_bytes,
            "products_ms": flops / BF16_FLOPS * 1e3,
            "adamw_ms": adam_bytes / HBM_BYTES_PER_S * 1e3,
            "bound_ms": (flops / BF16_FLOPS + adam_bytes / HBM_BYTES_PER_S) * 1e3}


def phase_training():
    """The training path: ``run_training`` on qwen3-moe-30b-a3b at its
    published widths, layers 0-3 (``TRAIN``), counts set to 0 just before
    and read just after.

    Prints each step's loss, grad norm, lr and wall ms, the steady step
    (median of steps 1-5) and tokens/s, the peak device memory and the
    step's bound (:func:`_train_bound`); then profiles one more step
    (device busy time by kernel; its ratio to the steady step is the device's
    busy share).  Fails unless every loss and grad norm is finite, the
    kernels launched were the training attention's (one backward per
    layer and microbatch of each step, and a forward for it and for remat's
    recompute) and AdamW's (a norm a step, an update a leaf and step) alone,
    and every leaf of the last step holds a nonzero gradient (in
    the reference's reduced step every leaf of this family does; a detached
    cast or a forward-only kernel would leave leaves without one).  Returns
    the path's launch counts.
    """
    import dataclasses
    import statistics

    import numpy as np
    import torch

    from repro_torch.configs import get_config, param_count
    from repro_torch.data import PipelineConfig, SyntheticPipeline
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.train import run_training
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig, warmup_cosine
    from repro_torch.runtime.train import make_train_step

    t = TRAIN
    tokens = t["batch"] * t["seq"]
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    state, history = run_training(LM_ARCH, steps=t["steps"], batch=t["batch"], seq=t["seq"],
                                  reduced=False, num_microbatches=t["microbatches"],
                                  log_every=t["steps"], n_layers=t["n_layers"], device=DEVICE)
    launches = launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=t["n_layers"])
    n_params = sum(p.numel() for p in state.params.parameters())
    if n_params != TRAIN_PARAMS or n_params != param_count(cfg)["total"]:
        raise AssertionError(f"training: {n_params} parameters, expected {TRAIN_PARAMS}")
    calls = t["steps"] * t["n_layers"] * t["microbatches"]
    leaves = len(list(state.params.parameters()))
    want = {name: 0 for name in launches}
    want.update(flash_attention_train=calls * (2 if cfg.remat else 1),
                flash_attention_backward=calls, adamw_norm=t["steps"],
                adamw_update=t["steps"] * leaves)
    if launches != want:
        raise AssertionError(f"training launched kernels {launches}, expected {want}")
    if not all(np.isfinite(h[k]) for h in history for k in ("loss", "grad_norm")):
        raise AssertionError(f"training: a loss or grad norm is not finite: {history}")
    no_grad = [n for n, p in state.params.named_parameters()
               if p.grad is None or not bool(p.grad.abs().max() > 0)]
    if no_grad:
        raise AssertionError(f"training: leaves without a gradient: {no_grad}")
    steady_s = statistics.median(h["seconds"] for h in history[1:])
    out = {"phase": "training", "arch": cfg.name, "layers": cfg.n_layers,
           "of_layers": get_config(LM_ARCH).n_layers, "params": n_params,
           "param_dtype": cfg.param_dtype, "compute_dtype": cfg.compute_dtype,
           "remat": cfg.remat, "batch": t["batch"], "seq": t["seq"],
           "microbatches": t["microbatches"], "steps": [
               {"step": h["step"], "loss": h["loss"], "grad_norm": h["grad_norm"],
                "lr": h["lr"], "wall_ms": h["seconds"] * 1e3} for h in history],
           "steady_step_ms": steady_s * 1e3, "tokens_per_s": tokens / steady_s,
           "peak_gib": peak_gib, "launches": launches,
           "bound": _train_bound(cfg, tokens, t["batch"], t["seq"], n_params)}

    # One more step under the profiler, on the state the run left.
    model = Model(cfg, DEVICE)
    step_fn = make_train_step(model, AdamWConfig(lr=warmup_cosine(3e-4, 2, t["steps"])),
                              num_microbatches=t["microbatches"])
    pipe = SyntheticPipeline(PipelineConfig(vocab_size=cfg.vocab_size, seq_len=t["seq"],
                                            global_batch=t["batch"]))
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in pipe.batch(t["steps"]).items()}
    holder = {"state": state}

    def one_step():
        holder["state"], metrics = step_fn(holder["state"], batch)
        return metrics

    device = _device_ms(one_step, 1)
    busy = sum(device.values())
    gemm = sum(v for k, v in device.items() if "gemm" in k.lower())
    out["profile"] = {"device_busy_ms": busy, "busy_share": busy / out["steady_step_ms"],
                      "idle_share": 1.0 - busy / out["steady_step_ms"],
                      "gemm_ms": gemm, "device_kernels": len(device),
                      "device_top": sorted(device.items(), key=lambda kv: -kv[1])[:16]}
    _emit(out)
    del state, holder, batch
    torch.cuda.empty_cache()
    return launches


def _max_rel_leaf_err(got, want) -> float:
    """The largest of each leaf's max |got - want| over its max |want|."""
    errs = [float((g.float().cpu() - w.float()).abs().max() / max(float(w.abs().max()), 1e-30))
            for g, w in zip(got, want)]
    return max(errs)


def _restart_child(root: str) -> None:
    """The reference's restart test on the card, in a process of its own
    (``CUBLAS_WORKSPACE_CONFIG`` must be set before CUDA starts): an
    uninterrupted run and one that fails at ``RESTART_FAIL_AT``, under
    deterministic algorithms; prints one JSON line."""
    t0 = time.perf_counter()
    import torch

    torch.use_deterministic_algorithms(True)
    from repro_torch.launch.train import run_training

    t1 = time.perf_counter()
    ok, _ = run_training(ckpt_dir=f"{root}/a", device=DEVICE, **RESTART)
    t2 = time.perf_counter()
    ft, _ = run_training(ckpt_dir=f"{root}/b", fail_at=RESTART_FAIL_AT, device=DEVICE,
                         **RESTART)
    differ = [n for (n, x), (_, y) in zip(ok.params.named_parameters(),
                                          ft.params.named_parameters()) if not torch.equal(x, y)]
    print(json.dumps({"bit_exact": not differ, "differing": differ, "step": int(ft.step),
                      "leaves": len(list(ok.params.parameters())),
                      "child_s": {"import": t1 - t0, "uninterrupted": t2 - t1,
                                  "interrupted": time.perf_counter() - t2}}))


@contextlib.contextmanager
def restart_check_beside():
    """The reference's restart test (reduced granite-3-8b, 16 steps, a
    checkpoint every 5, a failure at step 12) on the card under
    deterministic algorithms, in a process of its own that runs beside the
    body of the ``with`` (it is deterministic, so sharing the card moves its
    time, not its bits); on leaving, the interrupted run's final weights
    must equal the uninterrupted run's bit for bit (phase
    ``train_restart``).  The process is killed if the body raises."""
    import os
    import tempfile

    root = tempfile.TemporaryDirectory()
    env = {**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":4096:8",
           "PYTHONPATH": str(Path(__file__).resolve().parent / "src")}
    t0 = time.perf_counter()
    child = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--restart-check",
                              root.name], env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
    try:
        yield
        stdout, stderr = child.communicate(timeout=600)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
        root.cleanup()
    if child.returncode != 0:
        raise AssertionError(f"restart check failed: {stderr[-4000:]}")
    restart = json.loads(stdout.strip().splitlines()[-1])
    if not restart["bit_exact"] or restart["step"] != RESTART["steps"]:
        raise AssertionError(f"restart on the card is not bit-exact: {restart}")
    _emit({"phase": "train_restart", **RESTART, "fail_at": RESTART_FAIL_AT, **restart,
           "seconds": time.perf_counter() - t0})


def _check_train_vs_serve():
    """(1) of :func:`phase_train_checks`."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import Model
    from repro_torch.models import transformer as tf

    v = TRAIN_VS_SERVE
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=v["n_layers"],
                              compute_dtype="float32")
    model = Model(cfg, DEVICE)
    params = model.init(2)
    rng = np.random.default_rng(2)
    batch = {"tokens": torch.from_numpy(
        rng.integers(2, cfg.vocab_size, (v["batch"], v["seq"]))).to(DEVICE)}
    with torch.no_grad():
        reset_launch_counts()
        h_train, _ = tf.forward_train(tf.cast_params_for_train(params, cfg), cfg, batch)
        train_launches = launch_counts()
        reset_launch_counts()
        h_last, _ = tf.forward_prefill(model.compute_params(params), cfg, batch, v["seq"])
        serve_launches = {k: n for k, n in launch_counts().items() if n}
    err = (h_train[:, -1] - h_last).abs().max().item()
    want = {"flash_attention": cfg.n_layers, "moe_mlp": cfg.n_layers}
    if any(train_launches.values()) or serve_launches != want:
        raise AssertionError(f"train vs serve: launches {train_launches} / {serve_launches}")
    if not torch.isfinite(h_last).all() or err > E2E_TOL:
        raise AssertionError(f"train vs serve: last hidden states differ by {err}")
    out = {**v, "max_abs_err": err, "h_abs_max": h_last.abs().max().item(),
           "serve_launches": serve_launches}
    del model, params, h_train, h_last
    torch.cuda.empty_cache()
    return out


def _check_reduced_steps():
    """(2) of :func:`phase_train_checks`."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config, list_archs
    from repro_torch.launch.serve import prefill_inputs
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.train import init_train_state, make_train_step

    opt = AdamWConfig(lr=CHECK_LR)
    out = {}
    for arch in list_archs():
        cfg = get_config(arch, reduced=True)
        cpu, card = Model(cfg, "cpu"), Model(cfg, DEVICE)
        s_cpu, s_card = init_train_state(cpu, opt, 0), init_train_state(card, opt, 0)
        with torch.no_grad():
            for a, b in zip(s_card.params.parameters(), s_cpu.params.parameters()):
                a.copy_(b)
        rng = np.random.default_rng(3)
        prompt = torch.from_numpy(rng.integers(2, cfg.vocab_size, (4, 32)))
        inputs = prefill_inputs(cfg, prompt, rng, positions3=mrope_grid_streams(32),
                                enc_len=32 + 5)
        inputs["labels"] = torch.from_numpy(rng.integers(2, cfg.vocab_size, (4, 32)))
        s_cpu, m_cpu = make_train_step(cpu, opt, num_microbatches=2)(s_cpu, inputs)
        s_card, m_card = make_train_step(card, opt, num_microbatches=2)(
            s_card, {k: x.to(DEVICE) for k, x in inputs.items()})
        pairs = list(zip(s_card.params.parameters(), s_cpu.params.parameters()))
        grads = _max_rel_leaf_err([a.grad for a, _ in pairs], [b.grad for _, b in pairs])
        weights = max(float((a.detach().cpu() - b.detach()).abs().max()) for a, b in pairs)
        loss = abs(float(m_card["loss"]) - float(m_cpu["loss"]))
        out[arch] = {"loss": float(m_cpu["loss"]), "loss_err": loss, "grad_rel_err": grads,
                     "weight_err": weights, "leaves": len(pairs)}
        if max(loss, grads, weights) > E2E_TOL or not np.isfinite(float(m_card["loss"])):
            raise AssertionError(f"{arch} reduced train step: card vs CPU {out[arch]}")
    return out


def phase_train_checks():
    """The trained model against the served one, and the card against the CPU.

    (1) ``train_vs_serve``: qwen3-moe-30b-a3b at its published widths in
    float32, layers 0-1, B 2 x 2,048 (``TRAIN_VS_SERVE``): ``forward_train``'s
    last-position hidden state (chunked attention, einsum experts, no kernel)
    against ``forward_prefill``'s ``h_last`` (the flash and expert-FFN
    kernels) on the same weights and tokens, within E2E_TOL.  (2) One
    ``make_train_step`` step (2 microbatches of 2 x 32) of every registered
    arch's reduced config on the card against the CPU, TF32 off, the same
    weights (drawn on the CPU): the loss, every gradient leaf (relative to
    its largest magnitude) and the updated weights within E2E_TOL.
    """
    import torch

    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        _emit({"phase": "train_checks", "tf32": False, "tol": E2E_TOL,
               "train_vs_serve": _check_train_vs_serve(), "reduced_step": _check_reduced_steps()})
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# The examples' runs in the ``examples`` phase: (name, arguments after --device).
EXAMPLES = (("quickstart", []), ("spmv_cg", []), ("serve_lm", []),
            ("serve_lm", ["--arch", SSM_ARCH]), ("serve_lm", ["--arch", HYBRID_ARCH]),
            ("train_lm", ["--steps", "20"]))


def phase_examples():
    """The port's three examples through their ``main(["--device", "cuda"])``.

    Each must print its ``OK`` line last, after its own assertion.  Counts
    are set to 0 before each: the quickstart launches the software-cache
    kernel and the combine once; CG launches both once per call the
    scheduler served with the optimized SpMV; serve_lm launches what
    :func:`_expected_launches` says (its granite flash attention once per
    layer, its mamba2 no kernel, its jamba flash once per period and the
    expert FFN in every MoE layer of every step).
    """
    import contextlib
    import importlib.util
    import io

    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import Model

    root = Path(__file__).resolve().parent / "examples"
    out = {"phase": "examples"}
    for name, extra in EXAMPLES:
        spec = importlib.util.spec_from_file_location(f"torch_{name}",
                                                      root / f"torch_{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        reset_launch_counts()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            result = mod.main(["--device", "cuda", *extra])
        seconds = time.perf_counter() - t0
        launches = {k: v for k, v in launch_counts().items() if v}
        lines = buf.getvalue().splitlines()
        if not lines or lines[-1] != f"{name} OK":
            raise AssertionError(f"example {name} {extra}: last line {lines[-1:]}")
        key = name if not extra or name == "train_lm" else f"{name}_{extra[-1]}"
        if name == "quickstart":
            rec, want = {"max_abs_err": result}, {"spmv_software_cache": 1, "ep_combine": 1}
        elif name == "spmv_cg":
            rec = {k: result[k] for k in ("residual", "iterations", "state", "calls",
                                          "optimized_calls", "optimize_time_s")}
            n = result["optimized_calls"]
            want = {"spmv_software_cache": n, "ep_combine": n} if n else {}
        elif name == "train_lm":
            rec = {"steps": len(result), "loss_first": result[0]["loss"],
                   "loss_last": result[-1]["loss"]}
            # float32 attention takes the chunked loop; AdamW takes its kernels
            leaves = len(list(Model(get_config(LM_ARCH, reduced=True), "meta").init(0)
                              .parameters()))
            want = {"adamw_norm": len(result), "adamw_update": len(result) * leaves}
        else:
            cfg = get_config(extra[-1] if extra else "granite-3-8b", reduced=True)
            tokens, stats = result
            rec = {"arch": cfg.name, "tokens": list(tokens.shape),
                   "prefill_s": stats["prefill_s"], "decode_s": stats["decode_s"]}
            want = {k: v for k, v in _expected_launches(cfg, tokens.shape[1]).items() if v}
        if launches != want:
            raise AssertionError(f"example {key}: launches {launches}, expected {want}")
        out[key] = {**rec, "seconds": seconds, "launches": launches}
    _emit(out)


# ---------------------------------------------------------------------------
# The distribution layer: the sharded path on a 1x1 mesh, and the dry-run
# ---------------------------------------------------------------------------

# The dryrun phase's production cells: (arch, shape, multi_pod).
DRYRUN_CELLS = (("qwen3-moe-30b-a3b", "train_4k", False), ("qwen3-moe-30b-a3b", "train_4k", True),
                ("qwen3-moe-30b-a3b", "decode_32k", False),
                ("qwen3-moe-30b-a3b", "decode_32k", True),
                ("jamba-1.5-large-398b", "decode_32k", False), ("mamba2-2.7b", "long_500k", False),
                ("mamba2-2.7b", "prefill_32k", False),
                ("jamba-1.5-large-398b", "prefill_32k", False))
# Collective bytes per device of the reference's own dry-run of the prefill
# cells (``python -m repro.launch.dryrun`` with 512 placeholder devices, the
# 16x16 mesh), copied here: the port's may not exceed them.
DRYRUN_REFERENCE_BYTES = {"mamba2-2.7b__prefill_32k__16x16": 135_117_362_040,
                          "jamba-1.5-large-398b__prefill_32k__16x16": 965_091_520_212}
DRYRUN_TIMEOUT_S = 600
SERVE_PROFILE = {"batch": ("data",), "model": ("model",)}
# The sharded train step: training's cut in float32 compute.  Two bf16 runs
# whose sums differ in order differ by whole bf16 ulps (4e-3 of a value) in
# their gradients, so the comparison runs at train_checks' precision.
SHARDED_TRAIN = {"n_layers": TRAIN["n_layers"], "compute_dtype": "float32"}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _sharded_serve(mesh):
    """(1) of :func:`phase_sharded`."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import Model
    from repro_torch.models.spmd import full
    from repro_torch.runtime.axes import ActivationSharding, set_activation_sharding
    from repro_torch.runtime.serve import make_decode_step
    from repro_torch.runtime.sharding import distribute_params, make_sharding_rules, param_specs

    b, s, gen = LM_TRAFFIC
    cfg = dataclasses.replace(get_config(LM_ARCH), **LM_PATHS["lm_serving"][1])
    model = Model(cfg, DEVICE)
    params = model.compute_params(model.init(0))  # the bf16 copies; the masters are freed
    prompt = torch.from_numpy(np.random.default_rng(0).integers(2, cfg.vocab_size, (b, s)))
    prompt = prompt.to(DEVICE)
    set_activation_sharding(ActivationSharding(mesh, SERVE_PROFILE))
    decode = make_decode_step(model)

    def serve(p):
        reset_launch_counts()
        t0 = time.perf_counter()
        with torch.no_grad():
            logits, cache = model.prefill(p, {"tokens": prompt}, s + gen)
            logits = full(logits)
            tok = torch.argmax(logits, -1).to(torch.int32)
            toks = [tok]
            for i in range(gen - 1):
                nxt, cache = decode(p, cache, tok[:, None], s + i)
                tok = full(nxt)[:, 0]
                toks.append(tok)
        torch.cuda.synchronize()
        return logits, torch.stack(toks, 1), launch_counts(), time.perf_counter() - t0

    logits0, tokens0, launches0, plain_s = serve(params)
    control = serve(params)[1]  # the unsharded path again: is it deterministic here?
    rules = make_sharding_rules(mesh, "serve")
    sharded = distribute_params(params, param_specs(params, rules), mesh)
    logits1, tokens1, launches1, sharded_s = serve(sharded)
    del params  # the sharded weights are a copy: time and weigh them alone
    out = {"arch": cfg.name, "layers": cfg.n_layers, "batch": b, "prompt": s, "tokens": gen,
           "tokens_equal": bool(torch.equal(tokens0, tokens1)),
           "control_tokens_equal": bool(torch.equal(tokens0, control)),
           "first_differing_token": int((tokens0 != tokens1).any(0).int().argmax())
           if not torch.equal(tokens0, tokens1) else None,
           "logits_max_abs_err": float((logits1 - logits0).abs().max()),
           "logits_abs_max": float(logits0.abs().max()),
           "launches_plain": launches0, "launches": launches1,
           "expected": _expected_launches(cfg, gen),
           "placements_wq": str(sharded.blocks[0].attn.wq.placements),
           "request_s": {"plain": plain_s, "sharded": sharded_s}}
    del logits0, logits1
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        model.prefill(sharded, {"tokens": prompt}, s + gen)
    torch.cuda.synchronize()
    out["warm_prefill_ms"] = (time.perf_counter() - t0) * 1e3
    out["warm_prefill_peak_bytes"] = torch.cuda.max_memory_allocated()
    set_activation_sharding(None)
    return out


def _sharded_train(mesh):
    """(2) of :func:`phase_sharded`."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import PipelineConfig, SyntheticPipeline
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import Model
    from repro_torch.models.spmd import full
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.runtime.axes import ActivationSharding, set_activation_sharding
    from repro_torch.runtime.sharding import distribute_params, make_sharding_rules, param_specs
    from repro_torch.runtime.train import TrainState, init_train_state, make_train_step

    t = TRAIN
    cfg = dataclasses.replace(get_config(LM_ARCH), **SHARDED_TRAIN)
    model = Model(cfg, DEVICE)
    opt = AdamWConfig(lr=CHECK_LR)
    pipe = SyntheticPipeline(PipelineConfig(vocab_size=cfg.vocab_size, seq_len=t["seq"],
                                            global_batch=t["batch"]))
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in pipe.batch(0).items()}
    set_activation_sharding(ActivationSharding(mesh, SERVE_PROFILE))
    step = make_train_step(model, opt, num_microbatches=t["microbatches"])

    reset_launch_counts()
    state, m0 = step(init_train_state(model, opt, 0), batch)
    torch.cuda.synchronize()
    launches0 = launch_counts()
    grads0 = [p.grad.to("cpu") for p in state.params.parameters()]
    del state
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    masters = model.init(0).requires_grad_()
    params = distribute_params(masters, param_specs(masters, make_sharding_rules(mesh, "train")),
                               mesh)
    del masters
    state = TrainState(params=params, opt_state=adamw_init(opt, params),
                       step=torch.zeros((), dtype=torch.int32, device=DEVICE))
    reset_launch_counts()
    state, m1 = step(state, batch)
    torch.cuda.synchronize()
    launches1 = launch_counts()
    grad_err = _max_rel_leaf_err([full(p.grad) for p in state.params.parameters()], grads0)
    leaves = len(grads0)
    del grads0
    t0 = time.perf_counter()
    state, m2 = step(state, batch)
    torch.cuda.synchronize()
    out = {"arch": cfg.name, "layers": cfg.n_layers, "batch": t["batch"], "seq": t["seq"],
           "microbatches": t["microbatches"], "lr": CHECK_LR, "compute_dtype": cfg.compute_dtype,
           "loss": float(m0["loss"]), "loss_err": abs(float(m1["loss"]) - float(m0["loss"])),
           "grad_rel_err": grad_err, "leaves": leaves,
           "grad_norm_err": abs(float(m1["grad_norm"]) / float(m0["grad_norm"]) - 1),
           "launches_plain": launches0, "launches": launches1,
           "placements_w_gate": str(state.params.blocks[0].ffn.moe.w_gate.placements),
           "warm_step_ms": (time.perf_counter() - t0) * 1e3,
           "step_peak_bytes": torch.cuda.max_memory_allocated(),
           "loss_second_step": float(m2["loss"])}
    del params
    held = [state]  # handed over, so that the checkpoint phase can free it
    del state
    out["checkpoint"] = _sharded_checkpoint(model, opt, step, batch, held, mesh)
    set_activation_sharding(None)
    return out


def _digests(leaves) -> list:
    """Per leaf, two int64 sums (wrapping) of its bits read as integers: the
    plain sum, and each element's times its position + 1.  Equal bits give
    equal digests; a changed, moved or swapped element changes them.  On the
    card, a chunk of 2^22 elements at a time."""
    import torch

    from repro_torch.models.spmd import is_dtensor

    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    chunk = 1 << 22
    out = []
    for x in leaves:
        bits = (x.to_local() if is_dtensor(x) else x).detach().reshape(-1)
        bits = bits.view(ints[bits.element_size()])
        pos = torch.arange(1, min(chunk, bits.numel()) + 1, dtype=torch.int64, device=bits.device)
        s1 = s2 = torch.zeros((), dtype=torch.int64, device=bits.device)
        for i in range(0, bits.numel(), chunk):
            c = bits[i:i + chunk].to(torch.int64)
            s1 = s1 + c.sum()
            s2 = s2 + (c * (pos[:c.numel()] + i)).sum()
        out.append((int(s1), int(s2)))
    return out


def _host_room(root, nbytes) -> dict:
    """Free disk under ``root`` and available host memory; fails unless both
    can take ``nbytes`` (the checkpoint, and its host snapshot)."""
    import shutil

    free = shutil.disk_usage(root).free
    with open("/proc/meminfo") as f:
        avail = next(int(line.split()[1]) * 1024 for line in f if line.startswith("MemAvailable"))
    if free < 1.05 * nbytes or avail < 1.1 * nbytes:
        raise AssertionError(f"a {nbytes}-byte checkpoint: {free} bytes free on disk under "
                             f"{root}, {avail} bytes of host memory available")
    return {"disk_free_bytes": free, "host_available_bytes": avail}


def _sharded_checkpoint(model, opt, step, batch, held, mesh) -> dict:
    """(3) of :func:`phase_sharded`: the sharded train state after its
    second step (the one item of ``held``, taken out), saved by
    ``CheckpointManager`` into a temporary directory on the local disk (the
    host snapshot, then the write), then the next step from it; restored
    onto a meta template of the same placements
    (every leaf's digest against the state's before the save, and the next
    step from it against the one before, bit for bit) and onto a plain meta
    template (the digests again).  The card cannot hold two such states:
    each is freed before the next."""
    import resource
    import shutil
    import tempfile

    import torch

    from repro_torch.ckpt import CheckpointManager
    from repro_torch.models.params import tree_leaves
    from repro_torch.optim import adamw_init
    from repro_torch.runtime.sharding import distribute_params, make_sharding_rules, param_specs
    from repro_torch.runtime.train import TrainState

    def leaves(s):
        return tree_leaves([s.params, s.opt_state, s.step])

    def template(sharded):
        params = model.abstract_params().requires_grad_()
        if sharded:
            params = distribute_params(params, param_specs(params, make_sharding_rules(
                mesh, "train")), mesh)
        return TrainState(params=params, opt_state=adamw_init(opt, params),
                          step=torch.zeros((), dtype=torch.int32, device="meta"))

    state = held.pop()
    nbytes = sum(x.numel() * x.element_size() for x in leaves(state))
    root = tempfile.mkdtemp(prefix="ckpt_")
    out = {"bytes": nbytes, "leaves": len(leaves(state)), **_host_room(root, nbytes),
           "host_peak_rss_before_bytes": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024}
    try:
        saved = _digests(leaves(state))
        mgr = CheckpointManager(root)
        t0 = time.perf_counter()
        mgr.save(2, state)
        out["snapshot_ms"] = (time.perf_counter() - t0) * 1e3
        mgr.wait()
        out.update(write_s=mgr.last_save["write_s"], snapshot_bytes=mgr.last_save["snapshot_bytes"],
                   host_peak_rss_bytes=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024)
        state, m3 = step(state, batch)
        after = _digests(leaves(state))
        del state
        torch.cuda.empty_cache()

        restore_s, equal = {}, {}
        for name, like in (("sharded", template(True)), ("plain", template(False))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = mgr.restore(like, device=DEVICE)[1]
            torch.cuda.synchronize()
            restore_s[name] = time.perf_counter() - t0
            equal[name] = _digests(leaves(got)) == saved
            if name == "sharded":
                placed = got.params.blocks[0].ffn.moe.w_gate.placements
                out["restored_placements_w_gate"] = str(placed)
                got, m = step(got, batch)
                out["next_step_equal"] = (float(m["loss"]) == float(m3["loss"])
                                          and float(m["grad_norm"]) == float(m3["grad_norm"])
                                          and _digests(leaves(got)) == after)
            del got
            torch.cuda.empty_cache()
        out.update(restore_s=restore_s, round_trip_equal=equal,
                   host_peak_rss_after_bytes=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
                   * 1024)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def _sharded_child() -> None:
    """``phase_sharded``'s own process (``python3 chip_smoke.py
    --sharded-check``): a one-rank NCCL group, the 1x1 mesh over the card;
    prints one JSON line."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
                            world_size=1)
    try:
        mesh = make_host_mesh()
        out = {"mesh": str(mesh), "serve": _sharded_serve(mesh)}
        torch.cuda.empty_cache()
        out["train"] = _sharded_train(mesh)
    finally:
        dist.destroy_process_group()
    print(json.dumps(out))


def _child(flag, timeout):
    """Run this script with ``flag`` in a process of its own (the repository's
    ``src`` on its path); its last stdout line, parsed.  The process is
    killed if it outlives ``timeout``."""
    import os

    env = {**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parent / "src"),
           "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
    child = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), flag], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        stdout, stderr = child.communicate(timeout=timeout)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    if child.returncode != 0:
        raise AssertionError(f"{flag} failed: {stderr[-4000:]}")
    return json.loads(stdout.strip().splitlines()[-1])


def phase_sharded(dryrun_alive: int):
    """The distribution layer on the card, in a process of its own (process
    group state is global): a one-rank NCCL group and ``make_host_mesh()``,
    deterministic algorithms (``CUBLAS_WORKSPACE_CONFIG`` set), TF32 off.

    (1) qwen3-moe-30b-a3b at ``lm_serving``'s cut (8 of 48 layers, published
    widths, bf16 weights, B = 4 x 2,048 prompts, 32 greedy tokens): served
    unsharded twice (the second run is the control: the path's own
    repeatability), then with the weights placed by the serve rules
    (``distribute_params``) and the serve profile installed, so that every
    activation is a DTensor and the kernels are reached through
    ``local_map`` on local shards.  The same greedy tokens, prefill logits
    within E2E_TOL, and the flash and expert-FFN launches equal to the
    unsharded run's (and to :func:`_expected_launches`).  A warm sharded
    prefill is timed and its peak memory read.  (2) One train step at
    ``training``'s cut (layers 0-3, 8 x 2,048, 2 microbatches, AdamW at
    CHECK_LR) in float32 compute (``SHARDED_TRAIN``) unsharded, then under
    the train rules from the same seed: the loss and every gradient leaf
    (relative to its largest magnitude) and the grad norm within E2E_TOL,
    AdamW's kernels alone launched (a norm, an update a leaf);
    a second sharded step is timed and the peak memory of both read.
    (3) That state (37.4 GB of f32 masters and moments) checkpointed by
    ``CheckpointManager`` on the local disk (free disk and host memory
    checked first), restored onto a meta template of the same placements and
    onto a plain one: every leaf bit-equal to the saved state's (by digest:
    the card holds one such state at a time), and the next step from the
    restored sharded state bit-equal to the next step from the state before
    the save; its bytes, snapshot ms, write s, restore s and the host's peak
    RSS.
    ``dryrun_alive``, recorded, is the number of dry-run processes still
    running while it is timed (0: the dry-run is waited for first).
    Returns the child's record.
    """
    t0 = time.perf_counter()
    res = _child("--sharded-check", 900)
    _emit({"phase": "sharded", "tol": E2E_TOL, **res, "dryrun_alive": dryrun_alive,
           "seconds": time.perf_counter() - t0})
    serve, train = res["serve"], res["train"]
    lm = {k: serve["launches"][k] for k in LM_KERNELS}
    if not serve["tokens_equal"] or serve["logits_max_abs_err"] > E2E_TOL:
        raise AssertionError(f"sharded serving differs from unsharded: {serve}")
    if serve["launches"] != serve["launches_plain"] or lm != serve["expected"]:
        raise AssertionError(f"sharded serving launches: {serve}")
    if train["loss_err"] > E2E_TOL or train["grad_rel_err"] > E2E_TOL:
        raise AssertionError(f"sharded train step differs from unsharded: {train}")
    # float32 attention takes the chunked loop; AdamW's kernels take the norm
    # (of each rank's shards, summed over the mesh) and update each leaf
    want = {k: 0 for k in train["launches"]} | {"adamw_norm": 1, "adamw_update": train["leaves"]}
    if train["launches"] != want or train["launches_plain"] != want:
        raise AssertionError(f"the train step launched other kernels: {train}")
    if train["grad_norm_err"] > E2E_TOL:
        raise AssertionError(f"the sharded grad_norm differs from unsharded: {train}")
    ck = train["checkpoint"]
    if not (all(ck["round_trip_equal"].values()) and ck["next_step_equal"]):
        raise AssertionError(f"the sharded checkpoint's round trip is not bit-exact: {ck}")
    if ck["snapshot_bytes"] != ck["bytes"]:
        raise AssertionError(f"one rank's snapshot is not the whole state: {ck}")
    return res


def _dryrun_1x1_child() -> None:
    """The dry-run's prediction for the two cuts of ``phase_sharded`` on a
    1x1 mesh (``python3 chip_smoke.py --dryrun-1x1``): meta tensors in a
    fake group of one rank; prints one JSON line."""
    import dataclasses

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh

    dryrun.init_fake_world(1)
    mesh = make_mesh((1, 1), ("data", "model"))
    b, s, gen = LM_TRAFFIC
    base = get_config(LM_ARCH)
    serve = dryrun.measure(dataclasses.replace(base, **LM_PATHS["lm_serving"][1]),
                           ShapeConfig("lm_serving", "prefill", s, b), mesh)
    t = TRAIN
    train = dryrun.measure(dataclasses.replace(base, **SHARDED_TRAIN),
                           ShapeConfig("training", "train", t["seq"], t["batch"]), mesh,
                           num_microbatches=t["microbatches"])
    print(json.dumps({"serve": serve, "train": train}))


class DryRun:
    """The ``dryrun`` phase's processes, started early: ``python -m
    repro_torch.launch.dryrun`` for each of DRYRUN_CELLS (records under
    ``experiments/dryrun_torch/``, the dry-run's own default) and
    ``--dryrun-1x1``, their output in files beside the records.  They use
    the host's cores only, so they run beside the checks that are not timed
    and are waited for (:meth:`wait`) before the timed sharded phase; every
    one still running is killed by :meth:`stop`."""

    def __init__(self):
        import os

        root = Path(__file__).resolve().parent
        # meta tensors in a fake group: no card is needed, none is touched
        env = {**os.environ, "PYTHONPATH": str(root / "src"), "CUDA_VISIBLE_DEVICES": ""}
        self.dir = root / "experiments" / "dryrun_torch"
        self.dir.mkdir(parents=True, exist_ok=True)
        self.t0 = time.perf_counter()
        commands = {f"{arch}__{shape}__{'2x16x16' if mp else '16x16'}": [
            "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
            *(["--multi-pod"] if mp else []), "--out", str(self.dir)]
            for arch, shape, mp in DRYRUN_CELLS}
        commands["1x1"] = [str(Path(__file__).resolve()), "--dryrun-1x1"]
        self.procs = {}
        for name, args in commands.items():
            with open(self.dir / f"{name}.out", "w") as out, open(self.dir / f"{name}.err",
                                                                   "w") as err:
                self.procs[name] = subprocess.Popen([sys.executable, *args], env=env,
                                                    stdout=out, stderr=err)

    def result(self, name):
        """``(returncode, stdout, stderr)`` of process ``name`` once it ends."""
        rc = self.procs[name].wait(timeout=DRYRUN_TIMEOUT_S)
        return (rc, (self.dir / f"{name}.out").read_text(),
                (self.dir / f"{name}.err").read_text())

    def wait(self):
        """Wait until every process has ended."""
        for p in self.procs.values():
            p.wait(timeout=DRYRUN_TIMEOUT_S)

    def alive(self) -> int:
        return sum(p.poll() is None for p in self.procs.values())

    def stop(self):
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()


def phase_dryrun(dry: DryRun, sharded):
    """The dry-run's records, read when its processes end: one line per
    cell with its status, per-device GB, the three roofline terms, the
    dominant one and ``mfu``, all modeled from the H100's data-sheet
    constants, and its collective bytes with the part of them whose input
    is parameter storage (``param_gather_bytes``, from the cell's record).
    Then the same builders' predictions on a 1x1 mesh for
    ``phase_sharded``'s two cuts: the per-device bytes and roofline step
    time beside the card's own peak memory and wall time from that phase.
    Every cell must be ``ok``, every decode cell must gather no parameter
    bytes, and each cell of DRYRUN_REFERENCE_BYTES must move no more
    collective bytes than the reference's dry-run of it."""
    rc, out, err = dry.result("1x1")
    if rc != 0:
        raise AssertionError(f"--dryrun-1x1 failed: {err[-4000:]}")
    predicted = json.loads(out.strip().splitlines()[-1])
    for name in dry.procs:
        if name == "1x1":
            continue
        rc, out, err = dry.result(name)
        lines = [ln for ln in out.splitlines() if ln.startswith("{")]
        rec = json.loads(lines[-1]) if lines else {"status": "no output"}
        if rc != 0 or rec.get("status") != "ok":
            raise AssertionError(f"dry-run {name}: {rec} {err[-2000:]}")
        full = json.loads((dry.dir / f"{name}.json").read_text())
        cost = full["cost_model"]
        rec.update({k: cost[k] for k in ("collective_bytes_per_chip", "param_gather_bytes")})
        _emit({"phase": "dryrun_cell", "modeled": "H100 data-sheet constants", **rec})
        if full["kind"] == "decode" and cost["param_gather_bytes"] != 0:
            raise AssertionError(f"dry-run {name} gathers parameters at decode: {rec}")
        if cost["collective_bytes_per_chip"] > DRYRUN_REFERENCE_BYTES.get(name, math.inf):
            raise AssertionError(f"dry-run {name} moves more than the reference's "
                                 f"{DRYRUN_REFERENCE_BYTES[name]} B: {rec}")
    card = {"serve": {"peak_bytes": sharded["serve"]["warm_prefill_peak_bytes"],
                      "wall_ms": sharded["serve"]["warm_prefill_ms"]},
            "train": {"peak_bytes": sharded["train"]["step_peak_bytes"],
                      "wall_ms": sharded["train"]["warm_step_ms"]}}
    compare = {}
    for cut in ("serve", "train"):
        p, c = predicted[cut], card[cut]
        compare[cut] = {"predicted_bytes": p["memory"]["per_device_total_bytes"],
                        "predicted_argument_bytes": p["memory"]["argument_size_in_bytes"],
                        "predicted_step_ms": p["roofline"]["step_time_s"] * 1e3,
                        "predicted_terms_ms": {k: p["roofline"][f"{k}_s"] * 1e3 for k in
                                               ("compute", "memory", "collective")},
                        "predicted_dominant": p["roofline"]["dominant"],
                        "predicted_flops": p["cost_model"]["flops_per_chip"],
                        "predicted_eager_op_bytes": p["cost_model"]["eager_op_bytes_per_chip"],
                        "card_peak_bytes": c["peak_bytes"], "card_wall_ms": c["wall_ms"],
                        "bytes_ratio": p["memory"]["per_device_total_bytes"] / c["peak_bytes"],
                        "step_ratio": p["roofline"]["step_time_s"] * 1e3 / c["wall_ms"]}
    _emit({"phase": "dryrun", "cells": len(DRYRUN_CELLS), "hw": "H100 SXM data-sheet constants",
           "predicted_vs_card": compare, "nvidia_smi": _nvidia_smi(),
           "seconds_since_start": time.perf_counter() - dry.t0})


def _set_launches(entries, by_path) -> None:
    """Each kernel entry's launches on every path, and their total; each of
    its other shapes (a nested entry with a ``path``) the launches of the
    path that runs that shape, or none for a layout no path runs (path
    None).  The counter is per kernel: two shapes of one path both show the
    path's count."""
    for en in entries:
        counts = {path: c[en["name"]] for path, c in by_path.items()}
        en["launches_by_path"], en["launches"] = counts, sum(counts.values())
        for sub in (v for v in en.values() if isinstance(v, dict) and "path" in v):
            path = sub["path"]
            sub["launches_by_path"] = {path: counts[path]} if path else {}
            sub["launches"] = counts[path] if path else 0


def main() -> int:
    import torch

    if sys.argv[1:2] == ["--restart-check"]:  # the restart check's own process
        sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
        _restart_child(sys.argv[2])
        return 0
    children = {"--sharded-check": _sharded_child, "--dryrun-1x1": _dryrun_1x1_child}
    if sys.argv[1:2] and sys.argv[1] in children:  # a phase's own process
        sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
        children[sys.argv[1]]()
        return 0

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing was run",
              file=sys.stderr)
        return 1
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run from the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    import numpy as np

    from repro_torch.core import PartitionService
    from repro_torch.kernels import _build, launch_counts, reset_launch_counts

    t_start = time.perf_counter()
    smi = _nvidia_smi()
    _emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count(), "nvidia_smi": smi,
           "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    _build.build_all()
    ptxas = [ln.strip() for name in LIBRARIES
             for ln in _build.ptxas_report(name).splitlines()
             if "Used" in ln or "spill" in ln or "Compiling entry" in ln]
    sass = {name: sass_counts(name) for name in LIBRARIES}
    _emit({"phase": "build", "seconds": time.perf_counter() - t0, "ptxas": ptxas, "sass": sass})
    lacking = [(fn, op) for counts in sass.values() for fn, n in counts.items()
               for key, ops in SASS_NEEDS.items() if key in fn for op in ops if not n[op]]
    if lacking:
        raise AssertionError(f"kernels without the instructions of their design: {lacking}")

    rng = np.random.default_rng(0)
    reset_launch_counts()
    with PartitionService(max_entries=64) as svc:
        plan, *big = phase_dedicated(svc, rng)
        phase_graph_serving()
        batched_plans = phase_batched(svc)
        launches = launch_counts()
        missing = [name for name in SPMV_KERNELS if launches[name] == 0]
        if missing:
            raise AssertionError(f"kernels not launched on the SpMV path: {missing}")
        by_path = {"spmv": launches}
        for path, phase in (("multitenant", phase_multitenant),
                            ("replicated", phase_replicated), ("overload", phase_overload)):
            reset_launch_counts()
            out = phase()
            by_path[path] = launch_counts()
            _emit({**out, "launches": by_path[path]})
            missing = [name for name in PATH_KERNELS[path] if by_path[path][name] == 0]
            if missing:
                raise AssertionError(f"kernels not launched on the {path} path: {missing}")
        launches = {name: sum(c[name] for c in by_path.values()) for name in launches}
        entries = phase_kernels(plan, big, batched_plans, launches)
        phase_profile(svc, big, batched_plans[0][1])

    for path in LM_PATHS:
        cfg, state, by_path[path], experts_read = phase_serving(path)
        if path == "lm_serving":
            entries += phase_lm_kernels(cfg, state, by_path[path])
        phase_lm_profile(cfg, state, path, experts_read)
        if path == "hybrid_serving":  # its weights, while they are on the card
            shapes = phase_zoo_kernels(cfg, state)
            for en in entries:
                en.update(shapes.get(en["name"], {}))
        del state
        torch.cuda.empty_cache()
        if path == "lm_serving":
            phase_lm_checks()
            torch.cuda.empty_cache()
    by_path["training"] = phase_training()
    entries += phase_train_kernels()
    dry = DryRun()  # on the host's cores, beside the checks that are not timed
    try:
        with restart_check_beside():
            phase_train_checks()
            torch.cuda.empty_cache()
            phase_examples()
        torch.cuda.empty_cache()
        dry.wait()  # no dry-run process competes for the host while sharded is timed
        sharded = phase_sharded(dry.alive())
        by_path["sharded"] = sharded["serve"]["launches"]
        phase_dryrun(dry, sharded)
    finally:
        dry.stop()
    _set_launches(entries, by_path)
    _emit({"kernels": entries})
    _emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    _emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
