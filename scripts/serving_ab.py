#!/usr/bin/env python3
"""Time the LM serving paths of several checkouts of this repository on one card, in turns.

    python3 scripts/serving_ab.py PARENT_ROOT CHANGE_ROOT [--rounds 1]

Each argument is the root of a checkout (for instance the parent commit,
unpacked with ``git archive`` into a directory that ``.gitignore`` lists, and
``.``).  Every run is a process of its own that imports that checkout's
``chip_smoke.py`` and ``repro_torch``, builds its kernels from its own
``csrc/`` and, for each path of its ``LM_PATHS`` (``lm_serving``,
``ssm_serving``, ``hybrid_serving``, ``mrope_serving``, ``encdec_serving``:
B = 4 prompts of 2,048 tokens and 32 greedy tokens, weights from seed 0),
runs ``phase_serving`` (the end-to-end first prefill and decode ms per token
of ``serve_config``), then times on the host clock, each ending in a
synchronize, ``WARM_PREFILLS`` warm prefills and ``WARM_DECODES`` warm
decode steps of the same weights and inputs, and reports their medians (and
the decode steps' minimum, which the host's other load can only raise).
Only host-side code differs between checkouts whose kernels agree, so these
times show what a change to the model's Python costs a served request.  As
a decode step is host-bound, each run also counts what one warm step asks
of the host: the aten ops it dispatches (``decode_ops``) and the Python
calls it makes (``decode_py_calls``); these counts do not vary from run to
run.

The runs go in turns, A B ... then ... B A, ``--rounds`` times, so a drift
of the card's clocks or of the host hits every checkout alike.  Prints one
JSON line per run, then one with each path's runs by checkout and the
card's name and power limit.  Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

PATHS = ("lm_serving", "ssm_serving", "hybrid_serving", "mrope_serving", "encdec_serving")
WARM_PREFILLS = 3
WARM_DECODES = 50
KEYS = ("prefill_ms", "decode_ms_per_token", "warm_prefill_ms", "warm_decode_ms",
        "warm_decode_min_ms", "decode_ops", "decode_py_calls")


def _times_ms(fn, reps) -> list:
    import torch

    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def _host_work(fn) -> tuple:
    """``(aten ops dispatched, Python calls made)`` by one call of ``fn``."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    with Ops() as ops:
        fn()
    calls = 0

    def count(frame, event, arg):
        nonlocal calls
        calls += event in ("call", "c_call")

    sys.setprofile(count)
    try:
        fn()
    finally:
        sys.setprofile(None)
    return ops.n, calls


def _path(cs, path) -> dict:
    import contextlib
    import io

    import torch

    with contextlib.redirect_stdout(io.StringIO()) as buf:  # the phase's own line
        _, state, _, _ = cs.phase_serving(path)
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    model, params, inputs = state["model"], state["compute"], state["inputs"]
    b, s, gen = cs.LM_PATHS[path][2]
    cache = None

    def prefill():
        nonlocal cache
        _, cache = model.prefill(params, inputs, s + gen)

    def decode():
        tok = torch.zeros((b, 1), dtype=torch.long, device=state["prompt"].device)
        model.decode_step(params, cache, {"tokens": tok}, s)

    with torch.no_grad():
        prefill()
        decode()
        torch.cuda.synchronize()
        decodes = _times_ms(decode, WARM_DECODES)
        ops, calls = _host_work(decode)
        return {"prefill_ms": line["prefill_ms"],
                "decode_ms_per_token": line["decode_ms_per_token"],
                "warm_prefill_ms": statistics.median(_times_ms(prefill, WARM_PREFILLS)),
                "warm_decode_ms": statistics.median(decodes),
                "warm_decode_min_ms": min(decodes), "decode_ops": ops, "decode_py_calls": calls}


def worker(root: Path) -> dict:
    import torch

    sys.path[:0] = [str(root), str(root / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import _build

    _build.build_all()
    out = {"root": str(root)}
    for path in PATHS:
        out[path] = _path(cs, path)
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+", type=Path)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.roots[0].resolve())), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("serving_ab: no CUDA device", file=sys.stderr)
        return 1
    roots = [r.resolve() for r in args.roots]
    order = [r for _ in range(args.rounds) for r in roots + roots[::-1]]
    by_root = {str(r): {p: {k: [] for k in KEYS} for p in PATHS} for r in roots}
    for root in order:
        proc = subprocess.run([sys.executable, __file__, "--worker", str(root)],
                              capture_output=True, text=True)
        if proc.returncode:
            print(f"serving_ab: the run of {root} failed:\n{proc.stderr[-4000:]}",
                  file=sys.stderr)
            return 1
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps(run), flush=True)
        for p in PATHS:
            for k in KEYS:
                by_root[run["root"]][p][k].append(run[p][k])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"ms": by_root, "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
