"""One run of one cell: the entry its mix names, the per-layer readers, the result line.

``run_cell`` returns the result as a dict; ``main`` checks the chip first and
the modules loaded last, and prints the result as the last line of standard
output, with each number the check compared beside its limit as the last
lines of standard error and under the result's last key, ``checks``.
"""
from __future__ import annotations

import argparse
import importlib
import json
import math
import sys
import time
from types import SimpleNamespace

from . import check, spec
from .spec import dims

#: Top-level module names no process of the benchmark may hold: JAX and the
#: JAX package this program was ported from.
BANNED = ("jax", "jaxlib", "flax", "repro")


def banned_modules(modules=None) -> list[str]:
    """The banned top-level names among the loaded modules, compared whole."""
    tops = {name.split(".")[0] for name in (sys.modules if modules is None else modules)}
    return sorted(tops & set(BANNED))


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device, t0: float,
             conf: dict | None = None, mix: dict | None = None, limits: dict | None = None) -> dict:
    """Run ``cell`` (an entry of ``BENCHMARK.json``) once and return its
    result.  ``conf``, ``mix`` and ``limits`` stand in for the cell's files
    where given (the CPU tests run reduced sizes)."""
    conf = conf or spec.config(cell["config"])
    mix = mix or spec.traffic(cell["traffic"])
    limits = limits or spec.limits(cell["name"])
    entry = importlib.import_module(f"portbench.entries.{mix['entry']}")
    profiler = None
    if trace:
        from .trace import Profiler

        profiler = Profiler(**mix["traced"])
    out = entry.run(conf, mix, limits, seed, seconds, profiler, device)
    checks = out["checks"]
    result = {"correct": check.verdict(checks), "attempted": out["attempted"],
              "failed": out["failed"]}
    setup_s = out["setup_done"] - t0
    if trace:
        ctx = SimpleNamespace(conf=conf, m=dims(conf), mix=mix, records=out["records"],
                              window_s=out["window_s"], trace=profiler.trace)
        metrics = {}
        for metric in spec.per_layer(cell):
            value = spec.reader(metric["name"])(ctx)
            if value is not None:
                metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}
        result["metrics"] = metrics
    else:
        values = {**out["e2e"], "setup_s": setup_s}
        result["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                             for m in spec.end_to_end(cell)}
    result["device"] = _device(cell, out["memory_peak_bytes"], device)
    if trace:
        t = profiler.trace
        result["device"].update(busy_s=t.busy_s, window_s=t.window_s)
        result["breakdown"] = {"device_ops": t.top_ops(), "idle_gaps": t.idle_gaps()}
    result["checks"] = {k: {"value": _finite(v), "limit": lim} for k, (v, lim) in checks.items()}
    return result


def _finite(v: float):
    """A number JSON can hold; one that cannot be read stays a string."""
    return v if math.isfinite(v) else str(v)


def _device(cell: dict, peak: int, device) -> dict:
    import torch

    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": cell["chips"], "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell["chips"],
            "memory_peak_bytes": peak}


def main(argv=None, t0: float | None = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    ap = argparse.ArgumentParser(description="Run one cell of the port's benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.workload(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t0)
    loaded = banned_modules()
    if loaded:
        print(f"modules that must not be loaded are loaded: {', '.join(loaded)}", file=sys.stderr)
        return 3
    check.report({k: (float(v["value"]), v["limit"]) for k, v in result["checks"].items()})
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0
