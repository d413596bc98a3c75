"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cells are in ``BENCHMARK.json``; the last
line of standard output is the run's JSON result.  It measures the PyTorch
and CUDA package (``src/repro_torch``) and loads nothing of the JAX package.
Every build and kernel cache stays under ``build/`` in the checkout.
"""
import time

T0 = time.perf_counter()  # set-up is counted from here

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHES = ROOT / "build" / "portbench"
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(CACHES / sub)
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

if __name__ == "__main__":
    from portbench.harness import main

    sys.exit(main(t0=T0))
