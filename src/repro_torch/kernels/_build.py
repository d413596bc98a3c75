"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` becomes ``build/repro_torch/<name>-<hash>.so`` at the
root of the checkout, where the hash covers the source and the flags, so an
edited source is rebuilt and an unchanged one is loaded as it is.  ``nvcc``'s
``-Xptxas -v`` report (registers, shared memory and spills per kernel) is kept
beside the library as ``<name>-<hash>.ptxas.txt``.  Nothing is built at import
time: the first kernel launch builds what it needs, and :func:`build_all`
builds every source at once, one ``nvcc`` per source, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["BUILD_DIR", "CSRC", "NVCC_FLAGS", "build_all", "find_nvcc", "library", "ptxas_report"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """``nvcc`` from ``CUDA_HOME``, then ``/usr/local/cuda/bin``, then ``PATH``."""
    tried = []
    cuda_home = os.environ.get("CUDA_HOME")
    if cuda_home:
        tried.append(str(Path(cuda_home) / "bin" / "nvcc"))
    tried.append("/usr/local/cuda/bin/nvcc")
    for cand in tried:
        if os.access(cand, os.X_OK):
            return cand
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(f"nvcc not found; tried {', '.join(tried)} and PATH")


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{h}.so"


def ptxas_report(name: str) -> str:
    """The ``-Xptxas -v`` output saved when ``csrc/<name>.cu`` was built."""
    return _target(name).with_suffix(".ptxas.txt").read_text()


def build_all(names=None) -> list[Path]:
    """Compile the named sources (default: every ``csrc/*.cu``) that are not
    built yet, one ``nvcc`` process per source, all running at once."""
    names = sorted(p.stem for p in CSRC.glob("*.cu")) if names is None else list(names)
    targets = [_target(n) for n in names]
    todo = [(n, t) for n, t in zip(names, targets) if not t.exists()]
    if not todo:
        return targets
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, target in todo:
        tmp = target.with_name(f"{target.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, target, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, target, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):\n{out}")
            continue
        target.with_suffix(".ptxas.txt").write_text(out)
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("\n".join(failed))
    return targets


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            (path,) = build_all([name])
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
        return lib
