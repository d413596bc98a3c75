"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` becomes ``build/repro_torch/<name>-<hash>.so`` at the
root of the checkout, where the hash covers the source, every header in
``csrc/`` (``*.cuh``) and the flags, so an edited source or header is rebuilt
and an unchanged one is loaded as it is.  ``nvcc``'s
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

import torch

__all__ = ["BUILD_DIR", "CSRC", "NVCC_FLAGS", "TRAIN_LIBRARIES", "build_all", "build_train",
           "count_meta", "find_nvcc", "launch", "library", "meta_listeners", "ptxas_report", "sass"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
_entry_points: dict[tuple[str, str], ctypes._CFuncPtr] = {}


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
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def ptxas_report(name: str) -> str:
    """The ``-Xptxas -v`` output saved when ``csrc/<name>.cu`` was built."""
    return _target(name).with_suffix(".ptxas.txt").read_text()


def sass(name: str) -> str:
    """``cuobjdump -sass`` of the library of ``csrc/<name>.cu`` (built first if
    needed), with the toolkit's ``cuobjdump`` from beside ``nvcc``."""
    (lib,) = build_all([name])
    cuobjdump = Path(find_nvcc()).with_name("cuobjdump")
    return subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout


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


#: The sources the train step launches: its attention's forward and backward
#: and AdamW's.
TRAIN_LIBRARIES = ("adamw", "flash_attention", "flash_attention_bwd")
_train_built = False


def build_train() -> None:
    """Build :data:`TRAIN_LIBRARIES` together before the train step's first
    launch (one ``nvcc`` each, at once): a first step then waits for the
    longest build, not for each one after the other."""
    global _train_built
    if not _train_built:
        build_all(TRAIN_LIBRARIES)
        _train_built = True


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            (path,) = build_all([name])
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
        return lib


#: Callables ``fn(name, flops, nbytes)`` told of each kernel call on meta
#: tensors (the dry-run's counters): a kernel counted by its own formula.
meta_listeners: list = []


def count_meta(name: str, flops: float, nbytes: float) -> None:
    """Report a kernel call on meta tensors, which launches nothing, to the
    :data:`meta_listeners`: its products and the bytes it must move."""
    for fn in meta_listeners:
        fn(name, flops, nbytes)


def check_forward_only(name: str, *tensors: torch.Tensor) -> None:
    """Raise when autograd would record a product of ``tensors`` through the
    wrapper ``name``.  The serving kernels have no backward (the reference's
    Pallas kernels have none either) and write into fresh outputs through
    ctypes, so such a result would come back silently cut from the graph;
    the twin on the CPU raises as well, so that the two devices agree."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} is forward only: call it under torch.no_grad() or on tensors that do "
            "not require grad (the training path differentiates chunked_attention, whose "
            "bf16 inputs on a card take flash_attention_train and flash_attention_backward "
            "through an autograd function, and swiglu)")


def launch(name: str, symbol: str, argtypes, device: torch.device, *args) -> None:
    """Call the C entry point ``symbol`` of ``csrc/<name>.cu`` on the current stream.

    ``argtypes`` end with the stream's ``c_void_p``; tensors in ``args`` go
    as their data pointers.  The entry point returns ``cudaGetLastError()``
    after its launches, and a nonzero code raises ``RuntimeError``.
    """
    fn = _entry_points.get((name, symbol))
    if fn is None:  # typed once per entry point: a launch costs host time
        fn = getattr(library(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _entry_points[(name, symbol)] = fn
    args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{symbol} failed to launch: CUDA error {err}")
