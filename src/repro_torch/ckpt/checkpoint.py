"""Async, atomic checkpointing in the reference's on-disk format (port of ``repro.ckpt``).

Layout (one directory per step), byte for byte the reference's:

    <root>/step_00001230.tmp.<nonce>/   — staged write
        manifest.json                   — {"leaves": [{path, file, shape, dtype}]}
        leaf_00000.bin ...              — raw little-endian buffers
    <root>/step_00001230/               — atomic rename on completion

A tree is flattened as ``jax.tree_util`` flattens the reference's: dict keys
in sorted order, ``[i]`` for list and tuple items, and ``0``, ``1``, ``2`` for
the fields of a :class:`~repro_torch.runtime.train.TrainState` (params,
opt_state, step); a :class:`~repro_torch.models.params.Params` is written in
the reference's stacked layout (:meth:`~repro_torch.models.params.Params.reference_tree`:
one leaf per weight of all layers), so a checkpoint written by either
package restores in the other.  bfloat16 leaves are stored as their uint16
payload with ``"bfloat16"`` in the manifest and read back through a torch
view (the reference reads them with ``ml_dtypes``, which ships with jax).

Protocol, as the reference's:
  * **atomic commit**: a checkpoint is visible iff the final rename
    happened; a crash mid-write leaves only a ``.tmp.*`` directory that
    restore ignores and :class:`CheckpointManager` garbage-collects;
  * **async**: ``save`` copies the tree to host memory before it returns
    (the next step updates the weights in place) and writes on a background
    thread; ``wait()`` joins and re-raises the writer's error;
  * **retention**: the newest ``keep`` complete checkpoints stay;
  * **restore onto a device**: buffers are stored device-free, and each
    leaf is put on the ``device`` asked for (each ``like`` leaf's own if
    None).  Re-sharding onto a mesh belongs to the sharding slice.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import uuid
from typing import Any, Optional

import numpy as np
import torch

from ..models.params import Params, from_reference_layout
from ..runtime.train import TrainState

__all__ = ["CheckpointManager", "save_pytree", "restore_pytree", "latest_step"]

_DTYPES = {torch.float32: "float32", torch.float64: "float64", torch.bfloat16: "bfloat16",
           torch.float16: "float16", torch.int64: "int64", torch.int32: "int32",
           torch.int16: "int16", torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool"}


def _host(x) -> np.ndarray:
    """A host copy of a leaf as numpy (never a view of it); bfloat16 as its
    uint16 payload."""
    if isinstance(x, torch.Tensor):
        bf16 = x.dtype == torch.bfloat16
        x = x.detach()
        arr = (x.view(torch.int16) if bf16 else x).to("cpu", copy=True).numpy()
        return arr.view(np.uint16) if bf16 else arr
    return np.array(x)


def _dtype_name(x) -> str:
    return _DTYPES[x.dtype] if isinstance(x, torch.Tensor) else str(np.asarray(x).dtype)


def _flatten(tree, path=()):
    """``[(path, leaf)]`` in the reference's order; a ``Params`` is one subtree
    in the stacked layout, each leaf a ``(uint16-or-native numpy, dtype)``
    pair computed on the host."""
    if isinstance(tree, TrainState):
        tree = {0: tree.params, 1: tree.opt_state, 2: tree.step}
    if isinstance(tree, Params):  # weights are floats: a uint16 payload is a bfloat16's
        return [(p, (a, "bfloat16" if a.dtype == np.uint16 else str(a.dtype)))
                for p, a in _flatten_host(tree.reference_tree(_host), path)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k], path + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _flatten(v, path + (f"[{i}]",))]
    return [("/".join(path), (_host(tree), _dtype_name(tree)))]


def _flatten_host(tree, path):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten_host(tree[k], path + (k,))]
    return [("/".join(path), tree)]


def _write(flat, directory: str) -> None:
    parent = os.path.dirname(directory) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = f"{directory}.tmp.{uuid.uuid4().hex[:8]}"
    os.makedirs(tmp)
    manifest = {"leaves": []}
    for i, (path, (arr, dtype_name)) in enumerate(flat):
        fname = f"leaf_{i:05d}.bin"
        with open(os.path.join(tmp, fname), "wb") as f:
            f.write(np.ascontiguousarray(arr).tobytes())
        manifest["leaves"].append(
            {"path": path, "file": fname, "shape": list(arr.shape), "dtype": dtype_name})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, directory) if not os.path.exists(directory) else shutil.rmtree(tmp)


def save_pytree(tree: Any, directory: str) -> None:
    """Synchronous staged+atomic write of one tree (tensors, numpy arrays,
    dicts, lists, ``Params``, ``TrainState``)."""
    _write(_flatten(tree), directory)


def _read(directory: str, e: dict) -> np.ndarray:
    raw = np.uint16 if e["dtype"] == "bfloat16" else np.dtype(e["dtype"])
    with open(os.path.join(directory, e["file"]), "rb") as f:
        return np.frombuffer(f.read(), dtype=raw).reshape(e["shape"])


def _tensor(arr: np.ndarray, dtype_name: str, device) -> torch.Tensor:
    arr = np.array(arr)  # writable
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def restore_pytree(directory: str, like: Any, device=None) -> Any:
    """Restore into the structure of ``like`` (a tree of the kind
    :func:`save_pytree` writes), each leaf on ``device`` (``like``'s leaf's
    device if None); a ``Params`` comes back frozen or trainable as ``like``'s."""
    with open(os.path.join(directory, "manifest.json")) as f:
        by_path = {e["path"]: e for e in json.load(f)["leaves"]}

    def leaf(path, like_leaf):
        e = by_path["/".join(path)]
        dev = device if device is not None else getattr(like_leaf, "device", "cpu")
        return _tensor(_read(directory, e), e["dtype"], dev)

    def stacked(path):
        """The stored subtree under ``path``, as nested dicts of CPU tensors."""
        prefix = "".join(f"{k}/" for k in path)
        out: dict = {}
        for p, e in by_path.items():
            if p.startswith(prefix):
                *keys, last = p[len(prefix):].split("/")
                d = out
                for k in keys:
                    d = d.setdefault(k, {})
                d[last] = _tensor(_read(directory, e), e["dtype"], "cpu")
        return out

    def walk(t, path):
        if isinstance(t, TrainState):
            return TrainState(params=walk(t.params, path + ("0",)),
                              opt_state=walk(t.opt_state, path + ("1",)),
                              step=walk(t.step, path + ("2",)))
        if isinstance(t, Params):
            return from_reference_layout(stacked(path), t, device)
        if isinstance(t, dict):
            return {k: walk(v, path + (str(k),)) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v, path + (f"[{i}]",)) for i, v in enumerate(t))
        return leaf(path, t)

    return walk(like, ())


def _step_dirs(root: str) -> list[tuple[int, str]]:
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        if name.startswith("step_") and ".tmp." not in name:
            try:
                out.append((int(name[5:]), os.path.join(root, name)))
            except ValueError:
                continue
    return sorted(out)


def latest_step(root: str) -> Optional[int]:
    dirs = _step_dirs(root)
    return dirs[-1][0] if dirs else None


class CheckpointManager:
    """Async save + retention + restart discovery."""

    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(root, exist_ok=True)
        self._gc_tmp()

    def _gc_tmp(self):
        for name in os.listdir(self.root):
            if ".tmp." in name:
                shutil.rmtree(os.path.join(self.root, name), ignore_errors=True)

    def directory(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:08d}")

    def save(self, step: int, tree: Any, blocking: bool = False) -> None:
        self.wait()  # one in-flight save at a time
        # Snapshot to host now: the next step updates the weights in place.
        flat = _flatten(tree)

        def _job():
            try:
                _write(flat, self.directory(step))
                self._retain()
            except BaseException as e:  # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=_job, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _retain(self):
        dirs = _step_dirs(self.root)
        for _, d in dirs[: -self.keep]:
            shutil.rmtree(d, ignore_errors=True)

    def latest(self) -> Optional[int]:
        return latest_step(self.root)

    def restore(self, like: Any, step: Optional[int] = None, device=None) -> tuple[int, Any]:
        self.wait()
        if step is None:
            step = self.latest()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        return step, restore_pytree(self.directory(step), like, device)
