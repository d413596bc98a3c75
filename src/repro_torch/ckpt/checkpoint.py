"""Sharded, async, atomic checkpointing with elastic re-mesh restore (port of ``repro.ckpt``).

Layout (one directory per step), byte for byte the reference's:

    <root>/step_00001230.tmp.<nonce>/   — staged write
        manifest.json                   — {"leaves": [{path, file, shape, dtype}]}
        leaf_00000.bin ...              — raw little-endian buffers
    <root>/step_00001230/               — atomic rename on completion

A tree is flattened as ``jax.tree_util`` flattens the reference's: dict keys
in sorted order, ``[i]`` for list and tuple items, and ``0``, ``1``, ``2`` for
the fields of a :class:`~repro_torch.runtime.train.TrainState` (params,
opt_state, step); a :class:`~repro_torch.models.params.Params` is written in
the reference's stacked layout (one leaf per weight of all layers: layer
``i`` of a per-layer weight is index ``[i]`` of the stored array), so a
checkpoint written by either package restores in the other.  bfloat16
leaves are stored as their uint16 payload with ``"bfloat16"`` in the
manifest and read back through a torch view (the reference reads them with
``ml_dtypes``, which ships with jax).

A leaf may be a DTensor (the weights and AdamW moments that
:func:`~repro_torch.runtime.sharding.distribute_params` places, one process
per device).  A stored leaf is still one logical array, so a group's
directory is the one a single process writes from the same values:

  * **sharded save**: each rank copies to the host only the regions its
    local shards cover and writes them at their place in the leaf's file
    (every rank sets the file to its full size, then writes its regions
    through a mapping of it); where a mesh dim replicates a leaf only the rank at
    coordinate 0 on that dim writes it, a plain tensor is written by rank 0
    of the group, and a ``Partial`` leaf raises.  No rank gathers a leaf;
  * **elastic re-mesh restore**: a DTensor leaf of ``like`` comes back as a
    DTensor with ``like``'s mesh and placements, or with those that
    ``shardings`` gives (a tree matching ``like`` whose leaves are
    ``(DeviceMesh, placements)`` pairs, or None for a plain tensor: the
    reference's ``NamedSharding`` tree; for a ``Params``, a dict in the
    stacked layout of one layer's placements,
    :func:`~repro_torch.runtime.sharding.param_shardings`).  Each rank reads
    only its shard's region of each file.  ``like`` may live on the meta
    device (the port's ``jax.eval_shape``); the leaves then land on the
    mesh's device, or on ``device`` for plain ones.  Shard regions follow
    DTensor's chunking: each ``Shard`` in mesh-dim order, ``torch.chunk``'s
    ceil(n/k) a piece, the last pieces shorter or empty.

Protocol, as the reference's, with the commit made through the file system:
  * **atomic commit**: a checkpoint is visible iff the final rename
    happened.  Each rank writes its regions into the shared
    ``.tmp.<nonce>`` directory (the ranks agree on the nonce when the
    manager is built), then leaves a ``done`` marker there; rank 0 waits
    for every rank's marker (up to ``TIMEOUT_S``), removes them, writes
    ``manifest.json`` and renames the directory.  A rank whose write (or,
    on rank 0, whose wait or commit) raises leaves a ``failed`` marker
    instead, on which every other rank raises at once.  A failed or missing
    rank is never committed: its ``.tmp.*`` directory stays, restore
    ignores it, and rank 0's next :class:`CheckpointManager`
    garbage-collects it;
  * **async**: ``save`` copies the rank's regions to host memory before it
    returns (the next step updates the weights in place) and writes on a
    background thread, which issues no collective (it would interleave with
    the train step's); ``wait()`` returns once the commit is visible (on a
    rank other than 0, once the staged directory is renamed) and re-raises
    the writer's error;
  * **retention**: the newest ``keep`` complete checkpoints stay (rank 0
    removes the rest);
  * **single host**: the ranks of the default group share one file system
    and give the same path.
"""
from __future__ import annotations

import functools
import json
import math
import os
import shutil
import threading
import time
import uuid
from typing import Any, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..models.params import Params, stack_shape
from ..runtime.train import TrainState

__all__ = ["CheckpointManager", "save_pytree", "restore_pytree", "latest_step"]

_DTYPES = {torch.float32: "float32", torch.float64: "float64", torch.bfloat16: "bfloat16",
           torch.float16: "float16", torch.int64: "int64", torch.int32: "int32",
           torch.int16: "int16", torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool"}
TIMEOUT_S = 1800.0  # how long rank 0 waits for the other ranks' regions
_POLL_S = 0.02
_LIKE = object()  # no ``shardings``: each leaf keeps ``like``'s layout


def _group() -> tuple[int, int]:
    """``(rank, world)`` in the default group when one is initialised, else
    one process's."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def _agree(value, world):
    """Rank 0's ``value`` on every rank of the default group (a broadcast)."""
    if world == 1:
        return value
    import torch.distributed as dist

    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _raw(dtype_name: str) -> np.dtype:
    return np.dtype(np.uint16 if dtype_name == "bfloat16" else dtype_name)


def _host(x) -> np.ndarray:
    """A host copy of a plain tensor as numpy (never a view of it); bfloat16
    as its uint16 payload."""
    if isinstance(x, torch.Tensor):
        bf16 = x.dtype == torch.bfloat16
        x = x.detach()
        arr = (x.view(torch.int16) if bf16 else x).to("cpu", copy=True).numpy()
        return arr.view(np.uint16) if bf16 else arr
    return np.array(x)


def _shard_box(shape, mesh, placements) -> tuple[list, list, bool]:
    """``(offsets, sizes, writer)`` of this rank's shard of a ``shape`` leaf
    placed by ``placements`` on ``mesh``, chunked as DTensor chunks;
    ``writer``: whether this rank is at coordinate 0 on every mesh dim that
    replicates the leaf."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise RuntimeError(f"this rank is not in {mesh}: it holds no shard to place")
    off, size, writer = [0] * len(shape), list(shape), True
    for d, (pl, c) in enumerate(zip(placements, coord)):
        if type(pl) is Shard:
            k, n = pl.dim, mesh.size(d)
            piece = -(-size[k] // n)
            lo = min(c * piece, size[k])
            off[k] += lo
            size[k] = min(lo + piece, size[k]) - lo
        elif type(pl) is Replicate:
            writer = writer and c == 0
        else:
            raise ValueError(f"cannot place a {pl} leaf: only Shard and Replicate are stored")
    return off, size, writer


def _box(off, size) -> tuple:
    return tuple(slice(o, o + z) for o, z in zip(off, size))


def _write_box(path, shape, raw: np.dtype, off, size, arr: np.ndarray) -> None:
    """``arr`` into the box ``(off, size)`` of the C-ordered ``shape`` array
    that the file at ``path`` (already of its full size) holds: a mapped
    copy, so that the pages this rank does not touch stay as they are."""
    if arr.size:
        mm = np.memmap(path, raw, "r+", shape=tuple(shape))
        mm[_box(off, size)] = arr.reshape(size)
        del mm  # unmapped: the pages stay in the page cache, written back by the OS


def _read_box(path, shape, off, size, raw: np.dtype) -> np.ndarray:
    """A copy of the box ``(off, size)`` of the ``shape`` array at ``path``."""
    if not math.prod(size):
        return np.empty(size, raw)
    if os.path.getsize(path) < math.prod(shape) * raw.itemsize:
        raise ValueError(f"{path} is shorter than its manifest's shape {shape}")
    mm = np.memmap(path, raw, "r", shape=tuple(shape))
    out = np.array(mm[_box(off, size)])
    del mm
    return out


def _dtype_name(x) -> str:
    return _DTYPES[x.dtype] if isinstance(x, torch.Tensor) else str(np.asarray(x).dtype)


def _flatten(tree, path=()):
    """``[(path, stored shape, dtype name, [(layer index, leaf)])]`` in the
    reference's order; a ``Params`` leaf is one weight of all its layers."""
    if isinstance(tree, TrainState):
        tree = {0: tree.params, 1: tree.opt_state, 2: tree.step}
    if isinstance(tree, Params):
        parts: dict = {}
        for sub, index, p in tree.stacked_parts():
            parts.setdefault(sub, []).append((index, p.detach()))
        return [_leaf(path + sub, parts[sub]) for sub in sorted(parts)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k], path + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _flatten(v, path + (f"[{i}]",))]
    return [_leaf(path, [((), tree)])]


def _leaf(path, parts):
    first = parts[0][1]
    return ("/".join(path), stack_shape(parts) + tuple(np.shape(first)), _dtype_name(first), parts)


def _snapshot(flat, rank: int, world: int) -> tuple[list, int]:
    """Each leaf of ``flat`` with the regions this rank writes, copied to the
    host: ``[(path, shape, dtype name, [(offsets, sizes, array)])]``, and
    their bytes."""
    out, nbytes = [], 0
    for path, shape, dtype_name, parts in flat:
        pieces = []
        for index, x in parts:
            lead, rest = list(index), [1] * len(index)
            if isinstance(x, DTensor):
                mesh = x.device_mesh
                if mesh.size() > world:
                    raise RuntimeError(f"{path}: a leaf on {mesh.size()} ranks needs a group of "
                                       f"as many; this one has {world}")
                off, size, writer = _shard_box(tuple(x.shape), mesh, x.placements)
                local = x.to_local()
                if list(local.shape) != size:
                    raise RuntimeError(f"{path}: local shard {tuple(local.shape)}, DTensor's "
                                       f"chunking gives {tuple(size)}")
                if writer and local.numel():
                    pieces.append((lead + off, rest + size, _host(local)))
            elif rank == 0:
                arr = _host(x)
                pieces.append((lead + [0] * arr.ndim, rest + list(arr.shape), arr))
        nbytes += sum(a.nbytes for _, _, a in pieces)
        out.append((path, shape, dtype_name, pieces))
    return out, nbytes


def _write_pieces(leaves, tmp: str, rank: int) -> None:
    for i, (_, shape, dtype_name, pieces) in enumerate(leaves):
        if not pieces and rank != 0:
            continue
        path, raw = os.path.join(tmp, f"leaf_{i:05d}.bin"), _raw(dtype_name)
        fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
        try:  # every rank sets the full size; the sizes agree, so no region is cut
            os.ftruncate(fd, math.prod(shape) * raw.itemsize)
        finally:
            os.close(fd)
        for off, size, arr in pieces:
            _write_box(path, shape, raw, off, size, arr)


def _marker(rank: int, state: str) -> str:
    return f".rank{rank:05d}.{state}"


def _markers(tmp: str):
    names = os.listdir(tmp)
    failed = sorted(n for n in names if n.startswith(".rank") and n.endswith(".failed"))
    if failed:
        raise RuntimeError(f"a rank failed to write {tmp} ({failed}): not committed")
    return names


def _write_manifest(leaves, tmp: str) -> None:
    manifest = {"leaves": [
        {"path": path, "file": f"leaf_{i:05d}.bin", "shape": list(shape), "dtype": dtype_name}
        for i, (path, shape, dtype_name, _) in enumerate(leaves)]}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)


def _commit(leaves, directory: str, tmp: str, rank: int, world: int) -> None:
    """Write this rank's regions into ``tmp``, mark them, and (rank 0) commit
    once every rank has; every rank returns once the commit is visible.  A
    rank that fails leaves a ``failed`` marker, on which the others raise."""
    os.makedirs(tmp, exist_ok=True)
    try:
        _write_pieces(leaves, tmp, rank)
        open(os.path.join(tmp, _marker(rank, "done")), "w").close()
        if rank == 0:
            want = {_marker(r, "done") for r in range(world)}
            deadline = time.monotonic() + TIMEOUT_S
            while not want <= set(_markers(tmp)):
                if time.monotonic() > deadline:
                    missing = sorted(want - set(os.listdir(tmp)))
                    raise TimeoutError(f"{missing} not in {tmp} after {TIMEOUT_S} s: "
                                       "not committed")
                time.sleep(_POLL_S)
            for name in want:
                os.remove(os.path.join(tmp, name))
            _write_manifest(leaves, tmp)
            os.replace(tmp, directory) if not os.path.exists(directory) else shutil.rmtree(tmp)
            return
    except BaseException:
        if os.path.isdir(tmp):
            open(os.path.join(tmp, _marker(rank, "failed")), "w").close()
        raise
    deadline = time.monotonic() + TIMEOUT_S
    while True:
        try:
            _markers(tmp)
        except FileNotFoundError:  # renamed (or discarded beside an earlier commit)
            break
        if time.monotonic() > deadline:
            raise TimeoutError(f"{tmp} not committed after {TIMEOUT_S} s")
        time.sleep(_POLL_S)
    if not os.path.isdir(directory):
        raise RuntimeError(f"{tmp} is gone and {directory} was not committed")


def save_pytree(tree: Any, directory: str) -> None:
    """Synchronous staged+atomic write of one tree (tensors, DTensors, numpy
    arrays, dicts, lists, ``Params``, ``TrainState``).  In a process group
    (the default one) every rank calls it with the same ``directory``; each
    writes its own regions."""
    rank, world = _group()
    nonce = _agree(uuid.uuid4().hex[:8], world)
    leaves, _ = _snapshot(_flatten(tree), rank, world)
    _commit(leaves, directory, f"{directory}.tmp.{nonce}", rank, world)


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _restore_leaf(directory, e, index, like_leaf, sh, device):
    """Layer ``index`` of the stored leaf ``e`` laid out as ``sh`` says: a
    ``(mesh, placements)`` pair (this rank's region only, as a DTensor), None
    (plain, on ``device`` or ``like_leaf``'s), or ``_LIKE`` (``like_leaf``'s
    layout)."""
    stored = tuple(e["shape"])
    shape = tuple(like_leaf.shape) if hasattr(like_leaf, "shape") else stored[len(index):]
    if stored[len(index):] != shape or any(i >= n for i, n in zip(index, stored)):
        raise ValueError(f"{e['path']}: stored {stored}, the template wants layer {index} "
                         f"of {shape}")
    if sh is _LIKE:
        sh = ((like_leaf.device_mesh, like_leaf.placements) if isinstance(like_leaf, DTensor)
              else None)
    if sh is None:
        dev = device if device is not None else getattr(like_leaf, "device", "cpu")
        if torch.device(dev).type == "meta":
            raise ValueError(f"{e['path']}: a plain leaf of a meta template needs device=")
        off, size = [0] * len(shape), list(shape)
    else:
        mesh, pls = sh
        off, size, _ = _shard_box(shape, mesh, pls)
        if (isinstance(like_leaf, DTensor) and like_leaf.device_mesh == mesh
                and tuple(like_leaf.placements) == tuple(pls)
                and list(like_leaf.to_local().shape) != size):
            raise RuntimeError(f"{e['path']}: template shard {tuple(like_leaf.to_local().shape)}, "
                               f"DTensor's chunking gives {tuple(size)}")
        dev = _mesh_device(mesh)
    arr = _read_box(os.path.join(directory, e["file"]), stored, list(index) + off,
                    [1] * len(index) + size, _raw(e["dtype"])).reshape(size)
    t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16) if e["dtype"] == "bfloat16" \
        else torch.from_numpy(arr)
    t = t.to(dev)
    if sh is None:
        return t
    return DTensor.from_local(t, mesh, pls, run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def _sub(sh, key):
    """The ``shardings`` subtree under ``key`` (None and ``_LIKE`` hold for
    the whole subtree)."""
    if sh is _LIKE or sh is None:
        return sh
    return getattr(sh, key) if isinstance(sh, TrainState) else sh[key]


def restore_pytree(directory: str, like: Any, device=None, shardings: Optional[Any] = None) -> Any:
    """Restore into the structure of ``like`` (a tree of the kind
    :func:`save_pytree` writes, on any device, the meta device included).

    Each leaf comes back laid out as ``like``'s (a DTensor on its mesh and
    placements, a plain tensor on ``device`` or ``like``'s device), or as
    ``shardings`` says where given: the elastic re-mesh (see the module's
    docstring).  A ``Params`` comes back frozen or trainable as ``like``'s."""
    with open(os.path.join(directory, "manifest.json")) as f:
        by_path = {e["path"]: e for e in json.load(f)["leaves"]}

    def walk(t, sh, path):
        if isinstance(t, TrainState):
            return TrainState(params=walk(t.params, _sub(sh, "params"), path + ("0",)),
                              opt_state=walk(t.opt_state, _sub(sh, "opt_state"), path + ("1",)),
                              step=walk(t.step, _sub(sh, "step"), path + ("2",)))
        if isinstance(t, Params):
            return t.map_stacked(lambda sub, index, p: _restore_leaf(
                directory, by_path["/".join(path + sub)], index, p,
                functools.reduce(_sub, sub, sh), device))
        if isinstance(t, dict):
            return {k: walk(v, _sub(sh, k), path + (str(k),)) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v, _sub(sh, i), path + (f"[{i}]",)) for i, v in enumerate(t))
        return _restore_leaf(directory, by_path["/".join(path)], (), t, sh, device)

    return walk(like, _LIKE if shardings is None else shardings, ())


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
    """Async save + retention + restart discovery, for one process or for
    every rank of the default group when one is initialised.

    Built on every rank of the group, in the same order (the ranks agree on
    a nonce here).  ``last_save`` holds the last save's ``snapshot_bytes``
    (this rank's regions), ``snapshot_s`` and ``write_s``."""

    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        self.rank, self.world = _group()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._saves = 0
        self.last_save: dict = {}
        os.makedirs(root, exist_ok=True)
        if self.rank == 0:
            self._gc_tmp()
        self._nonce = _agree(uuid.uuid4().hex[:8], self.world)

    def _gc_tmp(self):
        for name in os.listdir(self.root):
            if ".tmp." in name:
                shutil.rmtree(os.path.join(self.root, name), ignore_errors=True)

    def directory(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:08d}")

    def save(self, step: int, tree: Any, blocking: bool = False) -> None:
        self.wait()  # one in-flight save at a time
        t0 = time.perf_counter()
        # Snapshot to host now: the next step updates the weights in place.
        leaves, nbytes = _snapshot(_flatten(tree), self.rank, self.world)
        self.last_save = {"snapshot_bytes": nbytes, "snapshot_s": time.perf_counter() - t0}
        directory = self.directory(step)
        tmp = f"{directory}.tmp.{self._nonce}{self._saves:x}"
        self._saves += 1

        def _job():
            try:
                t1 = time.perf_counter()
                _commit(leaves, directory, tmp, self.rank, self.world)
                self.last_save["write_s"] = time.perf_counter() - t1
                if self.rank == 0:
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
        """The newest committed step, once the save in flight is (so that
        every rank of a group sees the same one)."""
        self.wait()
        return latest_step(self.root)

    def restore(self, like: Any, step: Optional[int] = None, device=None,
                shardings: Optional[Any] = None) -> tuple[int, Any]:
        self.wait()
        if step is None:
            step = self.latest()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        return step, restore_pytree(self.directory(step), like, device, shardings)
