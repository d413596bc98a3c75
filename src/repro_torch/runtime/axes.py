"""Logical activation-sharding hints for model code (port of ``repro.runtime.axes``).

Model layers are mesh-agnostic; launchers install an ``ActivationSharding``
profile (a ``DeviceMesh`` and a logical -> mesh-axis mapping) and layers
call ``hint(x, "batch", None, None)`` at block boundaries.  A hint
redistributes a DTensor to the resolved placements; without a profile
installed, or on a plain tensor (single-device runs, the CPU tests), it
returns ``x`` as it is.

Divisibility-guarded like the weight rules: a logical axis resolves to its
mesh axes only when the dim divides evenly (else a divisible prefix of a
compound axis, else replicated), so batch=1 decode shapes replicate instead
of failing.  :func:`to_placements` turns the resolved spec (``None``, an axis
name or a tuple of names per tensor dim) into DTensor placements, one per
mesh dim.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

__all__ = ["ActivationSharding", "get_activation_sharding", "hint", "mesh_axes",
           "resolve", "set_activation_sharding", "to_placements"]

_ACTIVE: Optional["ActivationSharding"] = None


def mesh_axes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` (or of any object whose
    ``shape`` is already such a dict, as a spec-only stand-in)."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def to_placements(spec, mesh) -> list:
    """DTensor placements of a spec tuple on ``mesh``: mesh axis ``a`` shards
    tensor dim ``i`` where ``a`` is, or is in, ``spec[i]``; other mesh axes
    replicate.  A dim sharded over two mesh axes is chunked in mesh-dim order
    (DTensor's), which for serve's wide ``("model", "data")`` is not JAX's
    model-major chunk order: the bytes per device agree, the chunk each
    device holds does not (see ``runtime/sharding.py``)."""
    owner = {}
    for i, entry in enumerate(spec):
        for name in (entry if isinstance(entry, (tuple, list)) else (entry,)):
            if name is not None:
                owner[name] = i
    return [Shard(owner[a]) if a in owner else Replicate() for a in mesh.mesh_dim_names]


@dataclasses.dataclass(frozen=True)
class ActivationSharding:
    mesh: object  # a torch.distributed DeviceMesh
    logical: dict  # e.g. {'batch': ('pod','data'), 'model': ('model',)}

    def axis_size(self, names) -> int:
        shape = mesh_axes(self.mesh)
        return math.prod(shape.get(a, 1) for a in names)


def set_activation_sharding(profile: Optional[ActivationSharding]) -> None:
    global _ACTIVE
    _ACTIVE = profile


def get_activation_sharding() -> Optional[ActivationSharding]:
    return _ACTIVE


def resolve(prof: ActivationSharding, shape, logical_spec) -> tuple:
    """The spec tuple of logical axes ``logical_spec`` for a tensor of
    ``shape``: each name's mesh axes, guarded by divisibility with the
    compound-prefix fallback."""
    dims = []
    for i, name in enumerate(logical_spec):
        axes = tuple(prof.logical.get(name) or ()) if name is not None else ()
        chosen = None
        for cut in range(len(axes), 0, -1):
            sub = axes[:cut]
            if shape[i] % prof.axis_size(sub) == 0:
                chosen = sub if len(sub) > 1 else sub[0]
                break
        dims.append(chosen)
    return tuple(dims)


def hint(x: torch.Tensor, *logical_spec) -> torch.Tensor:
    """Redistribute the DTensor ``x`` to the resolved logical spec (no-op
    without a profile or on a plain tensor).

    Entries are logical axis names ('batch', 'model', ...) or None.
    """
    prof = _ACTIVE
    if prof is None or not isinstance(x, DTensor):
        return x
    spec = resolve(prof, x.shape, logical_spec)
    try:
        return x.redistribute(x.device_mesh, to_placements(spec, x.device_mesh))
    except Exception:
        return x
