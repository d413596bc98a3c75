"""Production mesh construction (port of ``repro.launch.mesh``).

``make_production_mesh`` is a FUNCTION (not a module constant) and creates
no process group: importing this module touches no ``torch.distributed``
state.  The caller sets up the group first — the dry-run a ``fake`` group
of 256 or 512 ranks, the CPU tests gloo, a card a one-rank NCCL group.

Axes: 16x16 = 256 devices per pod ('data', 'model'); multi-pod adds a
leading 'pod' axis (2x16x16 = 512).  'pod' carries pure data parallelism:
exactly one gradient all-reduce per train step crosses the slow inter-pod
links.
"""
from __future__ import annotations

import math

import torch

__all__ = ["make_host_mesh", "make_mesh", "make_production_mesh"]


def _device_type() -> str:
    """``cpu`` in a gloo group; ``cuda`` in an NCCL group, and in the
    dry-run's ``fake`` group, which stands for the cards (DTensor then plans
    its collectives as on them: an all-to-all where a CPU mesh would
    all-gather and chunk)."""
    import torch.distributed as dist

    return "cpu" if dist.get_backend() == "gloo" else "cuda"


def make_mesh(shape, axes, device_type=None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over ranks ``0 ..
    prod(shape) - 1`` of the default process group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("no process group: initialise one before building a mesh")
    n = math.prod(shape)
    if dist.get_world_size() < n:
        raise RuntimeError(
            f"need {n} ranks for a {tuple(shape)} mesh, have {dist.get_world_size()}; "
            "the dry-run runs in a fake process group of 512 ranks"
        )
    return DeviceMesh(device_type or _device_type(), torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_host_mesh(device=None):
    """1x1 ('data', 'model') mesh over the local device: ``cuda:0`` unless
    ``device`` names another (``"cpu"``).  Needs a process group."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    return make_mesh((1, 1), ("data", "model"), dev.type)
