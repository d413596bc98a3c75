"""Weights drawn from the seed on the device, a group at a time, in a few large calls.

A group is the embedding, head and final norm (``"top"``) or one layer
(``0 .. layers - 1``).  Each group's leaves of one dtype are cut from one flat
``torch.randn`` buffer drawn from a generator seeded by the seed and the
group, and transformed in place by their kind.  Drawing a group again on the
same device gives the same bits, so the program's weights and the plain
reference's are the same numbers though the reference never reads the
program's: it draws each layer again once the program's are freed.

Leaves are named by their paths in the program's tree (``("attn", "wq")``),
as the family's ``layout`` under ``reference/`` lists them;
the stated dtype of each is the configuration's ``param_dtype`` but for the
router, which is float32 in every precision.
"""
from __future__ import annotations

import hashlib

import torch

from . import spec

_ALIGN = 256  # elements: every leaf starts 512-byte aligned at least
_F32_LEAVES = ("router",)


def _dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def leaf_dtype(conf: dict, path: tuple) -> torch.dtype:
    return torch.float32 if path[-1] in _F32_LEAVES else _dtype(spec.dims(conf).param_dtype)


def _seed(seed: int, group, dtype: torch.dtype) -> int:
    digest = hashlib.sha256(f"{seed}:{group}:{dtype}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2**63 - 1)


def _shape_leaf(x: torch.Tensor, shape: tuple, kind: str) -> None:
    """Turn standard-normal draws into a leaf of ``kind``, in place."""
    if kind == "linear":
        x.mul_(shape[-2] ** -0.5)
    elif kind == "embed":
        x.mul_(0.02)
    elif kind == "norm":
        x.mul_(0.1).add_(1.0)
    else:
        raise ValueError(kind)


def draw(conf: dict, seed: int, group, device) -> dict[tuple, torch.Tensor]:
    """``{path: weight}`` of ``group``, each in its stated dtype on ``device``."""
    leaves = spec.family(conf["family"]).layout(conf, group)
    out: dict[tuple, torch.Tensor] = {}
    for dtype in sorted({leaf_dtype(conf, p) for p, _, _ in leaves}, key=str):
        mine = [(p, s, k) for p, s, k in leaves if leaf_dtype(conf, p) == dtype]
        sizes = [torch.Size(s).numel() for _, s, _ in mine]
        offsets, total = [], 0
        for n in sizes:
            offsets.append(total)
            total += -(-n // _ALIGN) * _ALIGN
        gen = torch.Generator(device=device).manual_seed(_seed(seed, group, dtype))
        flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
        for (path, shape, kind), off, n in zip(mine, offsets, sizes):
            leaf = flat[off:off + n].view(shape)
            _shape_leaf(leaf, shape, kind)
            out[path] = leaf
    return out


def groups(conf: dict) -> list:
    return ["top", *range(spec.dims(conf).layers)]
