"""Weights of the port's models as ``nn.Module`` trees, and carrying the reference's across.

:class:`Params` holds one nested dict of weights as a module: tensor leaves
become (frozen) parameters under the reference's names, sub-dicts child
``Params``, and lists of dicts an ``nn.ModuleList`` (one module per layer,
where the reference stacks layers on a leading axis for ``lax.scan``).
:func:`params_from_reference` turns the JAX package's parameter pytree,
given as numpy arrays, into that tree, so both packages compute with the
same weights.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch import nn

__all__ = ["Params", "params_from_reference"]


class Params(nn.Module):
    """A nested dict of weights; ``p["wq"]``, ``p.wq`` and ``"shared" in p`` all work."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, val in tree.items():
            if isinstance(val, torch.Tensor):
                self.register_parameter(name, nn.Parameter(val, requires_grad=False))
            elif isinstance(val, dict):
                self.add_module(name, Params(val))
            elif isinstance(val, (list, tuple)):
                self.add_module(name, nn.ModuleList(Params(v) for v in val))
            else:
                raise TypeError(f"{name}: expected a tensor, dict or list, got {type(val)}")

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def tree(self) -> dict:
        """The nested dict of plain tensors this module holds."""
        out: dict = {name: p.data for name, p in self._parameters.items()}
        for name, m in self._modules.items():
            out[name] = [b.tree() for b in m] if isinstance(m, nn.ModuleList) else m.tree()
        return out

    def map(self, fn: Callable[[str, torch.Tensor], torch.Tensor]) -> "Params":
        """A new tree of ``fn(leaf_name, leaf)``; leaves ``fn`` returns as they are are shared."""
        def walk(t):
            if isinstance(t, dict):
                return {k: (fn(k, v) if isinstance(v, torch.Tensor) else walk(v))
                        for k, v in t.items()}
            return [walk(v) for v in t]
        return Params(walk(self.tree()))


def params_from_reference(tree: dict, cfg, device) -> Params:
    """The port's weights from the JAX package's param pytree as numpy arrays.

    ``tree`` is ``repro.models.Model(cfg).init(key)`` with every leaf turned
    into a numpy array (``jax.tree.map(np.asarray, params)``); its ``blocks``
    leaves carry a leading layer axis, which becomes one module per layer.
    The ``dense``, ``moe`` and ``ssm`` families are carried.
    """
    if cfg.family not in ("dense", "moe", "ssm"):
        raise NotImplementedError(f"the {cfg.family} family is not ported to repro_torch yet")
    dev = torch.device(device)

    def leaf(a):
        return torch.from_numpy(np.array(a)).to(dev)  # a writable copy

    def convert(t, layer=None):
        if isinstance(t, dict):
            return {k: convert(v, layer) for k, v in t.items()}
        return leaf(t if layer is None else t[layer])

    out = {k: convert(v) for k, v in tree.items() if k != "blocks"}
    out["blocks"] = [convert(tree["blocks"], i) for i in range(cfg.n_layers)]
    return Params(out)
