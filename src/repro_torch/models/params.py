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
    into a numpy array (``jax.tree.map(np.asarray, params)``).  Its stacked
    subtrees become lists of modules: ``blocks`` and ``encoder`` carry a
    leading layer axis (one module per layer); ``periods`` (``hybrid``) a
    leading period axis, and within a period ``mamba``, ``moe`` and ``mlp`` a
    second axis, the index within the period (one module per period, each
    holding its ``attn`` and lists of those layers).
    """
    dev = torch.device(device)

    def convert(t, index=()):
        if isinstance(t, dict):
            return {k: convert(v, index) for k, v in t.items()}
        return torch.from_numpy(np.array(t[index])).to(dev)  # a writable copy

    def layers(t, n, index=()):
        return [convert(t, index + (i,)) for i in range(n)]

    def in_period(t):
        """The number of layers in a period's stacked subtree (its first leaf's axis 1)."""
        while isinstance(t, dict):
            t = next(iter(t.values()))
        return t.shape[1]

    depth = {"blocks": cfg.n_layers, "encoder": cfg.n_encoder_layers}
    out = {}
    for name, t in tree.items():
        if name in depth:
            out[name] = layers(t, depth[name])
        elif name == "periods":
            out[name] = [{k: convert(v, (p,)) if k == "attn" else layers(v, in_period(v), (p,))
                          for k, v in t.items()} for p in range(cfg.n_layers // cfg.attn_every)]
        else:
            out[name] = convert(t)
    return Params(out)
