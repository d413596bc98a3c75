"""Weights of the port's models as ``nn.Module`` trees, and carrying the reference's across.

:class:`Params` holds one nested dict of weights as a module: tensor leaves
become parameters under the reference's names, sub-dicts child ``Params``,
and lists of dicts an ``nn.ModuleList`` (one module per layer, where the
reference stacks layers on a leading axis for ``lax.scan``).  Serving holds
them frozen; training makes the masters trainable with
``params.requires_grad_()`` (``nn.Module``'s own) and reads products of them
through :meth:`Params.graph_tree`, which keeps them in autograd's graph.
:func:`params_from_reference` turns the JAX package's parameter pytree
(or a tree of the same structure, such as AdamW's moments), given as numpy
arrays, into that tree, so both packages compute with the same weights;
:meth:`Params.stacked_parts` and :meth:`Params.map_stacked` place each
per-layer weight in the reference's stacked layout (the sharding rules' and
a checkpoint's) and back; :meth:`Params.reference_tree` stacks the weights
into that layout.
:func:`tree_map` and :func:`tree_leaves` walk nested dicts, lists and
``Params`` in one fixed order.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch import nn

__all__ = ["Params", "map_named", "params_from_reference", "tree_leaves", "tree_map"]


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
        """The nested dict of plain tensors this module holds (detached aliases
        of the parameters: writing into one writes the weight)."""
        out: dict = {name: p.data for name, p in self._parameters.items()}
        for name, m in self._modules.items():
            out[name] = [b.tree() for b in m] if isinstance(m, nn.ModuleList) else m.tree()
        return out

    def graph_tree(self) -> dict:
        """The nested dict of the parameters themselves: what is computed from
        them stays in autograd's graph, so gradients reach them."""
        out: dict = dict(self._parameters)
        for name, m in self._modules.items():
            out[name] = ([b.graph_tree() for b in m] if isinstance(m, nn.ModuleList)
                         else m.graph_tree())
        return out

    def map(self, fn: Callable[[str, torch.Tensor], torch.Tensor]) -> "Params":
        """A new (frozen) tree of ``fn(leaf_name, leaf)``; leaves ``fn`` returns
        as they are are shared."""
        return Params(map_named(self.tree(), fn))

    def stacked_parts(self):
        """``(path, index, weight)`` for each weight: ``path`` its leaf in the
        reference's stacked layout (each list of modules one subtree whose
        leaves stack its modules' weights), ``index`` its place in that
        leaf's stack dims (one for each list it sits in).  Each leaf's parts
        come in row-major order of ``index``."""
        def walk(mod, path, index):
            for name, p in mod._parameters.items():
                yield path + (name,), index, p
            for name, m in mod._modules.items():
                if isinstance(m, nn.ModuleList):
                    for i, b in enumerate(m):
                        yield from walk(b, path + (name,), index + (i,))
                else:
                    yield from walk(m, path + (name,), index)

        return walk(self, (), ())

    def map_stacked(self, fn: Callable) -> "Params":
        """The inverse of :meth:`stacked_parts`: a ``Params`` of this one's
        structure whose weight at each ``(path, index)`` is ``fn(path, index,
        weight)``, frozen or trainable as this one is."""
        def walk(mod, path, index):
            out = {name: fn(path + (name,), index, p) for name, p in mod._parameters.items()}
            for name, m in mod._modules.items():
                out[name] = ([walk(b, path + (name,), index + (i,)) for i, b in enumerate(m)]
                             if isinstance(m, nn.ModuleList) else walk(m, path + (name,), index))
            return out

        trainable = any(p.requires_grad for p in self.parameters())
        return Params(walk(self, (), ())).requires_grad_(trainable)

    def reference_tree(self) -> dict:
        """This tree in the reference's stacked layout (on the meta device
        this costs nothing)."""
        parts: dict = {}
        for path, index, p in self.stacked_parts():
            parts.setdefault(path, []).append((index, p.data))
        out: dict = {}
        for path, xs in parts.items():
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = (xs[0][1] if not xs[0][0] else
                              torch.stack([x for _, x in xs]).reshape(stack_shape(xs)
                                                                      + xs[0][1].shape))
        return out


def stack_shape(parts) -> tuple:
    """The stack dims of a stacked leaf from its ``(index, weight)`` parts."""
    return tuple(max(ix[d] for ix, _ in parts) + 1 for d in range(len(parts[0][0])))


def map_named(tree, fn: Callable[[str, torch.Tensor], torch.Tensor]):
    """A nested dict/list of ``fn(leaf_name, leaf)`` over a nested dict/list of tensors."""
    if isinstance(tree, dict):
        return {k: (fn(k, v) if isinstance(v, torch.Tensor) else map_named(v, fn))
                for k, v in tree.items()}
    return [map_named(v, fn) for v in tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of trees of its structure.

    Dicts (in sorted key order, as ``jax.tree_util`` walks them, so that two
    trees of the same names walk alike whatever order built them), lists and
    tuples are walked; a :class:`Params` is walked as its :meth:`~Params.tree`
    and comes back as a (frozen) ``Params``; anything else is a leaf."""
    if isinstance(tree, Params):
        rest = [r.tree() if isinstance(r, Params) else r for r in rest]
        return Params(tree_map(fn, tree.tree(), *rest))
    rest = [r.tree() if isinstance(r, Params) else r for r in rest]
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in :func:`tree_map`'s order."""
    if isinstance(tree, Params):
        tree = tree.tree()
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def _from_numpy(a) -> torch.Tensor:
    """A writable tensor copy of a numpy array; bfloat16 (``ml_dtypes``) by its bits."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_reference(tree: dict, cfg, device) -> Params:
    """The port's weights from the JAX package's param pytree as numpy arrays.

    ``tree`` is ``repro.models.Model(cfg).init(key)`` with every leaf turned
    into a numpy array (``jax.tree.map(np.asarray, params)``), or a tree of
    its structure such as AdamW's ``m`` and ``v`` (bfloat16 leaves are
    carried by their bits).  Its stacked
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
        return _from_numpy(t[index]).to(dev)

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
