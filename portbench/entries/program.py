"""What the benchmark takes from the program (``repro_torch``): its config type, its weight tree.

The program's ``ArchConfig`` is built from the configuration file's sizes
(:func:`arch_config`); its weights are the seed's (:mod:`portbench.weights`)
placed in the program's own tree, leaf by leaf against the tree the program
describes on the meta device (:func:`params`), so a leaf the two disagree on
fails set-up.  Only the modules under ``entries/`` import the program.
"""
from __future__ import annotations

import dataclasses

from .. import spec, weights


def arch_config(conf: dict):
    """The program's ``ArchConfig`` of a configuration file: its registered
    arch with the family's fields (``port_fields``) and the file's ``port``
    settings put in; a nested dict of fields goes into that settings object."""
    from repro_torch.configs import get_config

    base = get_config(conf["arch"])
    fields = {**spec.family(conf["family"]).port_fields(conf), **conf.get("port", {})}
    nested = {k: v for k, v in fields.items() if isinstance(v, dict)}
    for k, v in nested.items():
        fields[k] = dataclasses.replace(getattr(base, k), **v)
    return dataclasses.replace(base, **fields)


def _key(path: tuple, index: tuple) -> tuple:
    """A program leaf's ``(group, path)`` in :mod:`portbench.weights`' names."""
    return (index[0], path[1:]) if index else ("top", path)


def params(model, conf: dict, seed: int, device):
    """The program's frozen ``Params`` holding the seed's weights."""
    held: dict = {}

    def leaf(path, index, like):
        group, name = _key(path, index)
        if group not in held:
            _none_left(held)
            held.clear()
            held[group] = weights.draw(conf, seed, group, device)
        w = held[group].pop(name)
        if w.shape != like.shape or w.dtype != like.dtype:
            raise ValueError(f"{path}{list(index)}: drew {tuple(w.shape)} {w.dtype}, "
                             f"the program has {tuple(like.shape)} {like.dtype}")
        return w

    out = model.abstract_params().map_stacked(leaf)
    _none_left(held)
    return out


def _none_left(held: dict) -> None:
    for group, left in held.items():
        if left:
            raise ValueError(f"group {group}: weights the program has no leaf for: {list(left)}")


def leaves(tree) -> dict:
    """``{(group, path): tensor}`` of a ``Params`` (the weights, or a tree
    of their structure such as AdamW's moments)."""
    return {_key(path, index): t.data for path, index, t in tree.stacked_parts()}
