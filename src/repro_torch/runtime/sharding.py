"""GSPMD sharding rules for every architecture family (port of ``repro.runtime.sharding``).

Axis semantics:
  'pod'   — pure data parallelism across pods (params replicated over pods;
            exactly one gradient all-reduce per step crosses the slow
            inter-pod links);
  'data'  — within-pod data parallelism; in train mode also FSDP/ZeRO-3
            (params, grads, and Adam moments sharded over 'data');
  'model' — tensor parallelism: attention heads, FFN hidden, experts,
            vocab, Mamba inner dim.

Two modes:

  * ``train``: batch over ('pod','data'); weights ('data' x 'model')
    FSDP+TP.  EXCEPTION — MoE *expert* weights are compute-stationary
    (E over 'model', ffn dim over 'data' when the E-slice is large).
  * ``serve``: no optimizer state, latency path.  Weights are wide-TP over
    ('model','data'); attention stays heads-over-'model'; KV caches shard
    batch over 'data' and sequence over 'model'.

Every rule is divisibility-guarded: a dim is sharded over an axis (or a
prefix of a compound axis) only if evenly divisible, else replicated.
Stacked layer axes (the reference's scan leading dims) are never sharded.

A spec is a plain tuple with one entry per tensor dim: ``None``, a mesh axis
name or a tuple of names — the reference's ``PartitionSpec`` read as a
tuple.  :func:`param_specs` walks the reference's stacked layout
(:meth:`~repro_torch.models.params.Params.reference_tree`), so its specs
equal the reference's key for key; :func:`distribute_params` places the
port's per-layer ``Params`` by dropping each layer's stack dims.

Chunk order: a dim sharded over two mesh axes is chunked by DTensor in
mesh-dim order.  Serve's wide ``("model", "data")`` lists the axes
model-major, as JAX chunks them; on a ``("data", "model")`` mesh DTensor
chunks that dim data-major.  Each device holds the same number of bytes
either way, only a different chunk, and DTensor computes with its own
layout, so the results agree (the 2x2 mesh test serves through it).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Optional

from .axes import mesh_axes, to_placements

__all__ = [
    "ShardingRules",
    "make_sharding_rules",
    "param_specs",
    "batch_specs",
    "cache_spec_tree",
    "distribute_params",
    "named",
    "param_shardings",
    "tree_named",
]


def _axis_size(mesh, name) -> int:
    if name is None:
        return 1
    if isinstance(name, (tuple, list)):
        return math.prod(_axis_size(mesh, n) for n in name)
    return mesh_axes(mesh).get(name, 1)


def _guard(mesh, dim_size: int, name):
    """Shard dim over ``name`` only if evenly divisible (else a divisible
    prefix of a compound axis, else replicate)."""
    if name is None:
        return None
    if dim_size % _axis_size(mesh, name) == 0:
        return name if not (isinstance(name, (tuple, list)) and len(name) == 1) else name[0]
    if isinstance(name, (tuple, list)):
        for cut in range(len(name) - 1, 0, -1):
            sub = tuple(name[:cut])
            if dim_size % _axis_size(mesh, sub) == 0:
                return sub if len(sub) > 1 else sub[0]
    return None


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    mesh: Any                    # a DeviceMesh (or a spec-only stand-in)
    mode: str                    # 'train' | 'serve'
    dp: Any                      # batch axis name(s)
    tp: str = "model"            # attention/tensor axis
    fsdp: Optional[Any] = None   # train: ('data',)
    wide: Optional[Any] = None   # serve: ('model', 'data')
    expert_f: Optional[str] = "data"  # stationary-expert ffn-dim axis


def make_sharding_rules(mesh, mode: str = "train") -> ShardingRules:
    has_pod = "pod" in mesh_axes(mesh)
    if mode == "train":
        return ShardingRules(
            mesh=mesh, mode=mode,
            dp=("pod", "data") if has_pod else ("data",),
            fsdp=("data",),
        )
    if mode == "serve":
        return ShardingRules(
            mesh=mesh, mode=mode,
            dp=("pod", "data") if has_pod else ("data",),
            wide=("model", "data"),
        )
    raise ValueError(mode)


def named(rules: ShardingRules, spec: tuple) -> list:
    """DTensor placements of ``spec`` on the rules' mesh (the reference's
    ``NamedSharding``)."""
    return to_placements(spec, rules.mesh)


def _map_specs(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_named(rules: ShardingRules, spec_tree: Any) -> Any:
    return _map_specs(lambda s: named(rules, s), spec_tree)


# ---------------------------------------------------------------------------
# Parameter specs (path-pattern matched over the reference layout)
# ---------------------------------------------------------------------------


def _n_stack_dims(path: tuple[str, ...]) -> int:
    """Leading scan-stack dims to leave unsharded, from the param path."""
    if not path:
        return 0
    head = path[0]
    if head in ("blocks", "encoder"):
        return 1
    if head == "periods":
        return 1 if len(path) > 1 and path[1] == "attn" else 2
    return 0


def _base_spec(
    path: tuple[str, ...],
    shape: tuple[int, ...],
    rules: ShardingRules,
    leaf_bytes: float = 0.0,
):
    """Spec entries for the trailing (non-stacked) dims of a leaf.

    ``leaf_bytes`` — total bytes of the WHOLE leaf (stack dims included),
    used for the size-conditional expert ffn-dim sharding.
    """
    mesh = rules.mesh
    name = path[-1]
    tp = rules.tp
    g = lambda size, ax: _guard(mesh, size, ax)
    in_moe = "moe" in path
    in_shared = "shared" in path
    in_mamba = "mamba" in path
    # The "second" weight axis: FSDP shards it in train, wide-TP in serve.
    col = rules.wide if rules.wide is not None else rules.fsdp
    row = rules.fsdp  # row sharding only in train (serve keeps rows whole)

    # --- MoE expert weights: compute-stationary, never gathered ----------
    # The ffn dim additionally shards over 'data' only when the E-sharded
    # per-chip slice is still large (>1 GB/leaf).
    if in_moe and not in_shared and len(shape) == 3 and name in ("w_gate", "w_up", "w_down"):
        e_ax = g(shape[0], tp)
        e_ways = _axis_size(mesh, e_ax) if e_ax else 1
        big = (leaf_bytes / e_ways) > 1e9
        f_ax = rules.expert_f if big else None
        if name == "w_down":
            return (e_ax, g(shape[1], f_ax), None)  # (E, F, D)
        return (e_ax, None, g(shape[2], f_ax))      # (E, D, F)

    if name == "embed":
        return (g(shape[0], tp), g(shape[1], row))
    if name == "lm_head":
        return (g(shape[0], row), g(shape[1], col if rules.wide else tp))
    if name in ("wq", "wk", "wv", "wkv_b"):  # wkv_b: MLA's latent to its heads' k and v
        return (g(shape[0], row), g(shape[1], tp))
    if name == "wo":
        return (g(shape[0], tp), g(shape[1], row))
    if name in ("router", "wkv_a"):  # wkv_a: MLA's x to its latent and shared k_rope
        return (g(shape[0], row), None)
    if name in ("w_gate", "w_up"):  # dense MLP / shared experts (D, F)
        return (g(shape[0], row), g(shape[1], col if rules.wide else tp))
    if name == "w_down":            # (F, D)
        return (g(shape[0], col if rules.wide else tp), g(shape[1], row))
    if name == "gate":              # shared-expert sigmoid gate (D, 1)
        return (g(shape[0], row), None)
    if in_mamba:
        wide_or_tp = col if rules.wide else tp
        if name == "in_proj":
            return (g(shape[0], row), g(shape[1], wide_or_tp))
        if name == "out_proj":
            return (g(shape[0], wide_or_tp), g(shape[1], row))
        if name == "conv_w":
            return (None, g(shape[1], wide_or_tp))
        if name in ("conv_b", "norm_w"):
            return (g(shape[0], wide_or_tp),)
        if name in ("dt_bias", "A_log", "D"):
            return (g(shape[0], tp),)
    # norms / q_norm / k_norm / kv_norm / final norms, the router's correction
    # bias: replicated.
    return tuple(None for _ in shape)


def param_specs(abstract_params: Any, rules: ShardingRules) -> dict:
    """Spec tree matching the parameter tree in the reference's stacked
    layout.  ``abstract_params`` is a ``Params`` (walked through its
    :meth:`~repro_torch.models.params.Params.reference_tree`; a tree on the
    meta device costs nothing) or a nested dict already in that layout,
    whose leaves have ``shape`` and ``dtype``."""
    tree = abstract_params
    if hasattr(tree, "reference_tree"):
        tree = tree.reference_tree()

    def one(names, leaf):
        n_stack = _n_stack_dims(names)
        shape = tuple(leaf.shape)
        nbytes = float(math.prod(shape)) * leaf.dtype.itemsize
        return (None,) * n_stack + tuple(_base_spec(names, shape[n_stack:], rules, nbytes))

    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, path + (k,)) for k, v in t.items()}
        return one(path, t)

    return walk(tree, ())


def distribute_params(params, specs: dict, mesh):
    """The port's per-layer ``Params`` as DTensors on ``mesh``, each leaf
    placed by its stacked spec with the stack dims (one for each list of
    layers it sits in) dropped; trainable where ``params`` is."""
    from torch.distributed.tensor import distribute_tensor

    def place(path, index, p):
        spec = functools.reduce(lambda t, k: t[k], path, specs)
        return distribute_tensor(p.detach(), mesh, to_placements(spec[len(index):], mesh))

    return params.map_stacked(place)


def param_shardings(specs: dict, mesh) -> dict:
    """The ``shardings`` of :func:`repro_torch.ckpt.restore_pytree` for a
    ``Params`` placed by ``specs`` (:func:`param_specs`) on ``mesh``: the
    stacked layout with a ``(mesh, placements)`` pair of one layer's tensor
    at each leaf (its stack dims dropped, as :func:`distribute_params`
    drops them)."""
    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, path + (k,)) for k, v in t.items()}
        return (mesh, to_placements(t[_n_stack_dims(path):], mesh))

    return walk(specs, ())


# ---------------------------------------------------------------------------
# Batch / cache specs
# ---------------------------------------------------------------------------


def batch_specs(batch_shapes: dict, rules: ShardingRules) -> dict:
    """Specs for an input batch dict (tokens/labels/embeds/positions...)."""
    mesh = rules.mesh
    dp = rules.dp
    out = {}
    for k, v in batch_shapes.items():
        shape = v.shape if hasattr(v, "shape") else v
        if k == "positions3":  # (3, B, S)
            out[k] = (None, _guard(mesh, shape[1], dp), None)
        elif len(shape) >= 1:
            rest = (None,) * (len(shape) - 1)
            out[k] = (_guard(mesh, shape[0], dp), *rest)
        else:
            out[k] = ()
    return out


def cache_spec_tree(cache_shapes: dict, rules: ShardingRules) -> dict:
    """Specs for the decode cache.

    KV caches (..., B, T, Hkv, Dh): batch over 'data', sequence over
    'model'.  SSM states (..., B, H, P, N): batch over 'data', heads over
    'model'.  Conv states: channels over 'model'.
    """
    mesh = rules.mesh
    dp, tp = rules.dp, rules.tp
    cache_b = dp  # batch rows of the cache spread over the dp axes
    out = {}
    for k, v in cache_shapes.items():
        shape = v.shape if hasattr(v, "shape") else v
        nd = len(shape)
        if k in ("k", "v", "cross_k", "cross_v"):
            lead = nd - 4  # stack dims before (B, T, Hkv, Dh)
            b, t = shape[lead], shape[lead + 1]
            spec = (None,) * lead + (_guard(mesh, b, cache_b), _guard(mesh, t, tp), None, None)
        elif k == "ssm":
            lead = nd - 4  # (B, H, P, N)
            b, h = shape[lead], shape[lead + 1]
            spec = (None,) * lead + (_guard(mesh, b, cache_b), _guard(mesh, h, tp), None, None)
        elif k == "conv":
            lead = nd - 3  # (B, W-1, C)
            b, c = shape[lead], shape[lead + 2]
            spec = (None,) * lead + (_guard(mesh, b, cache_b), None, _guard(mesh, c, tp))
        else:
            spec = (None,) * nd
        out[k] = spec
    return out
