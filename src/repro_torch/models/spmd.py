"""The model's pieces that run on local shards when its tensors are DTensors.

With an :class:`~repro_torch.runtime.axes.ActivationSharding` profile
installed and the weights placed by :func:`~repro_torch.runtime.sharding.distribute_params`,
the model's activations are DTensors and most of its ops (products, norms,
elementwise ops, reshapes) run through DTensor's sharding propagation.  The
ops that have no DTensor sharding strategy, or that must see which shard
they hold (the attention kernels and their RoPE tables, the MoE dispatch's
sort and scatter, writes into a sequence-sharded cache), run through
:func:`shard_map`, the counterpart of the reference's ``shard_map``
(``torch.distributed.tensor.experimental.local_map``), on plain local
tensors; a kernel is never handed a DTensor.

Without a profile, or given plain tensors, :func:`shard_map` calls the
function on the tensors as they are: the single-device path is unchanged.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor

from ..runtime.axes import get_activation_sharding, resolve, to_placements

__all__ = ["is_dtensor", "local_index", "place", "placements", "replicated_like", "shard_map",
           "col", "full", "grad_layout", "row", "splits", "whole", "zeros"]


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def placements(shape, logical, partial=(), reduce: str = "sum") -> list:
    """Placements on the active profile's mesh of a tensor of ``shape`` laid
    out by the logical spec ``logical`` (resolved as :func:`hint` resolves
    it), with ``Partial`` reductions (``reduce``) over the mesh axes named in
    ``partial``."""
    prof = get_activation_sharding()
    pls = to_placements(resolve(prof, shape, logical), prof.mesh)
    names = prof.mesh.mesh_dim_names
    for axis in partial:
        if axis in names:
            pls[names.index(axis)] = Partial(reduce)
    return pls


def splits(shape, logical, dim: int) -> bool:
    """Whether tensor dim ``dim`` of a ``shape`` tensor laid out by
    ``logical`` is split across more than one rank (a shard over a mesh axis
    of size 1 is the whole dim)."""
    prof = get_activation_sharding()
    ways = 1
    for size, pl in zip(prof.mesh.shape, placements(shape, logical)):
        if isinstance(pl, Shard) and pl.dim == dim:
            ways *= size
    return ways > 1


def place(x, *logical):
    """``x`` as a DTensor on the profile's mesh laid out by ``logical``: a
    plain tensor (the same on every rank) is split, a DTensor redistributed.
    Without a profile, ``x`` as it is."""
    prof = get_activation_sharding()
    if prof is None or x is None:
        return x
    pls = placements(x.shape, logical)
    if isinstance(x, DTensor):
        return x.redistribute(prof.mesh, pls)
    return distribute_tensor(x, prof.mesh, pls)


class _SumGrad(torch.autograd.Function):
    """Identity; the gradient is summed over the mesh dims ``dims``."""

    @staticmethod
    def forward(ctx, x, mesh, dims):
        ctx.mesh, ctx.dims = mesh, dims
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed._functional_collectives as funcol

        for d in ctx.dims:
            g = funcol.wait_tensor(funcol.all_reduce(g.contiguous(), "sum", (ctx.mesh, d)))
        return g, None, None


class _GradLayout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pls):
        ctx.pls = pls
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.pls), None


def grad_layout(x, *logical):
    """``x`` itself, whose gradient is redistributed to the layout
    ``logical`` on the way back (DTensor may sum a gradient's parts into a
    layout that splits the token dim over 'model', unevenly, and a view of
    it back to ``(B, S, D)`` then fails).  A plain ``x`` as it is."""
    if not is_dtensor(x):
        return x
    return _GradLayout.apply(x, placements(x.shape, logical))


def _weight(w, *logical):
    if not is_dtensor(w):
        return w
    return w.redistribute(w.device_mesh, placements(w.shape, logical))


def col(w):
    """A ``(d_in, d_out)`` weight laid out for a column-parallel product:
    ``d_out`` over 'model' where it divides, whole over the other axes (the
    FSDP gather, made where the weight is used, in decode too: under the
    serve rules' wide ``('model', 'data')`` weights, every decode step
    gathers them over 'data', the collective bytes the dry-run counts in its
    decode cells).  A plain ``w`` as it is."""
    return _weight(w, None, "model")


def row(w):
    """A ``(d_in, d_out)`` weight laid out for a row-parallel product:
    ``d_in`` over 'model', whole over the other axes."""
    return _weight(w, "model", None)


def whole(w):
    """A weight whole on every rank (a router's, a gate's)."""
    return _weight(w, *(None,) * w.dim())


def full(x):
    """The whole tensor: a DTensor gathered to every rank, a plain tensor as it is."""
    return x.full_tensor() if is_dtensor(x) else x


def replicated_like(x, t: torch.Tensor) -> torch.Tensor:
    """The plain tensor ``t`` (the same on every rank) as a replicated DTensor
    on ``x``'s mesh when ``x`` is a DTensor, else ``t``: a constant mixed
    into DTensor arithmetic."""
    if not is_dtensor(x):
        return t
    mesh = x.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def _contiguous_strides(shape) -> tuple:
    strides, n = [], 1
    for d in reversed(shape):
        strides.append(n)
        n *= d
    return tuple(reversed(strides))


def zeros(shape, dtype, device, logical):
    """A zero DTensor of ``shape`` on the profile's mesh laid out by
    ``logical``, each rank allocating only its shard on ``device``."""
    prof = get_activation_sharding()
    pls = placements(shape, logical)
    local = list(shape)
    for size, pl in zip(prof.mesh.shape, pls):
        if isinstance(pl, Shard):
            local[pl.dim] //= size
    return DTensor.from_local(torch.zeros(local, dtype=dtype, device=device), prof.mesh, pls,
                              run_check=False, shape=torch.Size(shape),
                              stride=_contiguous_strides(shape))


def local_index(axis: str, sharded: bool) -> int:
    """This rank's coordinate on mesh axis ``axis`` of the profile's mesh (0
    when the dim in question is not sharded over it)."""
    prof = get_activation_sharding()
    if not sharded or prof is None or axis not in prof.mesh.mesh_dim_names:
        return 0
    return prof.mesh.get_local_rank(axis)


def shard_map(fn, args, in_placements, out_placements):
    """``fn(*args)`` on each rank's local shards when an arg is a DTensor:
    inputs redistributed to ``in_placements`` (None for a non-tensor or
    plain argument), outputs wrapped as DTensors of ``out_placements``.
    Otherwise ``fn(*args)`` as it is.

    Gradients: on a mesh axis that splits the work (some input is sharded
    over it), a rank's gradient of an input replicated over that axis is
    only its share, so the map sums it over that axis (an all-reduce in the
    backward pass) before it leaves.  An output that is a ``Partial`` sum
    leaves the map stacked on a new leading dim sharded over those axes and
    is summed over it outside, so its gradient reaches each rank whole.
    Neither gradient leaves as a ``Partial`` DTensor, whose handling
    differs between PyTorch versions."""
    if not any(is_dtensor(a) for a in args):
        return fn(*args)
    from torch.distributed.tensor.experimental import local_map

    prof = get_activation_sharding()
    split = [d for d in range(prof.mesh.ndim)
             if any(pl is not None and isinstance(pl[d], Shard) for pl in in_placements)]
    summed_in = [[d for d in split if isinstance(pl[d], Replicate)] if pl is not None else []
                 for pl in in_placements]
    many = isinstance(out_placements, tuple)
    outs = list(out_placements) if many else [out_placements]
    summed = [any(isinstance(p, Partial) and p.reduce_op == "sum" for p in pl) for pl in outs]
    stacked = [[Shard(0) if isinstance(p, Partial) and p.reduce_op == "sum"
                else Shard(p.dim + 1) if isinstance(p, Shard) else p for p in pl]
               if sm else pl for pl, sm in zip(outs, summed)]

    def body(*local):
        local = [_SumGrad.apply(t, prof.mesh, dims) if dims and t.requires_grad else t
                 for t, dims in zip(local, summed_in)]
        res = fn(*local)
        res = list(res) if many else [res]
        res = [r.unsqueeze(0) if sm else r for r, sm in zip(res, summed)]
        return tuple(res) if many else res[0]

    res = local_map(body, out_placements=tuple(stacked) if many else stacked[0],
                    in_placements=tuple(in_placements), device_mesh=prof.mesh,
                    redistribute_inputs=True)(*args)
    res = list(res) if many else [res]
    res = [r.sum(0) if sm else r for r, sm in zip(res, summed)]
    return tuple(res) if many else res[0]
