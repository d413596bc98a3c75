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

import functools

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor

from ..runtime.axes import get_activation_sharding, resolve, to_placements

__all__ = ["all_reduce", "is_dtensor", "local_index", "place", "placements", "replicated_like",
           "shard_map", "col", "col_linear", "full", "grad_layout", "model_ways",
           "reduce_rows", "row", "row_linear", "rows_move", "slab_sum", "split_parts", "splits",
           "splits_any", "to_layout_of", "weight_layout", "whole", "zeros"]


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


def all_reduce(t: torch.Tensor, dims, mesh=None) -> torch.Tensor:
    """The plain local tensor ``t`` summed over the mesh dims ``dims`` (of
    ``mesh``, by default the profile's), inside a :func:`shard_map` body.
    Not differentiable (:func:`slab_sum` is)."""
    import torch.distributed._functional_collectives as funcol

    mesh = mesh if mesh is not None else get_activation_sharding().mesh
    for d in dims:
        t = funcol.wait_tensor(funcol.all_reduce(t.contiguous(), "sum", (mesh, d)))
    return t


class _SlabSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dims, mesh):
        ctx.dims, ctx.mesh = dims, mesh
        return all_reduce(t, dims, mesh)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.dims, ctx.mesh), None, None


def slab_sum(t: torch.Tensor, dims, mesh=None) -> torch.Tensor:
    """:func:`all_reduce`, differentiable: the ranks' partial ``t`` summed
    over the mesh dims ``dims``, in the forward pass and in the backward
    pass alike.

    Each rank of ``dims`` reads its own part of the sum (the MoE combine
    reads its own tokens' rows), so each gradient is only that rank's
    part, and the gradient of each rank's term is their sum.  A
    :func:`shard_map` input replicated over ``dims`` (the tokens, where
    each rank of ``dims`` holds a slice of the weights) gets this rank's
    share of its gradient, which the map sums over ``dims`` on the way out
    (``_SumGrad``); an input split over ``dims`` (the router weights of
    this rank's tokens) gets its whole gradient here.  Were every rank to
    read the whole sum, each would hold the whole gradient and this sum
    would count it once for each rank."""
    return _SlabSum.apply(t, tuple(dims), mesh)


class _SumGrad(torch.autograd.Function):
    """Identity; the gradient is summed over the mesh dims ``dims``."""

    @staticmethod
    def forward(ctx, x, mesh, dims):
        ctx.mesh, ctx.dims = mesh, dims
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.dims, ctx.mesh), None, None


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
    """A ``(d_in, d_out)`` weight gathered for a column-parallel product:
    ``d_out`` over 'model' where it divides, whole over the other axes.
    This is the train rules' FSDP gather, and the weight gather that
    :func:`col_linear` falls back to where a weight is the smaller thing to
    move (prefill).  A plain ``w`` as it is."""
    return _weight(w, None, "model")


def row(w):
    """A ``(d_in, d_out)`` weight laid out for a row-parallel product:
    ``d_in`` over 'model', whole over the other axes."""
    return _weight(w, "model", None)


def _shards(p, dim: int) -> bool:
    return isinstance(p, Shard) and p.dim == dim


def _nbytes_local(t) -> int:
    return t.to_local().numel() * t.element_size()


def _ways(mesh, dims) -> int:
    n = 1
    for d in dims:
        n *= mesh.size(d)
    return n


def weight_layout(x, w, x_dim: int, w_dim: int) -> list:
    """Placements of the DTensor ``x`` with its dim ``x_dim`` laid out as
    the DTensor ``w`` lays out its dim ``w_dim`` (the same mesh dims, so the
    same chunks), its dim 0 (rows: batch or tokens) still split over the
    other mesh dims that split it, and nothing else split.  A mesh dim that
    splits ``w``'s other dims replicates ``x``."""
    out = []
    for px, pw in zip(x.placements, w.placements):
        if _shards(pw, w_dim):
            out.append(Shard(x_dim % x.dim()))
        elif isinstance(pw, Shard) or not _shards(px, 0):
            out.append(Replicate())
        else:
            out.append(Shard(0))
    return out


def to_layout_of(x, w, x_dim: int, w_dim: int = 0):
    """The DTensor ``x`` redistributed to :func:`weight_layout` (its dim
    ``x_dim`` split as ``w``'s dim ``w_dim``), so that an elementwise op
    with ``w`` leaves ``w`` where it is (DTensor's own choice of which
    operand to move differs between PyTorch versions).  Plain: ``x``."""
    if not (is_dtensor(x) and is_dtensor(w)):
        return x
    return x.redistribute(x.device_mesh, weight_layout(x, w, x_dim, w_dim))


def rows_move(x, w, w_dim: int, x_dim: int = -1):
    """Where the activation should go to the weight: the placements to
    give ``x`` so that a product (or an elementwise op) with ``w`` runs on
    ``w``'s own shards (:func:`weight_layout`), or None where gathering
    ``w`` instead moves fewer bytes.

    Gathering ``w`` means making it whole over every mesh dim of more than
    one rank that splits it but 'model' (as :func:`col` and :func:`row` do;
    under the serve rules' wide ``('model', 'data')`` weights, 'data',
    which the activation's rows also use).  Moving ``x`` means
    redistributing it from its placements to the weight layout (a slice of
    a replicated dim moves nothing).  The choice is by bytes, from shapes
    alone: each side's local bytes times the ranks it would be gathered
    from, less its own shard.  At decode a few
    rows are far fewer bytes than a weight shard, so the weight stays where
    the rules put it; at prefill the rows are the larger, so the weight is
    gathered.  Plain tensors, a 1x1 mesh, or a weight split over nothing
    but 'model': None."""
    if not (is_dtensor(x) and is_dtensor(w)) or any(isinstance(p, Partial) for p in x.placements):
        return None
    mesh = w.device_mesh
    names = mesh.mesh_dim_names
    w_gather = [d for d, p in enumerate(w.placements)
                if isinstance(p, Shard) and mesh.size(d) > 1 and names[d] != "model"]
    if not w_gather:
        return None
    target = weight_layout(x, w, x_dim, w_dim)
    x_moved = [d for d, (p, t) in enumerate(zip(x.placements, target))
               if p != t and not isinstance(p, Replicate) and mesh.size(d) > 1]
    x_cost = _nbytes_local(x) * (_ways(mesh, x_moved) - 1)
    w_cost = _nbytes_local(w) * (_ways(mesh, w_gather) - 1)
    return target if x_cost < w_cost else None


def _product_out(x_pl, w, ndim: int) -> list:
    """Placements of ``x @ w`` computed on the local shards of ``x`` laid
    out as ``x_pl`` and ``w`` as it is: a partial sum where ``w`` splits the
    contraction, ``w``'s output split, ``x``'s rows."""
    out = []
    for px, pw in zip(x_pl, w.placements):
        if _shards(pw, 0):
            out.append(Partial())
        elif _shards(pw, 1):
            out.append(Shard(ndim - 1))
        else:
            out.append(px)
    return out


def col_linear(x, ws, dot):
    """``dot(x, w)`` for a ``(d_in, d_out)`` weight ``w`` (or for each of a
    tuple of weights laid out alike, with ``x`` moved once), the
    column-parallel product, ``dot`` the local product
    (:func:`~repro_torch.models.layers.linear` or ``dot_f32``).

    Where :func:`rows_move` says so (decode under the serve rules), the
    weight stays on its shards: ``x`` is gathered over the mesh axes that
    split ``d_out`` (its rows over 'data'), each rank takes the product with
    its own shard, and the output's ``d_out`` stays split as the weight's
    is (over ``('model', 'data')``).  Otherwise the weight is gathered
    (:func:`col`).  Plain tensors: ``dot(x, w)``."""
    many = isinstance(ws, tuple)
    ws = ws if many else (ws,)
    w = ws[0]
    x_pl = None
    if is_dtensor(w) and not splits_any(w, 0):
        x_pl = rows_move(x, w, 0, x.dim() - 1) if is_dtensor(x) else None
    if x_pl is None:
        outs = tuple(dot(x, col(wi)) for wi in ws)
    else:
        x = x.redistribute(x.device_mesh, x_pl)
        outs = tuple(shard_map(dot, (x, wi), (x_pl, list(wi.placements)),
                               _product_out(x_pl, wi, x.dim())) for wi in ws)
    return outs if many else outs[0]


def model_ways(x) -> int:
    """Ranks of the profile's 'model' axis when ``x`` is a DTensor, else 1."""
    prof = get_activation_sharding()
    if prof is None or not is_dtensor(x):
        return 1
    return prof.axis_size(prof.logical.get("model", ()))


@functools.lru_cache(maxsize=256)
def _parts_plan(widths: tuple, n: int, r: int, device: str):
    """Rank ``r``'s all-to-all over ``n`` ranks from even column shards of
    the concatenated parts ``widths`` to each part's own even shards: the
    local columns to send, in destination order (``idx``), the send and
    receive counts, and where each received column goes (``perm``)."""
    c = sum(widths) // n
    offs = np.cumsum((0,) + widths[:-1])

    def need(j):  # the global columns rank j's parts hold, in part order
        return np.concatenate([np.arange(o + j * w // n, o + (j + 1) * w // n)
                               for o, w in zip(offs, widths)])

    sends = [need(j) for j in range(n)]
    sends = [s[(s >= r * c) & (s < (r + 1) * c)] - r * c for s in sends]
    src = need(r) // c
    perm = np.empty(len(src), dtype=np.int64)
    perm[np.argsort(src, kind="stable")] = np.arange(len(src))
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return (as_t(np.concatenate(sends)), [len(s) for s in sends],
            np.bincount(src, minlength=n).tolist(), as_t(perm))


def split_parts(t, widths):
    """The DTensor ``t`` cut along its last dim into parts of ``widths``,
    each laid out over 'model' on its own width (split where the width
    divides the axis, else whole), its other dims as ``t`` has them.

    ``t`` with its last dim split over 'model' (a column-parallel product's
    output) and every part dividing the axis: one all-to-all over 'model'
    moves each of this rank's columns to the rank whose part holds it,
    where slicing the DTensor at columns off its shard edges would
    all-gather all of ``t``; the backward pass is the inverse all-to-all.
    Otherwise ``t`` is made whole over 'model' and each part sliced."""
    mesh = t.device_mesh
    names = mesh.mesh_dim_names
    prof = get_activation_sharding()
    m = names.index(next(a for a in prof.logical.get("model", ()) if a in names))
    n, last = mesh.size(m), t.dim() - 1
    keep = [Replicate() if _shards(p, last) and d != m else p for d, p in enumerate(t.placements)]
    part_pls = [keep[:m] + [Shard(last) if w % n == 0 else Replicate()] + keep[m + 1:]
                for w in widths]
    if not (_shards(t.placements[m], last) and all(w % n == 0 for w in widths)):
        keep[m] = Replicate()
        t = t.redistribute(mesh, keep)
        offs = np.cumsum((0,) + tuple(widths[:-1]))
        return tuple(t[..., o:o + w].redistribute(mesh, pl)
                     for o, w, pl in zip(offs, widths, part_pls))
    import torch.distributed._functional_collectives as funcol

    def local(a):
        idx, sends, recvs, perm = _parts_plan(tuple(widths), n, mesh.get_local_rank(m),
                                              str(a.device))
        buf = a.movedim(-1, 0).index_select(0, idx)
        buf = funcol.all_to_all_single_autograd(buf, recvs, sends, (mesh, m))
        return buf.index_select(0, perm).movedim(0, -1).split([w // n for w in widths], dim=-1)

    return shard_map(local, (t,), (keep,), tuple(part_pls))


def row_linear(h, w, dot):
    """``dot(h, w)`` for an ``(d_in, d_out)`` weight ``w``, the row-parallel
    product, ``dot`` the local product.

    Where :func:`rows_move` says so, the weight stays on its shards: ``h``
    is laid out as ``w``'s ``d_in`` (over ``('model', 'data')`` under the
    serve rules: nothing moves when ``h`` comes from :func:`col_linear`),
    each rank takes its partial product, and the partial sums are reduced
    to the rows-over-'data' layout (a reduce-scatter onto the rows, then an
    all-reduce over the rest: the all-reduce of activations).  Otherwise the
    weight is gathered (:func:`row`).  Plain tensors: ``dot(h, w)``."""
    h_pl = None
    if is_dtensor(w) and is_dtensor(h) and not splits_any(w, 1):
        h_pl = rows_move(h, w, 0)
    if h_pl is None:
        return dot(h, row(w))
    out = shard_map(dot, (h, w), (h_pl, list(w.placements)), _product_out(h_pl, w, h.dim()))
    return reduce_rows(out)


def reduce_rows(y):
    """The DTensor ``y`` (partial sums, rows whole or split) in the
    rows-over-the-batch-axes layout, everything else whole: partial sums
    are first reduce-scattered onto the rows, then all-reduced."""
    mesh = y.device_mesh
    final = placements(y.shape, ("batch",) + (None,) * (y.dim() - 1))
    mid = [f if isinstance(p, (Partial, Replicate)) and isinstance(f, Shard) else p
           for p, f in zip(y.placements, final)]
    return y.redistribute(mesh, mid).redistribute(mesh, final)


def splits_any(t, dim: int) -> bool:
    """Whether the DTensor ``t`` splits its dim ``dim`` over a mesh dim of
    more than one rank."""
    mesh = t.device_mesh
    return any(_shards(p, dim) and mesh.size(d) > 1 for d, p in enumerate(t.placements))


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
