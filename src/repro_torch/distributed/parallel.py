"""The explicit collectives of the port's sharded models (tensor, FSDP and
data parallelism under `sharding.use_mesh(mesh, sharded=True)`).

Every function here names the mesh axis it runs over and calls one of
`core.distributed`'s counted wrappers, so a reader can point at each
collective of a step and `collective_counts()` sees it (its key's last
field is the axis). Each is a `torch.autograd.Function` whose backward
is the transpose collective, written out here:

  gather(x, dim, n, axis)    all-gather of the `split` pieces along dim,
                             trimmed to n; backward: the gradient padded
                             and reduce-scattered (summed) over the axis.
                             The FSDP gather of a weight's "data" shard
                             just before use (tag "fsdp"), and the
                             redistribution of activations over "model"
                             (tag "tp").
  enter(x, axis)             Megatron's f: identity forward, all-reduce
                             of the gradient backward. A replicated
                             activation entering a region whose ranks
                             compute different pieces.
  leave(x, axis)             Megatron's g: all-reduce (sum) forward,
                             identity backward. Partial sums leaving
                             such a region.
  mean_over(x, axes)         all-reduce mean over the batch axes, its
                             backward the same (the MoE's load statistics
                             over the whole batch).

The partitioned message passing of the GNNs (tag "gnn") runs over the
flat axes, a tuple of every mesh axis whose ranks together span the
world (`sharding.flat_axes`). There an activation is either this rank's
`split` piece of a node or edge set or replicated (whole on every rank),
and a replicated value's gradient is each rank's PARTIAL of it (its own
rows' share of the one global loss), summed over the ranks where it
meets a piece:

  gather(x, dim, n, axes)    as above: the whole set from the pieces;
                             backward reduce-scatters the partials.
  scatter_sum(x, dim, axes)  the transpose of gather: each rank's partial
                             of the whole set (n entries) reduce-scattered
                             (summed) to its `split` piece; backward: the
                             gradient all-gathered.
  reduce_sum(x, axes)        each rank's partial summed and replicated
                             (all-reduce); backward the same sum of the
                             gradient's partials.
  segment_extreme(...)       the per-segment maximum (minimum) over every
                             rank's rows: a local scatter_reduce into the
                             whole set, all-reduced with MAX (MIN); its
                             gradient splits among the rows equal to the
                             extreme, ties counted over every rank (an
                             all-reduced count), as the unsharded
                             `scatter_reduce` splits it.

A group of several axes must be every axis of the mesh, in its order (the
world group, whose rank order is the mesh's row-major order, the order of
`sharding.local_shard`'s pieces); the counters name it by its axes joined
with "+" ("data+model").

An axis of size 1 needs no trip: each function is then the identity (the
(1, 1) mesh runs the sharded code with no collective). `all_max` is the
one collective outside autograd (a detached maximum).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core import distributed as cdist
from repro_torch.distributed.sharding import axis_index, axis_size, \
    current_mesh, split
from repro_torch.graph.ops import segment_max, segment_min

__all__ = ["size", "index", "batch_axes_of", "gather", "local_piece",
           "enter", "leave", "mean_over", "all_max", "all_sum", "pad_to",
           "scatter_sum", "reduce_sum", "segment_extreme", "label"]


def _axes(axis) -> tuple:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def label(axis) -> str:
    """The counters' name of an axis or a tuple of axes ("data+model")."""
    return "+".join(_axes(axis))


def size(axis) -> int:
    """Ranks along `axis` (a name, or a tuple of names: their product) of
    the active mesh (1 without one)."""
    mesh = current_mesh()
    n = 1
    for a in _axes(axis):
        n *= 1 if mesh is None else axis_size(mesh, a)
    return n


def index(axis) -> int:
    """This rank's coordinate along `axis` of the active mesh (over a tuple
    of names, row-major in their order)."""
    mesh = current_mesh()
    idx = 0
    for a in _axes(axis):
        idx = idx * (1 if mesh is None else axis_size(mesh, a)) + \
            (0 if mesh is None else axis_index(mesh, a))
    return idx


def batch_axes_of() -> tuple:
    """The active mesh's batch axes, ("pod", "data") where present."""
    mesh = current_mesh()
    names = () if mesh is None else tuple(mesh.mesh_dim_names or ())
    return tuple(a for a in ("pod", "data") if a in names)


def _group(axis):
    """The process group of `axis`: one mesh dimension's, or, for a tuple
    naming every axis of the mesh in its order, the world's (module
    docstring)."""
    mesh = current_mesh()
    names = tuple(mesh.mesh_dim_names or ())
    axes = tuple(a for a in _axes(axis) if a in names)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    if axes != names:
        raise ValueError(f"a group over axes {_axes(axis)} must span the "
                         f"mesh's axes {names} in their order")
    return cdist.flat_rank(mesh)[0]


def pad_to(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """x zero-padded at the end of `dim` to n entries."""
    have = x.shape[dim]
    if have == n:
        return x
    shape = list(x.shape)
    shape[dim] = n - have
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


def _all_gather_dim(x, dim, axis, tag, site):
    out = cdist.all_gather(x.movedim(dim, 0), _group(axis), tag=tag,
                           site=site, dim=label(axis))
    return out.movedim(0, dim)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, n, axis, tag, site):
        ctx.dim, ctx.axis, ctx.tag, ctx.site = dim, axis, tag, site
        ctx.c, ctx.k, ctx.group = x.shape[dim], size(axis), _group(axis)
        return _all_gather_dim(x, dim, axis, tag, site).narrow(dim, 0, n)

    @staticmethod
    def backward(ctx, g):
        full = pad_to(g, ctx.dim, ctx.k * ctx.c).movedim(ctx.dim, 0)
        out = cdist.reduce_scatter(full, ctx.group, tag=ctx.tag,
                                   site=ctx.site + "_grad",
                                   dim=label(ctx.axis))
        return out.movedim(0, ctx.dim), None, None, None, None, None


def gather(x: torch.Tensor, dim: int, n: int, axis, tag: str,
           site: str = "gather") -> torch.Tensor:
    """The whole dimension `dim` (n entries) from every rank's `split`
    piece along `axis` (a name or a tuple of names; x holds this rank's
    piece, padded to the even count); its gradient is reduce-scattered
    back to the pieces."""
    if size(axis) == 1:
        return x.narrow(dim, 0, n)
    return _Gather.apply(x, dim, n, axis, tag, site)


def local_piece(x: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
    """This rank's `split` piece of dimension `dim` of a replicated x along
    `axis`, zero-padded to the even count (no collective: a slice)."""
    k = size(axis)
    if k == 1:
        return x
    lo, hi, c = split(x.shape[dim], k, index(axis))
    return pad_to(x.narrow(dim, lo, hi - lo), dim, c)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, tag):
        ctx.axis, ctx.tag, ctx.group = axis, tag, _group(axis)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        cdist.all_reduce(g, ctx.group, dist.ReduceOp.SUM,
                         tag=ctx.tag, site="enter_grad", dim=ctx.axis)
        return g, None, None


class _Leave(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, tag):
        y = x.contiguous().clone()
        return cdist.all_reduce(y, _group(axis), dist.ReduceOp.SUM,
                                tag=tag, site="leave", dim=axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def enter(x: torch.Tensor, axis: str = "model",
          tag: str = "tp") -> torch.Tensor:
    """Megatron's f over `axis`: x as it is; its gradient all-reduced."""
    if size(axis) == 1:
        return x
    return _Enter.apply(x, axis, tag)


def leave(x: torch.Tensor, axis: str = "model",
          tag: str = "tp") -> torch.Tensor:
    """Megatron's g over `axis`: the sum of x over the axis; its gradient
    as it is."""
    if size(axis) == 1:
        return x
    if not torch.is_grad_enabled() or not x.requires_grad:
        y = x.contiguous().clone()
        return cdist.all_reduce(y, _group(axis), dist.ReduceOp.SUM, tag=tag,
                                site="leave", dim=axis)
    return _Leave.apply(x, axis, tag)


class _MeanOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, tag):
        ctx.groups = [(a, _group(a)) for a in axes if size(a) > 1]
        ctx.tag, ctx.n = tag, _count(axes)
        return _sum_groups(x.contiguous().clone(), ctx.groups, tag,
                           "mean") / ctx.n

    @staticmethod
    def backward(ctx, g):
        return _sum_groups(g.contiguous().clone(), ctx.groups, ctx.tag,
                           "mean_grad") / ctx.n, None, None


def _count(axes) -> int:
    n = 1
    for a in axes:
        n *= size(a)
    return n


def _sum_groups(x, groups, tag, site):
    for a, group in groups:
        cdist.all_reduce(x, group, dist.ReduceOp.SUM, tag=tag, site=site,
                         dim=label(a))
    return x


def mean_over(x: torch.Tensor, axes: tuple, tag: str) -> torch.Tensor:
    """The mean of x over the ranks of `axes`, with autograd (its backward
    the same mean of the gradients)."""
    if _count(axes) == 1:
        return x
    return _MeanOver.apply(x, tuple(axes), tag)


def all_sum(x: torch.Tensor, axes: tuple, tag: str,
            site: str) -> torch.Tensor:
    """x summed in place over each of `axes` in turn (no autograd)."""
    return _sum_groups(x, [(a, _group(a)) for a in axes if size(a) > 1],
                       tag, site)


def all_max(x: torch.Tensor, axis: str, tag: str) -> torch.Tensor:
    """The elementwise maximum of a detached x over `axis` (a new
    tensor)."""
    y = x.detach().contiguous().clone()
    if size(axis) == 1:
        return y
    return cdist.all_reduce(y, _group(axis), dist.ReduceOp.MAX, tag=tag,
                            site="max", dim=axis)


# ------------------------------------------------- partitioned message passing --

class _ScatterSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis, tag, site):
        ctx.dim, ctx.axis, ctx.tag, ctx.site = dim, axis, tag, site
        ctx.n, k = x.shape[dim], size(axis)
        ctx.group = _group(axis)
        full = pad_to(x, dim, k * -(-ctx.n // k)).movedim(dim, 0)
        out = cdist.reduce_scatter(full, ctx.group, tag=tag, site=site,
                                   dim=label(axis))
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        whole = _all_gather_dim(g.contiguous(), ctx.dim, ctx.axis, ctx.tag,
                                ctx.site + "_grad")
        return whole.narrow(ctx.dim, 0, ctx.n), None, None, None, None


def scatter_sum(x: torch.Tensor, dim: int, axis, tag: str,
                site: str = "scatter") -> torch.Tensor:
    """The transpose of `gather`: x holds this rank's partial of the whole
    dimension `dim` (n entries); returns this rank's `split` piece of the
    sum over the ranks of `axis`, zero-padded to the even count
    (a reduce-scatter); its gradient is all-gathered."""
    if size(axis) == 1:
        return x
    return _ScatterSum.apply(x, dim, axis, tag, site)


class _ReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, tag, site):
        ctx.axis, ctx.tag, ctx.site = axis, tag, site
        ctx.group = _group(axis)
        return cdist.all_reduce(x.contiguous().clone(), ctx.group,
                                dist.ReduceOp.SUM, tag=tag, site=site,
                                dim=label(axis))

    @staticmethod
    def backward(ctx, g):
        g = cdist.all_reduce(g.contiguous().clone(), ctx.group,
                             dist.ReduceOp.SUM, tag=ctx.tag,
                             site=ctx.site + "_grad", dim=label(ctx.axis))
        return g, None, None, None


def reduce_sum(x: torch.Tensor, axis, tag: str,
               site: str = "sum") -> torch.Tensor:
    """The sum over the ranks of `axis` of each rank's partial x, on every
    rank (an all-reduce); its gradient's partials are summed the same
    way (module docstring)."""
    if size(axis) == 1:
        return x
    return _ReduceSum.apply(x, axis, tag, site)


class _SegmentExtreme(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seg, valid, n, reduce, axis, sharded_out, tag,
                site):
        k = size(axis)
        n_pad = k * -(-n // k)
        fill = float("-inf") if reduce == "amax" else float("inf")
        op = dist.ReduceOp.MAX if reduce == "amax" else dist.ReduceOp.MIN
        idx = seg.long().reshape((-1,) + (1,) * (x.ndim - 1)).expand_as(x)
        vals = x if valid is None else torch.where(
            valid.reshape((-1,) + (1,) * (x.ndim - 1)), x, fill)
        whole = x.new_full((n_pad,) + tuple(x.shape[1:]), fill)
        whole = whole.scatter_reduce(0, idx, vals, reduce,
                                     include_self=False)
        group = _group(axis)
        cdist.all_reduce(whole, group, op, tag=tag, site=site,
                         dim=label(axis))
        ctx.save_for_backward(x, seg, whole,
                              torch.ones(()) if valid is None else valid)
        ctx.has_valid = valid is not None
        ctx.axis, ctx.tag, ctx.site, ctx.group = axis, tag, site, group
        ctx.sharded_out, ctx.n = sharded_out, n
        if sharded_out:
            lo = index(axis) * (n_pad // k)
            return whole.narrow(0, lo, n_pad // k).clone()
        return whole.narrow(0, 0, n).clone()

    @staticmethod
    def backward(ctx, g):
        x, seg, whole, valid = ctx.saved_tensors
        lab = label(ctx.axis)
        seg = seg.long()
        hit = x == whole.index_select(0, seg)
        if ctx.has_valid:
            hit = hit & valid.reshape((-1,) + (1,) * (x.ndim - 1))
        hit = hit.to(x.dtype)
        ties = torch.zeros_like(whole).index_add_(0, seg, hit)
        cdist.all_reduce(ties, ctx.group, dist.ReduceOp.SUM, tag=ctx.tag,
                         site=ctx.site + "_ties", dim=lab)
        if ctx.sharded_out:
            g_whole = cdist.all_gather(g.contiguous(), ctx.group,
                                       tag=ctx.tag,
                                       site=ctx.site + "_grad", dim=lab)
        else:    # a replicated output: each rank holds a partial
            g_whole = cdist.all_reduce(
                pad_to(g, 0, whole.shape[0]).contiguous().clone(),
                ctx.group, dist.ReduceOp.SUM, tag=ctx.tag,
                site=ctx.site + "_grad", dim=lab)
        share = g_whole / torch.clamp(ties, min=1.0)
        return (share.index_select(0, seg) * hit, None, None, None, None,
                None, None, None, None)


def segment_extreme(x: torch.Tensor, seg: torch.Tensor, n: int,
                    reduce: str, axis, sharded_out: bool, tag: str,
                    valid: torch.Tensor | None = None,
                    site: str = "extreme") -> torch.Tensor:
    """The maximum (reduce "amax") or minimum ("amin") of x's rows by
    segment over every rank of `axis`: x [E, ...] this rank's rows, seg
    their segments (< n), `valid` (None: all) which rows count. Returns
    the whole [n, ...] (`sharded_out` False) or this rank's `split` piece
    of it, padded with the identity (+-inf, an empty segment's value).
    The gradient goes to the rows equal to their segment's extreme, split
    evenly among them, ties counted over every rank. On one rank it is
    `graph.ops`' segment_max / segment_min."""
    if size(axis) == 1:
        fn = segment_max if reduce == "amax" else segment_min
        return fn(x, seg, int(n))
    return _SegmentExtreme.apply(x, seg, valid, int(n), reduce, axis,
                                 bool(sharded_out), tag, site)
