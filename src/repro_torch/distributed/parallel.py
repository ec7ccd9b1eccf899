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

__all__ = ["size", "index", "batch_axes_of", "gather", "local_piece",
           "enter", "leave", "mean_over", "all_max", "all_sum", "pad_to"]


def size(axis: str) -> int:
    """Ranks along `axis` of the active mesh (1 without one)."""
    mesh = current_mesh()
    return 1 if mesh is None else axis_size(mesh, axis)


def index(axis: str) -> int:
    """This rank's coordinate along `axis` of the active mesh."""
    mesh = current_mesh()
    return 0 if mesh is None else axis_index(mesh, axis)


def batch_axes_of() -> tuple:
    """The active mesh's batch axes, ("pod", "data") where present."""
    mesh = current_mesh()
    names = () if mesh is None else tuple(mesh.mesh_dim_names or ())
    return tuple(a for a in ("pod", "data") if a in names)


def _group(axis: str):
    return current_mesh().get_group(axis)


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
                           site=site, dim=axis)
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
                                   site=ctx.site + "_grad", dim=ctx.axis)
        return out.movedim(0, ctx.dim), None, None, None, None, None


def gather(x: torch.Tensor, dim: int, n: int, axis: str, tag: str,
           site: str = "gather") -> torch.Tensor:
    """The whole dimension `dim` (n entries) from every rank's `split`
    piece along `axis` (x holds this rank's, padded to the even count);
    its gradient is reduce-scattered back to the pieces."""
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
                         dim=a)
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
