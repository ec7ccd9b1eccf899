"""Training-step builder (port of `repro.train.train_loop`): autograd +
microbatch accumulation + AdamW.

The global batch splits into M microbatches taken one after another;
gradients accumulate in float32, each leaf's added into its accumulator
as soon as the backward has it (a hook after the leaf's gradient is
accumulated), so the microbatch's own gradients never exist all at once.

Under a mesh of more than one rank (`distributed.use_mesh`) each rank
feeds the step its own data shard, and the step takes the data-parallel
mean: every gradient leaf and the loss are summed over all the mesh's
ranks (one all-reduce each, counted by `core.distributed` under tag
"train") and divided by their count, so every rank applies the gradient
the reference's GSPMD step applies for the whole batch. The mean runs
over data x model, not over data alone: the ranks of a "model" group
hold the same tokens, and with the all-to-all MoE each holds the
gradient of its own expert slice only (zero elsewhere), so the sum over
the group assembles the experts and the division by data x model is the
reference's mean over the per-shard aux estimates.

Sharded (`use_mesh(mesh, sharded=True)`: the parameters are this rank's
pieces under their specs, which the caller passes as `grad_specs`), the
step honours the specs, leaf by leaf (`_spec_mean`):
  * a leaf whose spec holds "data" (an FSDP piece) has its gradient
    reduce-scattered over "data" already: the model all-gathers such a
    weight just before use, and that gather's backward is the reduce-
    scatter (`distributed.parallel.gather`, tag "fsdp"); the step divides
    it by the data size (and, on a multi-pod mesh, all-reduces it over
    "pod" first);
  * any other leaf is all-reduced over the batch axes, as `_mesh_mean`
    does over the whole mesh, and divided by their size;
  * nothing is summed over "model": a leaf sharded over it holds its own
    piece, and one replicated over it has the same gradient on every
    rank of the group.
The gradient norm of the clip is then the norm of the whole gradient
(`optimizer.global_norm` with the specs), and AdamW's update runs on the
local pieces.

A GNN step shards its batch over every mesh axis and each rank's loss is
its part of the one global loss (`models.gnn.common`), so its plan asks
for `grad_rule="sum"`: sharded, every gradient leaf and the loss are
summed over all the mesh's ranks (the world group, tag "train", site
"grad_sum"), with no division (`_global_sum`). The default, "mean",
keeps `_spec_mean` for the LM and DLRM plans.
"""
from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from repro_torch.core import distributed as cdist
from repro_torch.distributed import parallel
from repro_torch.distributed.sharding import axes_of, current_mesh, \
    params_sharded
from repro_torch.train.optimizer import AdamWConfig, adamw_update

__all__ = ["make_train_step"]


def _split_batch(batch, num_micro: int) -> list:
    def split(x):
        b = x.shape[0]
        if b % num_micro:
            raise ValueError(f"batch of {b} rows does not split into "
                             f"{num_micro} microbatches")
        return x.reshape(num_micro, b // num_micro, *x.shape[1:])
    stacked = pytree.tree_map(split, batch)
    return [pytree.tree_map(lambda x: x[i], stacked)
            for i in range(num_micro)]


def _grad_leaves(params):
    """(leaves, spec, xs): detached views of the parameters' storage that
    require grad, so gradients are taken w.r.t. the values whatever the
    caller's tensors say about requires_grad."""
    leaves, spec = pytree.tree_flatten(params)
    return leaves, spec, [p.detach().requires_grad_(True) for p in leaves]


def _backward(loss_fn, xs, spec, batch) -> torch.Tensor:
    loss = loss_fn(pytree.tree_unflatten(xs, spec), batch)
    torch.autograd.backward(loss, inputs=xs)
    return loss.detach()


def _mesh_mean(grads: list, loss: torch.Tensor) -> torch.Tensor:
    """Under a mesh of more than one rank: every gradient leaf and the loss
    summed over the mesh's ranks and divided by their count, in place;
    returns the mean loss. Without one, the loss as it is."""
    mesh = current_mesh()
    if mesh is None or mesh.size() == 1:
        return loss
    group, _, n = cdist.flat_rank(mesh)
    for g in grads:
        cdist.all_reduce(g, group, torch.distributed.ReduceOp.SUM,
                         tag="train", site="grad_mean")
        g.div_(n)
    loss = loss.detach().clone()
    cdist.all_reduce(loss, group, torch.distributed.ReduceOp.SUM,
                     tag="train", site="loss_mean")
    return loss / n


def spec_leaves(specs, params) -> list:
    """The spec of each leaf of `params`, in its flatten order (None:
    replicated)."""
    if specs is None:
        return [None] * len(pytree.tree_leaves(params))
    if isinstance(params, dict):
        return [s for k in params for s in spec_leaves(specs[k], params[k])]
    if isinstance(params, (list, tuple)):
        return [s for p, sp in zip(params, specs)
                for s in spec_leaves(sp, p)]
    return [specs]


def _spec_axes(spec) -> set:
    return {a for e in (spec or ()) for a in axes_of(e)}


def _spec_mean(grads: list, specs: list, loss: torch.Tensor):
    """The sharded step's gradient mean (module docstring), in place;
    returns the mean loss over the batch axes."""
    axes = parallel.batch_axes_of()
    n = 1
    for a in axes:
        n *= parallel.size(a)
    if n == 1:
        return loss
    for g, spec in zip(grads, specs):
        fsdp = "data" in _spec_axes(spec)
        over = [a for a in axes if not (fsdp and a == "data")]
        parallel.all_sum(g, tuple(over), tag="train", site="grad_mean")
        g.div_(n)
    loss = loss.detach().clone()
    parallel.all_sum(loss, axes, tag="train", site="loss_mean")
    return loss / n


def _global_sum(grads: list, loss: torch.Tensor) -> torch.Tensor:
    """The GNN rule (module docstring): every gradient leaf and the loss
    summed over all the active mesh's ranks, in place; returns the summed
    loss."""
    mesh = current_mesh()
    axes = tuple(mesh.mesh_dim_names or ())
    if parallel.size(axes) == 1:
        return loss
    for g in grads:
        parallel.all_sum(g, (axes,), tag="train", site="grad_sum")
    return parallel.all_sum(loss.detach().clone(), (axes,), tag="train",
                            site="loss_sum")


def make_train_step(loss_fn, opt_cfg: AdamWConfig, num_microbatches: int = 1,
                    donate: bool = True, grad_specs=None,
                    grad_rule: str = "mean"):
    """loss_fn(params, microbatch) -> scalar. Returns
    train_step(params, opt_state, batch) -> (params, opt_state, metrics)
    with metrics = {"loss", "grad_norm"} (0-dim tensors).

    donate=True updates the caller's parameter and moment tensors in place
    (slice by slice, `adamw_update(in_place=True)`) and returns them;
    donate=False leaves them untouched and returns new tensors (a step can
    then be replayed from the same state). Both give the same bits.

    Under a mesh of more than one rank, `batch` is this rank's shard and
    the step applies the mean of the ranks' gradients (`_mesh_mean`);
    metrics then hold the mean loss. Sharded, `params` and `opt_state`
    are this rank's pieces under `grad_specs` (the parameters' specs) and
    the mean follows them (`_spec_mean`); without a sharded mesh the specs
    change nothing. `grad_rule="sum"` (a GNN plan's) makes a sharded
    step sum the ranks' gradients and losses instead (`_global_sum`)."""
    if grad_rule not in ("mean", "sum"):
        raise ValueError(f"grad_rule {grad_rule!r}: 'mean' or 'sum'")

    def train_step(params, opt_state, batch):
        sharded = params_sharded()
        leaves, spec, xs = _grad_leaves(params)
        n_micro = num_microbatches
        rows = pytree.tree_leaves(batch)[0].shape[0]
        if sharded and rows < n_micro and n_micro % rows == 0:
            # a microbatch of the whole batch holds fewer rows than there
            # are batch ranks (GSPMD pads it): this rank's piece runs one
            # microbatch per row, the same mean over rows
            n_micro = rows
        if n_micro == 1:
            loss = _backward(loss_fn, xs, spec, batch)
            grads = [torch.zeros_like(x) if x.grad is None else x.grad
                     for x in xs]
        else:
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in leaves]

            def drain(acc):
                def hook(x):
                    acc.add_(x.grad)
                    x.grad = None
                return hook
            hooks = [x.register_post_accumulate_grad_hook(drain(a))
                     for x, a in zip(xs, grads)]
            try:
                loss = 0.0
                for mb in _split_batch(batch, n_micro):
                    loss = loss + _backward(loss_fn, xs, spec, mb)
            finally:
                for h in hooks:
                    h.remove()
            for g in grads:
                g.div_(n_micro)
            loss = loss / n_micro
        del xs
        specs = spec_leaves(grad_specs, params) if sharded else None
        if sharded and grad_rule == "sum":
            loss = _global_sum(grads, loss)
        elif sharded:
            loss = _spec_mean(grads, specs, loss)
        else:
            loss = _mesh_mean(grads, loss)
        params, opt_state, metrics = adamw_update(
            pytree.tree_unflatten(grads, spec), opt_state, params, opt_cfg,
            in_place=donate, grad_specs=specs)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step
