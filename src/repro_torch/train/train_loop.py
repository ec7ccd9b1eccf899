"""Training-step builder (port of `repro.train.train_loop`): autograd +
microbatch accumulation + AdamW.

The global batch splits into M microbatches taken one after another;
gradients accumulate in float32, each leaf's added into its accumulator
as soon as the backward has it (a hook after the leaf's gradient is
accumulated), so the microbatch's own gradients never exist all at once.
The reference's `grad_specs` and `micro_unroll` pin gradients to a TPU
mesh and unroll its scan; on one card they mean nothing and wait for the
sharding slice.
"""
from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

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


def make_train_step(loss_fn, opt_cfg: AdamWConfig, num_microbatches: int = 1,
                    donate: bool = True):
    """loss_fn(params, microbatch) -> scalar. Returns
    train_step(params, opt_state, batch) -> (params, opt_state, metrics)
    with metrics = {"loss", "grad_norm"} (0-dim tensors).

    donate=True updates the caller's parameter and moment tensors in place
    (slice by slice, `adamw_update(in_place=True)`) and returns them;
    donate=False leaves them untouched and returns new tensors (a step can
    then be replayed from the same state). Both give the same bits."""

    def train_step(params, opt_state, batch):
        leaves, spec, xs = _grad_leaves(params)
        if num_microbatches == 1:
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
                for mb in _split_batch(batch, num_microbatches):
                    loss = loss + _backward(loss_fn, xs, spec, mb)
            finally:
                for h in hooks:
                    h.remove()
            for g in grads:
                g.div_(num_microbatches)
            loss = loss / num_microbatches
        del xs
        params, opt_state, metrics = adamw_update(
            pytree.tree_unflatten(grads, spec), opt_state, params, opt_cfg,
            in_place=donate)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step
