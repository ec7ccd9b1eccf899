"""Training-step builder (port of `repro.train.train_loop`): autograd +
microbatch accumulation + AdamW.

The global batch splits into M microbatches taken one after another;
gradients accumulate in float32. The reference's `grad_specs` and
`micro_unroll` pin gradients to a TPU mesh and unroll its scan; on one
card they mean nothing and wait for the sharding slice.
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


def _loss_and_grads(loss_fn, params, batch):
    leaves, spec = pytree.tree_flatten(params)
    # detached views of the same storage: gradients w.r.t. the values,
    # whatever the caller's tensors say about requires_grad
    xs = [p.detach().requires_grad_(True) for p in leaves]
    loss = loss_fn(pytree.tree_unflatten(xs, spec), batch)
    grads = torch.autograd.grad(loss, xs, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(xs, grads)]
    return loss.detach(), pytree.tree_unflatten(grads, spec)


def make_train_step(loss_fn, opt_cfg: AdamWConfig, num_microbatches: int = 1,
                    donate: bool = True):
    """loss_fn(params, microbatch) -> scalar. Returns
    train_step(params, opt_state, batch) -> (params, opt_state, metrics)
    with metrics = {"loss", "grad_norm"} (0-dim tensors).

    donate=True updates the caller's parameter and moment tensors in place
    and returns them; donate=False leaves them untouched and returns new
    tensors (a step can then be replayed from the same state)."""

    def train_step(params, opt_state, batch):
        if num_microbatches == 1:
            loss, grads = _loss_and_grads(loss_fn, params, batch)
        else:
            grads = pytree.tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)
            loss = 0.0
            for mb in _split_batch(batch, num_microbatches):
                l, g = _loss_and_grads(loss_fn, params, mb)
                grads = pytree.tree_map(lambda a, b: a + b.to(torch.float32),
                                        grads, g)
                loss = loss + l
            grads = pytree.tree_map(lambda g: g / num_microbatches, grads)
            loss = loss / num_microbatches
        new_params, new_state, metrics = adamw_update(grads, opt_state,
                                                      params, opt_cfg)
        metrics["loss"] = loss
        if not donate:
            return new_params, new_state, metrics
        with torch.no_grad():
            for old, new in zip(pytree.tree_leaves((params, opt_state)),
                                pytree.tree_leaves((new_params, new_state))):
                old.copy_(new)
        return params, opt_state, metrics

    return train_step
