"""Hand-rolled AdamW (port of `repro.train.optimizer`).

AdamW with decoupled weight decay, clipped by the global gradient norm.
The arithmetic is the reference's, step for step and in float32 (float64
parameters update in float64): clip scale min(1, clip / (|g| + 1e-9)),
bias-corrected moments, p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p).
`torch.optim.AdamW` and `clip_grad_norm_` round differently, clip with
1e-6 and keep no bfloat16 moments, so the port does not use them. Moment
dtypes are configurable (bf16 moments for the largest configs); the state
mirrors the parameter tree.

Sharded (the parameters, gradients and moments are this rank's pieces
under their specs, inside `use_mesh(mesh, sharded=True)`), the update is
the same elementwise arithmetic on the local pieces; only the clip's
global norm needs the other ranks: `global_norm` sums each leaf's squares
over the mesh axes of its spec (one all-reduce per group of leaves
sharded alike, tag "train") and not over the axes it is replicated on,
so every rank clips by the norm of the whole gradient.

Each leaf's update and sum of squares go through the wrappers of
`kernels.adamw`: on the card one pass of the hand-written update kernel
(bitwise the plain version) and one read for the norm; on the CPU the
plain versions, slice by slice for the update.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.utils import _pytree as pytree

from repro_torch.kernels.adamw.ops import adamw_step, sum_squares

__all__ = ["AdamWConfig", "adamw_init", "global_norm", "adamw_update"]


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    m_dtype: str = "float32"
    v_dtype: str = "float32"


def adamw_init(params, cfg: AdamWConfig) -> dict:
    """{"step": int32 0, "m": zeros, "v": zeros} beside each parameter."""
    leaf = pytree.tree_leaves(params)[0]

    def zeros(dtype):
        return pytree.tree_map(
            lambda p: torch.zeros(p.shape, dtype=dtype, device=p.device),
            params)
    return {"step": torch.zeros((), dtype=torch.int32, device=leaf.device),
            "m": zeros(getattr(torch, cfg.m_dtype)),
            "v": zeros(getattr(torch, cfg.v_dtype))}


def global_norm(tree, specs: list | None = None) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares, in at
    least float32. `specs` (one per leaf, in flatten order): the leaves
    are this rank's pieces, and each group of leaves sharded over the same
    mesh axes has its sum all-reduced over those axes (the padding of an
    uneven piece is zero and adds nothing)."""
    leaves = pytree.tree_leaves(tree)
    if specs is None:
        return torch.sqrt(sum(sum_squares(l) for l in leaves))
    from repro_torch.distributed import parallel
    from repro_torch.distributed.sharding import axes_of
    groups: dict = {}
    for leaf, spec in zip(leaves, specs):
        axes = tuple(sorted({a for e in (spec or ()) for a in axes_of(e)
                             if parallel.size(a) > 1}))
        part = sum_squares(leaf)
        groups[axes] = groups[axes] + part if axes in groups else part
    total = 0.0
    for axes, part in groups.items():
        total = total + parallel.all_sum(part.clone(), axes, tag="train",
                                         site="grad_norm")
    return torch.sqrt(total)


def _leaves_like(tree, like) -> list:
    """The leaves of `tree` in the order of `like`'s (dict keys matched by
    name, whatever order each dict was built in)."""
    if isinstance(like, dict):
        return [x for k in like for x in _leaves_like(tree[k], like[k])]
    if isinstance(like, (list, tuple)):
        return [x for t, l in zip(tree, like) for x in _leaves_like(t, l)]
    return [tree]


@torch.no_grad()
def adamw_update(grads, state, params, cfg: AdamWConfig,
                 in_place: bool = False, grad_specs: list | None = None):
    """Returns (new_params, new_state, metrics). metrics = {"grad_norm":
    the norm before clipping; with `grad_specs` (one spec per leaf, the
    pieces of a sharded step) the whole gradient's, `global_norm`}.

    By default the inputs are not modified and the results are new
    tensors. With in_place, each parameter, m and v is overwritten with
    its update, leaf by leaf (on the card one kernel pass with no
    temporaries; on the CPU a large leaf slice by slice, so the peak is the
    state plus one slice's temporaries), and the same tensors are
    returned, `state["step"]` included; the values are bitwise the same.
    """
    step = state["step"] + 1
    gnorm = global_norm(grads, grad_specs)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                       device=stepf.device), stepf)
    bc2 = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                       device=stepf.device), stepf)

    p_leaves, spec = pytree.tree_flatten(params)
    outs = [adamw_step(p, g, m, v, scale, bc1, bc2, lr=cfg.lr, b1=cfg.b1,
                       b2=cfg.b2, eps=cfg.eps,
                       weight_decay=cfg.weight_decay, in_place=in_place)
            for p, g, m, v in zip(p_leaves, _leaves_like(grads, params),
                                  _leaves_like(state["m"], params),
                                  _leaves_like(state["v"], params))]
    if in_place:
        state["step"].copy_(step)
        return params, state, {"grad_norm": gnorm}
    new_params, new_m, new_v = (pytree.tree_unflatten(list(o), spec)
                                for o in zip(*outs))
    return new_params, {"step": step, "m": new_m, "v": new_v}, \
        {"grad_norm": gnorm}
