"""Hand-rolled AdamW (port of `repro.train.optimizer`).

AdamW with decoupled weight decay, clipped by the global gradient norm.
The arithmetic is the reference's, step for step and in float32 (float64
parameters update in float64): clip scale min(1, clip / (|g| + 1e-9)),
bias-corrected moments, p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p).
`torch.optim.AdamW` and `clip_grad_norm_` round differently, clip with
1e-6 and keep no bfloat16 moments, so the port does not use them. Moment
dtypes are configurable (bf16 moments for the largest configs); the state
mirrors the parameter tree.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.utils import _pytree as pytree

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


def _math_dtype(t: torch.Tensor) -> torch.dtype:
    """float32, or the tensor's own dtype where that is wider."""
    return torch.promote_types(t.dtype, torch.float32)


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


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares, in at
    least float32."""
    leaves = pytree.tree_leaves(tree)
    return torch.sqrt(sum(l.to(_math_dtype(l)).square().sum()
                          for l in leaves))


@torch.no_grad()
def adamw_update(grads, state, params, cfg: AdamWConfig):
    """Returns (new_params, new_state, metrics) as new tensors; the inputs
    are not modified. metrics = {"grad_norm": the norm before clipping}."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                       device=stepf.device), stepf)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                       device=stepf.device), stepf)

    def upd(p, g, m, v):
        dt = _math_dtype(p)
        g = g.to(dt) * scale
        m_new = b1 * m.to(dt) + (1 - b1) * g
        v_new = b2 * v.to(dt) + (1 - b2) * g.square()
        m_hat = m_new / bc1
        v_hat = v_new / bc2
        delta = m_hat / (torch.sqrt(v_hat) + cfg.eps) + \
            cfg.weight_decay * p.to(dt)
        p_new = p.to(dt) - cfg.lr * delta
        return p_new.to(p.dtype), m_new.to(m.dtype), v_new.to(v.dtype)

    p_leaves, spec = pytree.tree_flatten(params)
    out = [upd(p, g, m, v) for p, g, m, v in zip(
        p_leaves, pytree.tree_leaves(grads), pytree.tree_leaves(state["m"]),
        pytree.tree_leaves(state["v"]))]
    new_params, new_m, new_v = (pytree.tree_unflatten([o[k] for o in out],
                                                      spec)
                                for k in range(3))
    return new_params, {"step": step, "m": new_m, "v": new_v}, \
        {"grad_norm": gnorm}
