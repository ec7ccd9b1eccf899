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


def global_norm(tree, specs: list | None = None) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares, in at
    least float32. `specs` (one per leaf, in flatten order): the leaves
    are this rank's pieces, and each group of leaves sharded over the same
    mesh axes has its sum all-reduced over those axes (the padding of an
    uneven piece is zero and adds nothing)."""
    leaves = pytree.tree_leaves(tree)
    if specs is None:
        return torch.sqrt(sum(l.to(_math_dtype(l)).square().sum()
                              for l in leaves))
    from repro_torch.distributed import parallel
    from repro_torch.distributed.sharding import axes_of
    groups: dict = {}
    for leaf, spec in zip(leaves, specs):
        axes = tuple(sorted({a for e in (spec or ()) for a in axes_of(e)
                             if parallel.size(a) > 1}))
        part = leaf.to(_math_dtype(leaf)).square().sum()
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


# elements per slice of a leaf the update takes at once: its temporaries
# then stay ~256 MB each, whatever the leaf's size
_SLICE_ELEMS = 1 << 26


def _slices(t: torch.Tensor):
    """Views of t along its leading axis, each of at most _SLICE_ELEMS
    elements where a leading row allows it (a stacked leaf goes a few
    layers at a time)."""
    if t.ndim == 0 or t.numel() <= _SLICE_ELEMS:
        return [t]
    rows = max(1, _SLICE_ELEMS // max(1, t[0].numel()))
    return list(torch.split(t, rows))


@torch.no_grad()
def _update_into(outs, p, g, m, v, scale, bc1, bc2, cfg: AdamWConfig):
    """One leaf's AdamW update, slice by slice: each slice's new p, m, v
    are written into `outs` (which may be p, m, v themselves) before the
    next slice starts. The arithmetic is elementwise, so the result is
    bitwise that of the whole leaf at once."""
    b1, b2 = cfg.b1, cfg.b2
    dt = _math_dtype(p)
    for po, mo, vo, ps, gs, ms, vs in zip(*map(_slices, (*outs, p, g, m,
                                                          v))):
        gs = gs.to(dt) * scale
        m_new = b1 * ms.to(dt) + (1 - b1) * gs
        v_new = b2 * vs.to(dt) + (1 - b2) * gs.square()
        m_hat = m_new / bc1
        v_hat = v_new / bc2
        delta = m_hat / (torch.sqrt(v_hat) + cfg.eps) + \
            cfg.weight_decay * ps.to(dt)
        p_new = ps.to(dt) - cfg.lr * delta
        po.copy_(p_new)
        mo.copy_(m_new)
        vo.copy_(v_new)


@torch.no_grad()
def adamw_update(grads, state, params, cfg: AdamWConfig,
                 in_place: bool = False, grad_specs: list | None = None):
    """Returns (new_params, new_state, metrics). metrics = {"grad_norm":
    the norm before clipping; with `grad_specs` (one spec per leaf, the
    pieces of a sharded step) the whole gradient's, `global_norm`}.

    By default the inputs are not modified and the results are new
    tensors. With in_place, each parameter, m and v is overwritten with
    its update (leaf by leaf, a large leaf slice by slice, so the peak is
    the state plus one slice's temporaries) and the same tensors are
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
    m_leaves = _leaves_like(state["m"], params)
    v_leaves = _leaves_like(state["v"], params)
    outs = (p_leaves, m_leaves, v_leaves) if in_place else \
        tuple([torch.empty_like(t) for t in leaves]
              for leaves in (p_leaves, m_leaves, v_leaves))
    for i, (p, g, m, v) in enumerate(zip(p_leaves,
                                         _leaves_like(grads, params),
                                         m_leaves, v_leaves)):
        _update_into([o[i] for o in outs], p, g, m, v, scale, bc1, bc2, cfg)
    if in_place:
        state["step"].copy_(step)
        return params, state, {"grad_norm": gnorm}
    new_params, new_m, new_v = (pytree.tree_unflatten(o, spec) for o in outs)
    return new_params, {"step": step, "m": new_m, "v": new_v}, \
        {"grad_norm": gnorm}
