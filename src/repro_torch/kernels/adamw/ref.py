"""Plain PyTorch versions of the AdamW update of one leaf and of a leaf's
sum of squares (the clip's global norm), the arithmetic of the
reference's `repro.train.optimizer.adamw_update` / `global_norm` in torch
ops. The CUDA kernels (`csrc/adamw_step.cu`, `csrc/sum_squares.cu`)
compute the same functions; the update bit for bit."""
from __future__ import annotations

import torch


def math_dtype(t: torch.Tensor) -> torch.dtype:
    """float32, or the tensor's own dtype where that is wider."""
    return torch.promote_types(t.dtype, torch.float32)


def sum_squares_ref(x: torch.Tensor) -> torch.Tensor:
    """sum x^2 in the leaf's math dtype (0-dim)."""
    return x.to(math_dtype(x)).square().sum()


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
def adamw_step_ref(p, g, m, v, scale, bc1, bc2, *, lr: float, b1: float,
                   b2: float, eps: float, weight_decay: float,
                   in_place: bool = False) -> tuple:
    """One leaf's AdamW update -> (p', m', v'): into p, m, v themselves
    with `in_place`, else into new tensors (the inputs untouched). Slice
    by slice: each slice's new p, m, v are written before the next slice
    starts. The arithmetic is elementwise, so the result is bitwise that
    of the whole leaf at once."""
    outs = (p, m, v) if in_place else tuple(torch.empty_like(t)
                                            for t in (p, m, v))
    dt = math_dtype(p)
    for po, mo, vo, ps, gs, ms, vs in zip(*map(_slices, (*outs, p, g, m,
                                                          v))):
        gs = gs.to(dt) * scale
        m_new = b1 * ms.to(dt) + (1 - b1) * gs
        v_new = b2 * vs.to(dt) + (1 - b2) * gs.square()
        m_hat = m_new / bc1
        v_hat = v_new / bc2
        delta = m_hat / (torch.sqrt(v_hat) + eps) + \
            weight_decay * ps.to(dt)
        p_new = ps.to(dt) - lr * delta
        po.copy_(p_new)
        mo.copy_(m_new)
        vo.copy_(v_new)
    return outs
