"""Plain PyTorch version of the fused Chebyshev update."""
from __future__ import annotations

import torch


def cheb_step_ref(y: torch.Tensor, t: torch.Tensor, acc: torch.Tensor, ck):
    """(t'', acc') with t'' = 2y - t and acc' = acc + ck * t''."""
    t_next = 2.0 * y - t
    return t_next, acc + ck * t_next
