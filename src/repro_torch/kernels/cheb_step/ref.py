"""Plain PyTorch versions of the Chebyshev-update kernels."""
from __future__ import annotations

import torch


def cheb_step_ref(y: torch.Tensor, t: torch.Tensor, acc: torch.Tensor, ck):
    """(t'', acc') with t'' = 2y - t and acc' = acc + ck * t''."""
    t_next = 2.0 * y - t
    return t_next, acc + ck * t_next


def cheb_step_masked_ref(y: torch.Tensor, t: torch.Tensor, acc: torch.Tensor,
                         ck, active: torch.Tensor):
    """One masked round in place -> (y, acc), y now holding t'':

        active[j]:  t'' = 2y - t;  acc' = acc + ck * t''
        else:       t'' = 0;       acc' = acc

    `active` is [B] bool for [n, B] operands, a 0-dim bool for [n]."""
    mask = active if y.ndim == 1 else active[None, :]
    t_next = torch.where(mask, 2.0 * y - t, 0.0)
    acc.copy_(torch.where(mask, acc + ck * t_next, acc))
    return y.copy_(t_next), acc


def cheb_residual_ref(acc: torch.Tensor, snap: torch.Tensor,
                      reduce=None) -> torch.Tensor:
    """The chunk residual of the adaptive loop -> resid [] / [B]:

        s = reduce(colsum(acc));  norm = acc / (|s| < tiny ? tiny : s)
        resid = reduce(sum_i |norm - snap|);  snap <- norm (in place)

    `reduce` (None = none) sums a column vector over the ranks that
    together hold the vector (`sum_over_ranks` of a sharded engine)."""
    reduce = reduce or (lambda x: x)
    s = reduce(acc.sum(dim=0))
    tiny = torch.finfo(acc.dtype).tiny
    norm = acc / torch.where(s.abs() < tiny, tiny, s)
    resid = reduce((norm - snap).abs().sum(dim=0))
    snap.copy_(norm)
    return resid
