"""Top-k with `lax.top_k`'s tie rule (lower index first), shared by the
PPR service's ticks and DLRM retrieval."""
from __future__ import annotations

import torch

__all__ = ["topk_lower_index_first"]


def topk_lower_index_first(x: torch.Tensor, k: int):
    """Top-k along dim 1 of [B, n], ties broken lower index first.

    `torch.topk` does not fix the order (or, at the k-th value, the choice)
    of tied entries; `lax.top_k` takes the lower index first. So: take the
    k-th largest value, keep every entry above it plus the lowest-index
    entries equal to it until k are kept, and order those by descending
    value with a stable sort over ascending indices.
    Returns ([B, k] int32 indices, [B, k] values).
    """
    kth = torch.topk(x, k, dim=1).values[:, k - 1:k]
    gt = x > kth
    eq = x == kth
    need = k - gt.sum(dim=1, keepdim=True, dtype=torch.int32)
    take = gt | (eq & (eq.cumsum(dim=1, dtype=torch.int32) <= need))
    idx = take.nonzero()[:, 1].reshape(x.shape[0], k)
    vals = x.gather(1, idx)
    order = torch.sort(vals, dim=1, descending=True, stable=True).indices
    return idx.gather(1, order).to(torch.int32), vals.gather(1, order)
