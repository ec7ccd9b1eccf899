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
    value with a stable sort over ascending indices. No step reads a count
    back to the host, so on CUDA the call only enqueues work (the PPR
    service's async dispatch relies on it).
    Returns ([B, k] int32 indices, [B, k] values).
    """
    kth = torch.topk(x, k, dim=1).values[:, k - 1:k]
    gt = x > kth
    eq = x == kth
    need = k - gt.sum(dim=1, keepdim=True, dtype=torch.int32)
    take = gt | (eq & (eq.cumsum(dim=1, dtype=torch.int32) <= need))
    # exactly k entries per row are taken: a top-k over the key n - j of
    # the taken entries (-1 elsewhere) lists them in ascending index order
    n = x.shape[1]
    key = torch.where(take, torch.arange(n, 0, -1, dtype=torch.int32,
                                         device=x.device), -1)
    idx = torch.topk(key, k, dim=1).indices
    vals = x.gather(1, idx)
    order = torch.sort(vals, dim=1, descending=True, stable=True).indices
    return idx.gather(1, order).to(torch.int32), vals.gather(1, order)
