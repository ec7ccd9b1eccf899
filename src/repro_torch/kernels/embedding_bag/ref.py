"""Plain PyTorch version of the embedding-bag lookup: gather + weighted
sum (the same function as `repro.kernels.embedding_bag.ref`)."""
from __future__ import annotations

import torch


def embedding_bag_ref(ids: torch.Tensor, table: torch.Tensor,
                      weights: torch.Tensor | None = None) -> torch.Tensor:
    """out[b] = sum_l weights[b, l] * table[ids[b, l]]; ids [B, L] (int32 or
    int64), table [V, D], weights [B, L] or None for unit weights -> [B, D].
    """
    rows = table.index_select(0, ids.reshape(-1)).reshape(
        *ids.shape, table.shape[1])                      # [B, L, D]
    if weights is not None:
        rows = rows * weights.unsqueeze(-1)
    return rows.sum(dim=1)
