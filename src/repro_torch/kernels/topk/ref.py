"""Plain PyTorch version of the column top-k kernel."""
from __future__ import annotations

import torch

from repro_torch.topk import topk_lower_index_first


def topk_columns_ref(x: torch.Tensor, k: int, n_valid: int | None = None,
                     ids: torch.Tensor | None = None):
    """The ranked top-k of each column of x [R, B] over its first n_valid
    rows -> ([B, k] int32 vertex ids, [B, k] values), best first: larger
    value first, then the lower vertex id, where row r holds vertex ids[r]
    (ids None: vertex r).

    The rows are scattered into vertex order (ids must be a permutation of
    0..n_valid-1; rows past n_valid are dropped) and ranked by
    `topk_lower_index_first`, `lax.top_k`'s rule. Adding +0.0 first makes
    -0.0 rank, and come out, as +0.0: the two compare equal here, as in
    the kernel, while `lax.top_k` puts +0.0 first."""
    rows = x[:x.shape[0] if n_valid is None else n_valid]
    if ids is not None:
        rows = torch.empty_like(rows).index_copy_(0, ids.long(), rows)
    return topk_lower_index_first(rows.T + 0.0, k)
