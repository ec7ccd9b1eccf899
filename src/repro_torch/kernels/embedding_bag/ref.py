"""Plain PyTorch versions of the embedding-bag lookup, gather + weighted
sum (the same function as `repro.kernels.embedding_bag.ref`), and of its
table gradient, a scatter-add (`index_add_`); of both over a window of
the table's rows (one rank's row shard), where an id outside the window
adds nothing; and of the window backward's index preparation."""
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


def embedding_bag_backward_ref(ids: torch.Tensor, grad_out: torch.Tensor,
                               n_rows: int,
                               weights: torch.Tensor | None = None
                               ) -> torch.Tensor:
    """The lookup's table gradient: grad[ids[b, l]] += weights[b, l] *
    grad_out[b] into a dense [n_rows, D] of grad_out's dtype (duplicates
    accumulate), by one `index_add_`."""
    b, bag = ids.shape
    contrib = grad_out[:, None, :].expand(b, bag, grad_out.shape[1])
    if weights is not None:
        contrib = contrib * weights.unsqueeze(-1).to(grad_out.dtype)
    grad = torch.zeros((n_rows, grad_out.shape[1]), dtype=grad_out.dtype,
                       device=grad_out.device)
    return grad.index_add_(0, ids.reshape(-1).long(),
                           contrib.reshape(b * bag, -1))


def _window(ids: torch.Tensor, row_lo: int, n_local: int):
    """(mask, local row) of each id: inside [row_lo, row_lo + n_local),
    and its row there (0 outside)."""
    ids = ids.long()
    inside = (ids >= row_lo) & (ids < row_lo + n_local)
    return inside, torch.where(inside, ids - row_lo, 0)


def embedding_bag_window_ref(ids: torch.Tensor, table: torch.Tensor,
                             row_lo: int,
                             weights: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """`embedding_bag_ref` over rows [row_lo, row_lo + len(table)) of the
    whole table, held in `table`: out[b] = sum over the bag's ids inside
    the window of w * table[id - row_lo]; an id outside adds an exact 0."""
    inside, local = _window(ids, row_lo, table.shape[0])
    rows = table.index_select(0, local.reshape(-1)).reshape(
        *ids.shape, table.shape[1])
    rows = torch.where(inside.unsqueeze(-1), rows, 0.0)
    if weights is not None:
        rows = rows * weights.unsqueeze(-1)
    return rows.sum(dim=1)


def window_sort_ref(ids: torch.Tensor, row_lo: int, n_local: int):
    """The window backward's index preparation: of the flat ids, the
    entries whose id lies in [row_lo, row_lo + n_local), as (keys, vals,
    n_in): keys int32 [n_in] their local rows id - row_lo in ascending
    order, vals int32 [n_in] their flat positions, in position order among
    equal keys (a stable sort), n_in int32 [1] their count."""
    flat = ids.reshape(-1).long()
    pos = torch.nonzero((flat >= row_lo) & (flat < row_lo + n_local))[:, 0]
    keys, order = torch.sort(flat[pos] - row_lo, stable=True)
    n_in = torch.tensor([pos.numel()], dtype=torch.int32, device=ids.device)
    return keys.to(torch.int32), pos[order].to(torch.int32), n_in


def embedding_bag_backward_window_ref(ids: torch.Tensor,
                                      grad_out: torch.Tensor, row_lo: int,
                                      n_local: int,
                                      weights: torch.Tensor | None = None
                                      ) -> torch.Tensor:
    """`embedding_bag_backward_ref` into rows [row_lo, row_lo + n_local)
    of the table's gradient: [n_local, D], an id outside the window
    writing nothing. Through the index preparation (`window_sort_ref`):
    one `index_add_` of the entries inside, each row's terms in position
    order."""
    keys, pos, _ = window_sort_ref(ids, row_lo, n_local)
    pos = pos.long()
    contrib = grad_out.index_select(0, pos // ids.shape[1])
    if weights is not None:
        contrib = contrib * weights.reshape(-1)[pos].unsqueeze(-1).to(
            grad_out.dtype)
    grad = torch.zeros((n_local, grad_out.shape[1]), dtype=grad_out.dtype,
                       device=grad_out.device)
    return grad.index_add_(0, keys.long(), contrib)
