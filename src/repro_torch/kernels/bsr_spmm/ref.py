"""Plain PyTorch version of the block-ELL SpMM kernel."""
from __future__ import annotations

import torch


def bsr_spmm_ref(block_cols: torch.Tensor, values: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """y[i*B:(i+1)*B] = sum_s values[i,s] @ x[block_cols[i,s]*B : +B].

    Gather of the x blocks plus one einsum, as `repro.kernels.bsr_spmm.ref`
    does; x is [n, BT] with n = n_rb * B.
    """
    n_rb, _, blk, _ = values.shape
    n, bt = x.shape
    x_blocks = x.reshape(n_rb, blk, bt)                       # [n_rb, B, BT]
    gathered = x_blocks[block_cols.long()]                    # [n_rb, S, B, BT]
    y = torch.einsum("rsij,rsjb->rib", values, gathered)
    return y.reshape(n, bt)
