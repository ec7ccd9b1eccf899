"""Wrapper for the embedding-bag kernel (`csrc/embedding_bag.cu`).

Replaces `repro.kernels.embedding_bag.ops.embedding_bag`, whose Pallas
kernel is `embedding_bag_pallas` in
src/repro/kernels/embedding_bag/embedding_bag.py. A CPU tensor goes to the
plain version (`ref.py`); a CUDA tensor launches the CUDA kernel or raises
-- there is no fallback on the card. The kernel is bound by memory: the
random row reads of the gather and the one write of each output row.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref

__all__ = ["embedding_bag", "launches", "reset_launches"]

_LAUNCHES = 0
_FN = None


def launches() -> int:
    """Kernel launches since the last `reset_launches()`."""
    return _LAUNCHES


def reset_launches() -> None:
    global _LAUNCHES
    _LAUNCHES = 0


def _kernel_fn():
    global _FN
    if _FN is None:
        fn = _build.library("embedding_bag").embedding_bag_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 3 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _check(ids: torch.Tensor, table: torch.Tensor,
           weights: torch.Tensor | None) -> None:
    """Raise on anything the CUDA kernel does not take."""
    if table.dtype != torch.float32:
        raise TypeError(f"embedding_bag: table must be float32, got "
                        f"{table.dtype}")
    if ids.dtype != torch.int32:
        raise TypeError(f"embedding_bag: ids must be int32, got {ids.dtype}")
    if table.ndim != 2:
        raise ValueError(f"embedding_bag: table must be [V, D], got "
                         f"{tuple(table.shape)}")
    if ids.ndim != 2:
        raise ValueError(f"embedding_bag: ids must be [B, L], got "
                         f"{tuple(ids.shape)}")
    named = [("ids", ids), ("table", table)]
    if weights is not None:
        if weights.dtype != torch.float32:
            raise TypeError(f"embedding_bag: weights must be float32, got "
                            f"{weights.dtype}")
        if weights.shape != ids.shape:
            raise ValueError(f"embedding_bag: weights "
                             f"{tuple(weights.shape)} != ids "
                             f"{tuple(ids.shape)}")
        named.append(("weights", weights))
    for name, a in named:
        if a.device != table.device:
            raise ValueError(f"embedding_bag: {name} on {a.device}, table on "
                             f"{table.device}")
        if not a.is_contiguous():
            raise ValueError(f"embedding_bag: {name} must be contiguous")


def _launch(ids: torch.Tensor, table: torch.Tensor,
            weights: torch.Tensor | None) -> torch.Tensor:
    global _LAUNCHES
    _check(ids, table, weights)
    n_bags, bag = ids.shape
    out = torch.empty((n_bags, table.shape[1]), dtype=torch.float32,
                      device=table.device)
    if out.numel() == 0:
        return out
    fn = _kernel_fn()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = fn(ids.data_ptr(), table.data_ptr(),
                 None if weights is None else weights.data_ptr(),
                 out.data_ptr(), n_bags, bag, table.shape[1], stream)
    if err != 0:
        raise RuntimeError(f"embedding_bag: kernel launch failed with CUDA "
                           f"error {err}")
    _LAUNCHES += 1
    return out


def embedding_bag(ids: torch.Tensor, table: torch.Tensor,
                  weights: torch.Tensor | None = None) -> torch.Tensor:
    """Bag-sum lookup: out[b] = sum_l w[b, l] * table[ids[b, l]] -> [B, D]
    float32.

    ids [B, L] are cast to int32 and weights [B, L] to float32, as the
    reference wrapper does; weights default to ones (the plain multi-hot
    sum, the DLRM case). Duplicate ids accumulate. ids must lie in [0, V):
    the CUDA path does not check them (that would cost a host sync).

    On CPU tensors this is the plain version; on CUDA tensors the CUDA
    kernel (table float32 [V, D], all inputs contiguous), which reads unit
    weights without materializing them."""
    ids = ids.to(torch.int32)
    if weights is not None:
        weights = weights.to(torch.float32)
    if table.device.type == "cuda":
        return _launch(ids, table, weights)
    if table.device.type == "cpu" and ids.device.type == "cpu" and \
            (weights is None or weights.device.type == "cpu"):
        return embedding_bag_ref(ids, table.to(torch.float32), weights)
    raise ValueError(f"embedding_bag: tensors on {ids.device}, "
                     f"{table.device}"
                     + ("" if weights is None else f", {weights.device}"))
