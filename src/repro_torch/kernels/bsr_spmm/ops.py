"""Wrapper for the block-ELL SpMM kernel (`csrc/bsr_spmm.cu`).

Replaces `repro.kernels.bsr_spmm.ops.bsr_spmm`, whose Pallas kernel is
`bsr_spmm_pallas` in src/repro/kernels/bsr_spmm/bsr_spmm.py. A CPU tensor
goes to the plain version (`ref.py`); a CUDA tensor launches the CUDA
kernel or raises -- there is no fallback on the card. The kernel is bound
by its FP32 FFMA rate on dense 128x128 tiles (and by the 4 bytes a tile
value costs to read); see the source for the design.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bsr_spmm.ref import bsr_spmm_ref

__all__ = ["bsr_spmm", "BLOCK", "launches", "reset_launches"]

BLOCK = 128   # the only tile edge the CUDA kernel takes

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
        fn = _build.library("bsr_spmm").bsr_spmm_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _check(block_cols: torch.Tensor, values: torch.Tensor,
           x: torch.Tensor) -> None:
    """Raise on anything the CUDA kernel does not take."""
    if values.dtype != torch.float32:
        raise TypeError(f"bsr_spmm: values must be float32, got "
                        f"{values.dtype}")
    if block_cols.dtype != torch.int32:
        raise TypeError(f"bsr_spmm: block_cols must be int32, got "
                        f"{block_cols.dtype}")
    if values.ndim != 4 or values.shape[2] != BLOCK or \
            values.shape[3] != BLOCK:
        raise ValueError(f"bsr_spmm: values must be [n_rb, S, {BLOCK}, "
                         f"{BLOCK}], got {tuple(values.shape)}")
    n_rb, slots = values.shape[:2]
    if tuple(block_cols.shape) != (n_rb, slots):
        raise ValueError(f"bsr_spmm: block_cols {tuple(block_cols.shape)} "
                         f"does not match values [{n_rb}, {slots}, ...]")
    if x.ndim != 2 or x.shape[0] != n_rb * BLOCK:
        raise ValueError(f"bsr_spmm: x must be [{n_rb * BLOCK}, BT], got "
                         f"{tuple(x.shape)}")
    if n_rb * BLOCK >= 2 ** 31 or x.shape[1] >= 2 ** 31:
        raise ValueError("bsr_spmm: sizes exceed the kernel's int32 range")
    for name, a in (("block_cols", block_cols), ("values", values),
                    ("x", x)):
        if a.device != x.device:
            raise ValueError(f"bsr_spmm: {name} on {a.device}, x on "
                             f"{x.device}")
        if not a.is_contiguous():
            raise ValueError(f"bsr_spmm: {name} must be contiguous")


def _launch(block_cols: torch.Tensor, values: torch.Tensor,
            x: torch.Tensor) -> torch.Tensor:
    global _LAUNCHES
    _check(block_cols, values, x)
    fn = _kernel_fn()
    y = torch.empty_like(x)
    n_rb, slots = values.shape[:2]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(block_cols.data_ptr(), values.data_ptr(), x.data_ptr(),
                 y.data_ptr(), n_rb, slots, x.shape[1], stream)
    if err != 0:
        raise RuntimeError(f"bsr_spmm: kernel launch failed with CUDA error "
                           f"{err}")
    _LAUNCHES += 1
    return y


def bsr_spmm(block_cols: torch.Tensor, values: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """y = P @ x for block-ELL P. x may be [n] or [n, BT]; it is cast to
    float32 as the reference wrapper does.

    On CPU tensors this is the plain version; on CUDA tensors the CUDA
    kernel (B must be 128, inputs contiguous)."""
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    x = x.to(torch.float32)
    if x.device.type == "cuda":
        y = _launch(block_cols, values, x)
    elif x.device.type == "cpu" and values.device.type == "cpu" and \
            block_cols.device.type == "cpu":
        y = bsr_spmm_ref(block_cols, values, x)
    else:
        raise ValueError(f"bsr_spmm: tensors on {block_cols.device}, "
                         f"{values.device}, {x.device}")
    return y[:, 0] if squeeze else y
