"""Wrapper for the block-ELL SpMM kernel (`csrc/bsr_spmm.cu`).

Replaces `repro.kernels.bsr_spmm.ops.bsr_spmm`, whose Pallas kernel is
`bsr_spmm_pallas` in src/repro/kernels/bsr_spmm/bsr_spmm.py. A CPU tensor
goes to the plain version (`ref.py`); a CUDA tensor launches the CUDA
kernel or raises -- there is no fallback on the card.

The kernel has two variants, chosen by the width BT of x (`variant`): from
BT = 2 up, a 3xTF32 tensor-core product (`wgmma` fed by a TMA ring), held
to the same 1e-5 parity as IEEE f32; at BT = 1 (SpMV), IEEE-f32 FFMA. At
narrow widths both are bound by the bytes of the tiles, and on the H100
FFMA was the faster at BT = 1 only (PERF.md). This is a dispatch by shape,
not a fallback: a failed build or launch raises. The tensor-core variant
loads x by TMA, which needs rows of a multiple of 4 floats at a 16-byte
aligned base; any other x is first copied, zero-padded, into such a
buffer (`_tma_ready`). See the source for the design.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bsr_spmm.ref import bsr_spmm_ref

__all__ = ["bsr_spmm", "bsr_spmm_as", "BLOCK", "TC_MIN_BT", "VARIANTS",
           "variant", "launches", "launches_by_variant", "reset_launches"]

BLOCK = 128   # the only tile edge the CUDA kernel takes
TC_MIN_BT = 2   # the narrowest x on the tensor cores
VARIANTS = ("ffma", "wgmma_3xtf32")

_LAUNCHES = dict.fromkeys(VARIANTS, 0)
_FN = None


def variant(bt: int) -> str:
    """The kernel variant that x of width `bt` launches."""
    return "wgmma_3xtf32" if bt >= TC_MIN_BT else "ffma"


def launches() -> int:
    """Kernel launches (both variants) since the last `reset_launches()`."""
    return sum(_LAUNCHES.values())


def launches_by_variant() -> dict[str, int]:
    """{variant: launches} since the last `reset_launches()`."""
    return dict(_LAUNCHES)


def reset_launches() -> None:
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0


def _kernel_fn():
    global _FN
    if _FN is None:
        fn = _build.library("bsr_spmm").bsr_spmm_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + \
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
    if n_rb * slots * BLOCK >= 2 ** 31 or x.shape[1] >= 2 ** 31:
        raise ValueError("bsr_spmm: sizes exceed the kernel's int32 range")
    for name, a in (("block_cols", block_cols), ("values", values),
                    ("x", x)):
        if a.device != x.device:
            raise ValueError(f"bsr_spmm: {name} on {a.device}, x on "
                             f"{x.device}")
        if not a.is_contiguous():
            raise ValueError(f"bsr_spmm: {name} must be contiguous")


def _tma_ready(x: torch.Tensor) -> torch.Tensor:
    """x itself when TMA can load its rows (width a multiple of 4, base
    16-byte aligned), else a zero-padded copy of width rounded up to 4 in a
    new (aligned) buffer."""
    bt = x.shape[1]
    if bt % 4 == 0 and x.data_ptr() % 16 == 0:
        return x
    xp = x.new_zeros(x.shape[0], -(-bt // 4) * 4)
    xp[:, :bt] = x
    return xp


def _launch(block_cols: torch.Tensor, values: torch.Tensor,
            x: torch.Tensor, kind: str) -> torch.Tensor:
    _check(block_cols, values, x)
    if kind not in _LAUNCHES:
        raise ValueError(f"bsr_spmm: no variant {kind!r}; one of {VARIANTS}")
    fn = _kernel_fn()
    tensor_cores = kind == "wgmma_3xtf32"
    bt = x.shape[1]
    xk = _tma_ready(x) if tensor_cores else x
    y = torch.empty_like(xk)
    n_rb, slots = values.shape[:2]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(block_cols.data_ptr(), values.data_ptr(), xk.data_ptr(),
                 y.data_ptr(), n_rb, slots, xk.shape[1], int(tensor_cores),
                 stream)
    if err != 0:
        raise RuntimeError(f"bsr_spmm: kernel launch failed with CUDA error "
                           f"{err}")
    _LAUNCHES[kind] += 1
    return y if xk is x else y[:, :bt].contiguous()


def bsr_spmm(block_cols: torch.Tensor, values: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """y = P @ x for block-ELL P. x may be [n] or [n, BT]; it is cast to
    float32 as the reference wrapper does.

    On CPU tensors this is the plain version; on CUDA tensors the CUDA
    kernel (B must be 128, inputs contiguous), in the variant `variant`
    names for x's width."""
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    x = x.to(torch.float32)
    if x.device.type == "cuda":
        y = _launch(block_cols, values, x, variant(x.shape[1]))
    elif x.device.type == "cpu" and values.device.type == "cpu" and \
            block_cols.device.type == "cpu":
        y = bsr_spmm_ref(block_cols, values, x)
    else:
        raise ValueError(f"bsr_spmm: tensors on {block_cols.device}, "
                         f"{values.device}, {x.device}")
    return y[:, 0] if squeeze else y


def bsr_spmm_as(block_cols: torch.Tensor, values: torch.Tensor,
                x: torch.Tensor, kind: str) -> torch.Tensor:
    """The CUDA kernel on [n, BT] float32 x on the card through the variant
    `kind` (one of VARIANTS) whatever the width: for comparing the two
    variants at one width. Counts as a launch of that variant."""
    if x.device.type != "cuda":
        raise ValueError("bsr_spmm_as: x must be on a CUDA device")
    return _launch(block_cols, values, x, kind)
