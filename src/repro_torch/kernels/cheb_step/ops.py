"""Wrapper for the fused Chebyshev-update kernel (`csrc/cheb_step.cu`).

Replaces `repro.kernels.cheb_step.ops.cheb_step`, whose Pallas kernel is
`cheb_step_pallas` in src/repro/kernels/cheb_step/cheb_step.py. A CPU
tensor goes to the plain version (`ref.py`); a CUDA tensor launches the
CUDA kernel or raises -- there is no fallback on the card. The kernel is
bound by memory: 3 reads + 2 writes of the operand, one elementwise pass.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, cost
from repro_torch.kernels.cheb_step.ref import cheb_step_ref

__all__ = ["cheb_step", "launches", "reset_launches"]

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
        fn = _build.library("cheb_step").cheb_step_f32
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _check(y, t, acc, ck) -> None:
    """Raise on anything the CUDA kernel does not take."""
    for name, a in (("y", y), ("t", t), ("acc", acc)):
        if a.dtype != torch.float32:
            raise TypeError(f"cheb_step: {name} must be float32, got "
                            f"{a.dtype}")
        if a.shape != y.shape:
            raise ValueError(f"cheb_step: {name} {tuple(a.shape)} != y "
                             f"{tuple(y.shape)}")
        if a.device != y.device:
            raise ValueError(f"cheb_step: {name} on {a.device}, y on "
                             f"{y.device}")
        if not a.is_contiguous():
            raise ValueError(f"cheb_step: {name} must be contiguous")
    if y.ndim not in (1, 2):
        raise ValueError(f"cheb_step: takes [n] or [n, B], got "
                         f"{tuple(y.shape)}")
    if ck.dtype != torch.float32 or ck.numel() != 1 or ck.device != y.device:
        raise ValueError("cheb_step: ck must be one float32 on y's device")


def _launch(y, t, acc, ck):
    global _LAUNCHES
    _check(y, t, acc, ck)
    fn = _kernel_fn()
    t_out = torch.empty_like(y)
    acc_out = torch.empty_like(y)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = fn(y.data_ptr(), t.data_ptr(), acc.data_ptr(), ck.data_ptr(),
                 t_out.data_ptr(), acc_out.data_ptr(), y.numel(), stream)
    if err != 0:
        raise RuntimeError(f"cheb_step: kernel launch failed with CUDA error "
                           f"{err}")
    _LAUNCHES += 1
    if cost.active():
        cost.report("cheb_step", lambda: (3 * y.numel(),
                                          5 * 4 * y.numel() + 4))
    return t_out, acc_out


def cheb_step(y: torch.Tensor, t: torch.Tensor, acc: torch.Tensor, ck):
    """Fused t'' = 2y - t; acc' = acc + ck * t''. Accepts [n] or [n, B].

    ck is a float32 scalar: a Python number or a one-element tensor. On
    CUDA the kernel reads it through a device pointer, so a device-resident
    ck (the adaptive solver's, or a view of the coefficient vector) costs
    no host sync."""
    ck = torch.as_tensor(ck, dtype=torch.float32, device=y.device)
    if y.device.type == "cuda":
        return _launch(y, t, acc, ck)
    if y.device.type == "cpu" and t.device.type == "cpu" and \
            acc.device.type == "cpu":
        return cheb_step_ref(y, t, acc, ck.reshape(()))
    raise ValueError(f"cheb_step: tensors on {y.device}, {t.device}, "
                     f"{acc.device}")
