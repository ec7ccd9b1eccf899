"""Wrappers for the Chebyshev-update kernels.

* `cheb_step` (`csrc/cheb_step.cu`) replaces
  `repro.kernels.cheb_step.ops.cheb_step`, whose Pallas kernel is
  `cheb_step_pallas` in src/repro/kernels/cheb_step/cheb_step.py: the
  round of `cpaa_fixed`, the tuner and the paper's fixed-round solves.
* `cheb_step_masked` (`csrc/cheb_step_masked.cu`) is the round of the
  adaptive loop (`core.pagerank.cpaa_adaptive_fixed`): the same update
  for the active columns, t'' = 0 for the frozen ones, written in place.
  It replaces the jnp.where passes around the reference's Pallas
  cheb_step (src/repro/core/pagerank.py:224-230).
* `cheb_residual` (`csrc/cheb_residual.cu`) is that loop's chunk
  residual: column sums, the normalized accumulator, its L1 distance to
  the last snapshot, the new snapshot in place (the reference's XLA
  reductions at src/repro/core/pagerank.py:195-197, :233-234).

A CPU tensor goes to the plain version (`ref.py`); a CUDA tensor launches
the CUDA kernel or raises -- there is no fallback on the card. The
kernels are bound by memory: `cheb_step` 3 reads + 2 writes of the
operand, `cheb_step_masked` the same for an active column and one write
for a frozen one, `cheb_residual` 3 passes (acc and the snapshot read,
the snapshot written) plus a second read of acc for the column sums.
Each has its own launch counter; `reset_launches` zeroes all three.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, cost
from repro_torch.kernels.cheb_step.ref import (cheb_residual_ref,
                                               cheb_step_masked_ref,
                                               cheb_step_ref)

__all__ = ["cheb_step", "cheb_step_masked", "cheb_residual", "launches",
           "masked_launches", "residual_launches", "reset_launches"]

_COUNTS = {"step": 0, "masked": 0, "residual": 0}
_FNS: dict = {}
# the element types of the masked round and the residual: f32, and f64
# for a float64 solve (`GraphRegistry(dtype=torch.float64)` runs the
# adaptive loop in f64); the residual's partial sums are f64 for both
_F64 = torch.float64    # torchlint: disable=TL003 -- f64 entry, f64 sums
_DTYPES = {torch.float32: "f32", _F64: "f64"}


def launches() -> int:
    """`cheb_step` launches since the last `reset_launches()`."""
    return _COUNTS["step"]


def masked_launches() -> int:
    """`cheb_step_masked` launches since the last `reset_launches()`."""
    return _COUNTS["masked"]


def residual_launches() -> int:
    """`cheb_residual` launches (its four kernels count once)."""
    return _COUNTS["residual"]


def reset_launches() -> None:
    """Set every counter to 0."""
    for k in _COUNTS:
        _COUNTS[k] = 0


def _c_function(lib: str, name: str, argtypes: list,
                restype=ctypes.c_int):
    """The C function `name` of kernel library `lib`, bound once."""
    if name not in _FNS:
        fn = getattr(_build.library(lib), name)
        fn.argtypes = argtypes
        fn.restype = restype
        _FNS[name] = fn
    return _FNS[name]


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
    _check(y, t, acc, ck)
    fn = _c_function("cheb_step", "cheb_step_f32",
                     [ctypes.c_void_p] * 6 + [ctypes.c_int64, ctypes.c_void_p])
    t_out = torch.empty_like(y)
    acc_out = torch.empty_like(y)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = fn(y.data_ptr(), t.data_ptr(), acc.data_ptr(), ck.data_ptr(),
                 t_out.data_ptr(), acc_out.data_ptr(), y.numel(), stream)
    if err != 0:
        raise RuntimeError(f"cheb_step: kernel launch failed with CUDA error "
                           f"{err}")
    _COUNTS["step"] += 1
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


def _cols(x: torch.Tensor) -> int:
    """Columns of an [n] (1) or [n, B] (B) operand."""
    return 1 if x.ndim == 1 else x.shape[1]


def _check_masked(y, t, acc, ck, active) -> None:
    """Raise on anything the masked kernel does not take."""
    if y.dtype not in _DTYPES:
        raise TypeError(f"cheb_step_masked: takes float32 or float64, got "
                        f"{y.dtype}")
    if y.ndim not in (1, 2):
        raise ValueError(f"cheb_step_masked: takes [n] or [n, B], got "
                         f"{tuple(y.shape)}")
    for name, a in (("t", t), ("acc", acc)):
        if a.dtype != y.dtype or a.shape != y.shape:
            raise ValueError(f"cheb_step_masked: {name} {a.dtype} "
                             f"{tuple(a.shape)} != y {y.dtype} "
                             f"{tuple(y.shape)}")
    for name, a in (("y", y), ("t", t), ("acc", acc), ("active", active)):
        if a.device != y.device:
            raise ValueError(f"cheb_step_masked: {name} on {a.device}, y on "
                             f"{y.device}")
        if not a.is_contiguous():
            raise ValueError(f"cheb_step_masked: {name} must be contiguous")
    if active.dtype != torch.bool or \
            active.shape != tuple(y.shape[1:]):
        raise ValueError(f"cheb_step_masked: active must be bool of shape "
                         f"{tuple(y.shape[1:])}, got {active.dtype} "
                         f"{tuple(active.shape)}")
    if ck.dtype != y.dtype or ck.numel() != 1 or ck.device != y.device:
        raise ValueError("cheb_step_masked: ck must be one value of y's "
                         "dtype on y's device")


def _launch_masked(y, t, acc, ck, active):
    _check_masked(y, t, acc, ck, active)
    fn = _c_function("cheb_step_masked",
                     f"cheb_step_masked_{_DTYPES[y.dtype]}",
                     [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 2
                     + [ctypes.c_void_p])
    n, cols = y.numel(), _cols(y)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = fn(y.data_ptr(), t.data_ptr(), acc.data_ptr(), ck.data_ptr(),
                 active.data_ptr(), n, cols, stream)
    if err != 0:
        raise RuntimeError(f"cheb_step_masked: kernel launch failed with "
                           f"CUDA error {err}")
    _COUNTS["masked"] += 1
    if cost.active():
        # every column active: 3 reads + 2 writes, 3 FLOPs an element
        cost.report("cheb_step_masked", lambda: (
            3 * n, 5 * n * y.element_size() + y.element_size() + cols))
    return y, acc


def cheb_step_masked(y: torch.Tensor, t: torch.Tensor, acc: torch.Tensor,
                     ck, active: torch.Tensor):
    """One round of the adaptive loop, in place -> (y, acc):

        active[j]:  t'' = 2y - t;  acc' = acc + ck * t''
        else:       t'' = 0;       acc' = acc (not written)

    with t'' written over y and acc' over acc; t is only read. y, t, acc
    are [n] or [n, B] of one dtype (float32 or float64 on the card);
    `active` is the loop's [B] (or 0-dim) bool convergence mask and ck a
    number or a one-element tensor, both read on the device (no host
    sync). y must be a buffer no one else holds (an engine's fresh
    `apply` output)."""
    ck = torch.as_tensor(ck, dtype=y.dtype, device=y.device)
    on = {a.device.type for a in (y, t, acc, active)}
    if on == {"cuda"}:
        return _launch_masked(y, t, acc, ck, active)
    if on == {"cpu"}:
        return cheb_step_masked_ref(y, t, acc, ck.reshape(()), active)
    raise ValueError(f"cheb_step_masked: tensors on {y.device}, {t.device}, "
                     f"{acc.device}, {active.device}")


def _check_residual(acc, snap) -> None:
    if acc.dtype not in _DTYPES:
        raise TypeError(f"cheb_residual: takes float32 or float64, got "
                        f"{acc.dtype}")
    if acc.ndim not in (1, 2) or acc.shape[0] == 0:
        raise ValueError(f"cheb_residual: takes a non-empty [n] or [n, B], "
                         f"got {tuple(acc.shape)}")
    if snap.dtype != acc.dtype or snap.shape != acc.shape or \
            snap.device != acc.device:
        raise ValueError(f"cheb_residual: snap {snap.dtype} "
                         f"{tuple(snap.shape)} on {snap.device} != acc "
                         f"{acc.dtype} {tuple(acc.shape)} on {acc.device}")
    if not (acc.is_contiguous() and snap.is_contiguous()):
        raise ValueError("cheb_residual: acc and snap must be contiguous")


def _launch_residual(acc, snap, reduce):
    _check_residual(acc, snap)
    kind = _DTYPES[acc.dtype]
    rows, cols = acc.shape[0], _cols(acc)
    blocks = _c_function("cheb_residual", "cheb_residual_partials",
                         [ctypes.c_int64] * 2, ctypes.c_int64)(rows, cols)
    colsum = _c_function("cheb_residual", f"cheb_colsum_{kind}",
                         [ctypes.c_void_p] + [ctypes.c_int64] * 2
                         + [ctypes.c_void_p] * 3)
    resid = _c_function("cheb_residual", f"cheb_residual_{kind}",
                        [ctypes.c_void_p] * 3 + [ctypes.c_double]
                        + [ctypes.c_int64] * 2 + [ctypes.c_void_p] * 3)
    partials = torch.empty(blocks, dtype=_F64, device=acc.device)
    s = torch.empty(acc.shape[1:], dtype=acc.dtype, device=acc.device)
    out = torch.empty_like(s)
    tiny = torch.finfo(acc.dtype).tiny
    with torch.cuda.device(acc.device):
        stream = torch.cuda.current_stream(acc.device).cuda_stream
        err = colsum(acc.data_ptr(), rows, cols, partials.data_ptr(),
                     s.data_ptr(), stream)
        if err == 0:
            s = reduce(s)
            err = resid(acc.data_ptr(), snap.data_ptr(), s.data_ptr(), tiny,
                        rows, cols, partials.data_ptr(), out.data_ptr(),
                        stream)
    if err != 0:
        raise RuntimeError(f"cheb_residual: kernel launch failed with CUDA "
                           f"error {err}")
    _COUNTS["residual"] += 1
    if cost.active():
        # what the kernel moves: acc read twice, snap read and written,
        # the [B] sums and residual; 5 FLOPs an element (add; sub, abs,
        # add, and the divide)
        n = acc.numel()
        cost.report("cheb_residual", lambda: (
            5 * n, (4 * n + 2 * cols) * acc.element_size()))
    return reduce(out)


def cheb_residual(acc: torch.Tensor, snap: torch.Tensor,
                  reduce=None) -> torch.Tensor:
    """The adaptive loop's chunk residual -> resid [] / [B]:

        s = reduce(colsum(acc));  norm = acc / (|s| < tiny ? tiny : s)
        resid = reduce(sum_i |norm - snap|);  snap <- norm (in place)

    tiny is the dtype's smallest normal. `reduce` (None = none) sums a
    column vector over the ranks that together hold the vector (a sharded
    engine's `sum_over_ranks`). On the card both sums are taken in float64
    in a fixed order (the same bits on every call) and rounded once."""
    if acc.device.type == "cpu" and snap.device.type == "cpu":
        return cheb_residual_ref(acc, snap, reduce)
    if acc.device.type == "cuda":
        return _launch_residual(acc, snap, reduce or (lambda x: x))
    raise ValueError(f"cheb_residual: tensors on {acc.device}, "
                     f"{snap.device}")
