"""Wrapper for the column top-k kernel (`csrc/topk_columns.cu`).

`topk_columns` ranks every column of a row-major [R, B] array in place:
no transpose, no layout copy, no host read. It replaces the eager
`topk_lower_index_first` passes over pi.T on every path that ranks PPR
mass (the adaptive and the fixed-round tick, the refresh): the
reference's `jax.lax.top_k` at src/repro/serve/pagerank_service.py:311,
:323 and :339, which has no Pallas kernel. A row map `ids` names the
vertex each row holds, so the adaptive tick ranks the loop's snapshot in
a block-ELL engine's BFS order (`ranking_layout` on the engines).

A CPU tensor goes to the plain version (`ref.py`); a CUDA tensor launches
the kernel or raises -- there is no fallback on the card, and a k above
128 raises there. The kernel is bound by memory: x read once, the row map
once, the [B, k] outputs written once. It counts its launches and reports
its bytes to `kernels.cost` while a collector is open.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, cost
from repro_torch.kernels.topk.ref import topk_columns_ref

__all__ = ["topk_columns", "launches", "reset_launches", "MAX_K"]

MAX_K = 128             # the kernel's kMaxK: list entries a warp holds
_COUNTS = {"topk": 0}
_FNS: dict = {}
_F64 = torch.float64    # torchlint: disable=TL003 -- f64 entry for f64 solves
_DTYPES = {torch.float32: "f32", _F64: "f64"}


def launches() -> int:
    """`topk_columns` launches (its two kernels count once) since the last
    `reset_launches()`."""
    return _COUNTS["topk"]


def reset_launches() -> None:
    """Set the counter to 0."""
    _COUNTS["topk"] = 0


def _c_function(name: str, argtypes: list, restype=ctypes.c_int):
    """The C function `name` of the topk_columns library, bound once."""
    if name not in _FNS:
        fn = getattr(_build.library("topk_columns"), name)
        fn.argtypes = argtypes
        fn.restype = restype
        _FNS[name] = fn
    return _FNS[name]


def _check(x, k: int, n_valid: int, ids) -> None:
    """Raise on anything the CUDA kernel does not take."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"topk_columns: takes float32 or float64, got "
                        f"{x.dtype}")
    if x.ndim != 2:
        raise ValueError(f"topk_columns: takes [R, B], got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("topk_columns: x must be contiguous")
    if not 1 <= n_valid <= min(x.shape[0], 2 ** 31 - 1):
        raise ValueError(f"topk_columns: n_valid {n_valid} outside "
                         f"[1, {x.shape[0]}]")
    if not 1 <= k <= min(MAX_K, n_valid):
        raise ValueError(f"topk_columns: k {k} outside [1, min({MAX_K}, "
                         f"n_valid {n_valid})] on the card")
    if x.shape[1] < 1:
        raise ValueError("topk_columns: x has no column")
    if ids is not None and (ids.dtype != torch.int32
                            or ids.shape != (n_valid,)
                            or ids.device != x.device
                            or not ids.is_contiguous()):
        raise ValueError(f"topk_columns: ids must be a contiguous int32 "
                         f"[{n_valid}] on {x.device}, got {ids.dtype} "
                         f"{tuple(ids.shape)} on {ids.device}")


def _launch(x, k: int, n_valid: int, ids):
    _check(x, k, n_valid, ids)
    cols = x.shape[1]
    kind = _DTYPES[x.dtype]
    chunks = _c_function("topk_columns_chunks", [ctypes.c_int64],
                         ctypes.c_int64)(n_valid)
    fn = _c_function(f"topk_columns_{kind}",
                     [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                      ctypes.c_int64, ctypes.c_int] + [ctypes.c_void_p] * 6)
    # the column bounds the chunks share (zeroed by the kernel's launch)
    bound = torch.empty(cols, dtype=torch.int64, device=x.device)
    cand_v = torch.empty((chunks, cols, k), dtype=x.dtype, device=x.device)
    cand_i = torch.empty((chunks, cols, k), dtype=torch.int32,
                         device=x.device)
    out_v = torch.empty((cols, k), dtype=x.dtype, device=x.device)
    out_i = torch.empty((cols, k), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), 0 if ids is None else ids.data_ptr(),
                 n_valid, cols, k, bound.data_ptr(), cand_v.data_ptr(),
                 cand_i.data_ptr(), out_v.data_ptr(), out_i.data_ptr(),
                 stream)
    if err != 0:
        raise RuntimeError(f"topk_columns: kernel launch failed with CUDA "
                           f"error {err}")
    _COUNTS["topk"] += 1
    if cost.active():
        # x's ranked rows and the row map read once, the outputs written
        # once; one comparison an element
        cost.report("topk_columns", lambda: (
            n_valid * cols,
            n_valid * cols * x.element_size()
            + (0 if ids is None else 4 * n_valid)
            + cols * k * (x.element_size() + 4)))
    return out_i, out_v


def topk_columns(x: torch.Tensor, k: int, n_valid: int | None = None,
                 ids: torch.Tensor | None = None):
    """The ranked top-k of each column of x [R, B] over its first n_valid
    rows (None = all R) -> ([B, k] int32 vertex ids, [B, k] values), best
    first: larger value first, then the lower vertex id (`lax.top_k`'s
    rule), where row r holds vertex ids[r] -- an int32 [n_valid]
    permutation of 0..n_valid-1 -- or vertex r without a map. +0.0 and
    -0.0 compare equal and come out as +0.0.

    On the card x is float32 or float64 and contiguous, k <= 128; the
    result is the plain version's, bit for bit, and nothing is read back
    to the host."""
    n_valid = x.shape[0] if n_valid is None else int(n_valid)
    on = {x.device.type} | ({ids.device.type} if ids is not None else set())
    if on == {"cuda"}:
        return _launch(x, int(k), n_valid, ids)
    if on == {"cpu"}:
        return topk_columns_ref(x, k, n_valid, ids)
    raise ValueError(f"topk_columns: tensors on "
                     f"{sorted(on)}; takes cuda or cpu")
