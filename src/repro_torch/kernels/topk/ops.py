"""Wrapper for the column top-k kernel (`csrc/topk_columns.cu`).

`topk_columns` ranks every column of a row-major [R, B] array in place:
no transpose, no layout copy, no host read. It replaces the eager
`topk_lower_index_first` passes on every path that ranks PPR mass (the
adaptive and the fixed-round tick, the refresh) and DLRM retrieval's
one-column ranking: the reference's `jax.lax.top_k` at
src/repro/serve/pagerank_service.py:311, :323 and :339 and
src/repro/models/recsys/dlrm.py:129, which has no Pallas kernel. A row map
`ids` names the vertex each row holds, so the adaptive tick ranks the
loop's snapshot in a block-ELL engine's BFS order (`ranking_layout` on the
engines).

A CPU tensor goes to the plain version (`ref.py`); a CUDA tensor launches
the kernel or raises -- there is no fallback on the card, and a k above
128 raises there. The kernel is bound by memory: x read once, the row map
once, the [B, k] outputs written once. The kernel's plan (`plan`, made in
the CUDA source from the shape alone) picks its path: by width, the
narrow path (B < 32) or a wide one, by TMA where x's rows allow it
(16-byte aligned, rows of whole 16-byte pieces) and by cp.async
otherwise; the wrapper reads it for the scratch it allocates and the
path it counts. It counts its launches, in all and by path, and reports
its bytes to `kernels.cost` while a collector is open.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, cost
from repro_torch.kernels.topk.ref import topk_columns_ref

__all__ = ["topk_columns", "launches", "launches_by_path", "reset_launches",
           "plan", "Plan", "PATHS", "MAX_K"]

MAX_K = 128             # the kernel's kMaxK: list entries a warp holds
PATHS = ("narrow", "tma", "cp_async")   # the kernel's modes 0, 1, 2
_COUNTS = dict.fromkeys(("topk",) + PATHS, 0)
_FNS: dict = {}
_F64 = torch.float64    # torchlint: disable=TL003 -- f64 entry for f64 solves
_DTYPES = {torch.float32: "f32", _F64: "f64"}


class Plan(NamedTuple):
    """How the kernel cuts one call: the path, `chunks` blocks for each
    group of 32 columns (one candidate list each per column; they take
    tiles of `stage_rows` rows as they go), `splits` warps sharing a
    column quad of a stage, and the bytes of device scratch it needs."""
    path: str
    chunks: int
    stage_rows: int
    splits: int
    scratch_bytes: int


def launches() -> int:
    """`topk_columns` launches (its kernels count once) since the last
    `reset_launches()`."""
    return _COUNTS["topk"]


def launches_by_path() -> dict:
    """{path: launches} since the last `reset_launches()`."""
    return {p: _COUNTS[p] for p in PATHS}


def reset_launches() -> None:
    """Set the counters to 0."""
    for key in _COUNTS:
        _COUNTS[key] = 0


def _c_function(name: str, argtypes: list, restype=ctypes.c_int):
    """The C function `name` of the topk_columns library, bound once."""
    if name not in _FNS:
        fn = getattr(_build.library("topk_columns"), name)
        fn.argtypes = argtypes
        fn.restype = restype
        _FNS[name] = fn
    return _FNS[name]


def plan(n_valid: int, cols: int, k: int, itemsize: int,
         aligned: bool) -> Plan:
    """The kernel's plan for the top k of n_valid rows of [*, cols]
    elements of `itemsize` bytes whose base is 16-byte aligned or not:
    `topk_columns_plan` of the CUDA source (which builds the library).
    Raises ValueError for a shape the kernel does not take."""
    fn = _c_function("topk_columns_plan",
                     [ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                      ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    out = (ctypes.c_int64 * 5)()
    if fn(n_valid, cols, k, itemsize, int(aligned), out) != 0:
        raise ValueError(f"topk_columns: no plan for {n_valid} rows of "
                         f"{cols} columns, k {k}, {itemsize}-byte elements")
    return Plan(PATHS[out[0]], *out[1:])


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
    size = x.element_size()
    pl = plan(n_valid, cols, k, size, x.data_ptr() % 16 == 0)
    fn = _c_function(f"topk_columns_{_DTYPES[x.dtype]}",
                     [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                      ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_int64] + [ctypes.c_void_p] * 3)
    # the column bounds, tile counters and the blocks' candidates, laid
    # out by the kernel
    scratch = torch.empty(pl.scratch_bytes, dtype=torch.uint8,
                          device=x.device)
    out_v = torch.empty((cols, k), dtype=x.dtype, device=x.device)
    out_i = torch.empty((cols, k), dtype=torch.int32, device=x.device)
    args = (x.data_ptr(), 0 if ids is None else ids.data_ptr(), n_valid,
            cols, k, scratch.data_ptr(), pl.scratch_bytes,
            out_v.data_ptr(), out_i.data_ptr())
    # the launch goes to x's device (entering a device context costs more
    # host time than the kernels of a small call)
    if x.device.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(x.device):
            err = fn(*args, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"topk_columns: kernel launch failed with CUDA "
                           f"error {err} ({pl})")
    _COUNTS["topk"] += 1
    _COUNTS[pl.path] += 1
    if cost.active():
        # x's ranked rows and the row map read once, the outputs written
        # once; one comparison an element
        cost.report("topk_columns", lambda: (
            n_valid * cols,
            n_valid * cols * size
            + (0 if ids is None else 4 * n_valid)
            + cols * k * (size + 4)))
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
