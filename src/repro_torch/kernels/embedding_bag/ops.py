"""Wrappers for the embedding-bag kernels: the lookup
(`csrc/embedding_bag.cu`) and its table gradient
(`csrc/embedding_bag_backward.cu`), joined by a `torch.autograd.Function`.

The lookup replaces `repro.kernels.embedding_bag.ops.embedding_bag`, whose
Pallas kernel is `embedding_bag_pallas` in
src/repro/kernels/embedding_bag/embedding_bag.py; the reference's gradient
is that of `jnp.take`, a dense scatter-add, which the backward kernel
computes. A CPU tensor goes to the plain versions (`ref.py`); a CUDA
tensor launches the CUDA kernel or raises -- there is no fallback on the
card. Both kernels are bound by memory: the lookup by the random row
reads and the one write of each output row, the backward by the read of
the output gradient and the one write of each touched row. Each has its
own launch counter and reports its FLOPs and those bytes to
`kernels.cost` while a collector is open.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, cost
from repro_torch.kernels.embedding_bag.ref import (embedding_bag_backward_ref,
                                                   embedding_bag_ref)

__all__ = ["embedding_bag", "embedding_bag_backward", "backward_plan",
           "launches", "backward_launches", "reset_launches"]

# The backward kernel's chunk plan (csrc/embedding_bag_backward.cu): one
# warp per chunk of sorted entries, each chunk at least TILE entries (the
# kernel's kTile, staged in shared memory per warp) and no more chunks than
# CHUNKS, one wave of resident warps on an H100 (132 SMs x 4 blocks of 8
# warps, the kernel's launch bounds), so no warp waits for a second wave.
TILE = 256
CHUNKS = 132 * 4 * 8

_LAUNCHES = 0
_BWD_LAUNCHES = 0
_FN = None
_BWD_FN = None


def launches() -> int:
    """Lookup kernel launches since the last `reset_launches()`."""
    return _LAUNCHES


def backward_launches() -> int:
    """Backward kernel launches since the last `reset_launches()` (one per
    call: its two passes count once)."""
    return _BWD_LAUNCHES


def reset_launches() -> None:
    """Set both counters to 0."""
    global _LAUNCHES, _BWD_LAUNCHES
    _LAUNCHES = _BWD_LAUNCHES = 0


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
    if cost.active():
        cost.report("embedding_bag", lambda: _lookup_cost(ids, out))
    return out


def _distinct(ids: torch.Tensor) -> int:
    return int(torch.unique(ids).numel())


def _lookup_cost(ids: torch.Tensor, out: torch.Tensor) -> tuple[int, int]:
    """(flops, bytes) of one lookup: 2 per id and column; each distinct
    row read once, the ids read and the output written once."""
    dim = out.shape[1]
    return (2 * ids.numel() * dim,
            4 * _distinct(ids) * dim + 4 * (out.numel() + ids.numel()))


def _backward_cost(ids: torch.Tensor, dim: int) -> tuple[int, int]:
    """(flops, bytes) of one backward: 2 per id and column; grad_out and
    the ids read once, each touched row written once."""
    n = ids.numel()
    return 2 * n * dim, 4 * n * dim + 4 * n + 4 * _distinct(ids) * dim


def _bwd_fn():
    global _BWD_FN
    if _BWD_FN is None:
        lib = _build.library("embedding_bag_backward")
        fn = lib.embedding_bag_backward_f32
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int64] * 4 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _BWD_FN = fn
    return _BWD_FN


def backward_plan(n: int) -> tuple[int, int]:
    """(chunk, n_chunks) of the backward kernel for n sorted entries: the
    shortest chunk of at least TILE entries that cuts n into at most CHUNKS
    chunks, and the count of chunks. The kernel's sums run in an order
    fixed by the sorted ids and this plan, which depends on n alone."""
    chunk = max(TILE, -(-n // CHUNKS))
    return chunk, -(-n // chunk)


def _launch_backward(ids: torch.Tensor, grad_out: torch.Tensor,
                     grad: torch.Tensor,
                     weights: torch.Tensor | None) -> torch.Tensor:
    """Write every row of grad [V, D] that `ids` touch (the other rows are
    left as they are: the caller zero-fills them) and return grad."""
    global _BWD_LAUNCHES
    _check(ids, grad, weights)
    if grad_out.dtype != torch.float32 or grad_out.device != grad.device \
            or not grad_out.is_contiguous() or \
            tuple(grad_out.shape) != (ids.shape[0], grad.shape[1]):
        raise ValueError(f"embedding_bag backward: grad_out must be "
                         f"contiguous float32 {(ids.shape[0], grad.shape[1])}"
                         f" on {grad.device}, got {grad_out.dtype} "
                         f"{tuple(grad_out.shape)} on {grad_out.device}")
    n, dim = ids.numel(), grad.shape[1]
    if n == 0 or dim == 0:
        return grad
    fn = _bwd_fn()
    # index preparation: the entries of one id, in position order
    sorted_ids, perm = torch.sort(ids.reshape(-1), stable=True)
    chunk, n_chunks = backward_plan(n)
    # each chunk's head and tail partials: [2, n_chunks, D]
    head, tail = torch.empty((2, n_chunks, dim), dtype=torch.float32,
                             device=grad.device)
    with torch.cuda.device(grad.device):
        stream = torch.cuda.current_stream(grad.device).cuda_stream
        err = fn(sorted_ids.data_ptr(), perm.data_ptr(),
                 None if weights is None else weights.data_ptr(),
                 grad_out.data_ptr(), grad.data_ptr(), head.data_ptr(),
                 tail.data_ptr(), n, chunk, ids.shape[1], dim, stream)
    if err != 0:
        raise RuntimeError(f"embedding_bag backward: kernel launch failed "
                           f"with CUDA error {err}")
    _BWD_LAUNCHES += 1
    if cost.active():
        cost.report("embedding_bag_backward",
                    lambda: _backward_cost(ids, dim))
    return grad


def _on_cpu(*ts) -> bool:
    return all(t is None or t.device.type == "cpu" for t in ts)


def embedding_bag_backward(ids: torch.Tensor, grad_out: torch.Tensor,
                           n_rows: int,
                           weights: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """The lookup's table gradient: grad[ids[b, l]] += w[b, l] *
    grad_out[b] into a dense float32 [n_rows, D] (zero where no id lands;
    duplicates within and across bags accumulate). On CPU tensors the
    plain `index_add_`; on CUDA tensors the sorted-segment kernel, whose
    sums run in a fixed order (deterministic)."""
    ids = ids.to(torch.int32)
    if weights is not None:
        weights = weights.to(torch.float32)
    if grad_out.device.type == "cuda":
        grad = torch.zeros((n_rows, grad_out.shape[1]), dtype=torch.float32,
                           device=grad_out.device)
        return _launch_backward(ids.contiguous(), grad_out.contiguous(),
                                grad, weights)
    if _on_cpu(ids, grad_out, weights):
        return embedding_bag_backward_ref(ids, grad_out.to(torch.float32),
                                          n_rows, weights)
    raise ValueError(f"embedding_bag backward: tensors on {ids.device}, "
                     f"{grad_out.device}")


class _EmbeddingBag(torch.autograd.Function):
    """Forward: the lookup; backward: its table gradient (the backward
    kernel on the card) and, when asked for, the weights' gradient
    table[ids[b, l]] . grad_out[b] in torch ops (DLRM never asks)."""

    @staticmethod
    def forward(ctx, ids, table, weights):
        ctx.save_for_backward(ids, table, weights)
        if table.device.type == "cuda":
            return _launch(ids, table, weights)
        return embedding_bag_ref(ids, table.to(torch.float32), weights)

    @staticmethod
    def backward(ctx, g):
        ids, table, weights = ctx.saved_tensors
        g_table = g_weights = None
        if ctx.needs_input_grad[1]:
            g_table = embedding_bag_backward(ids, g, table.shape[0],
                                             weights).to(table.dtype)
        if ctx.needs_input_grad[2]:
            rows = table.index_select(0, ids.reshape(-1).long()).reshape(
                *ids.shape, -1).to(g.dtype)
            g_weights = (rows * g[:, None, :]).sum(-1)
        return None, g_table, g_weights


def embedding_bag(ids: torch.Tensor, table: torch.Tensor,
                  weights: torch.Tensor | None = None) -> torch.Tensor:
    """Bag-sum lookup: out[b] = sum_l w[b, l] * table[ids[b, l]] -> [B, D]
    float32, differentiable in table (and weights).

    ids [B, L] are cast to int32 and weights [B, L] to float32, as the
    reference wrapper does; weights default to ones (the plain multi-hot
    sum, the DLRM case). Duplicate ids accumulate. ids must lie in [0, V):
    the CUDA path does not check them (that would cost a host sync).

    On CPU tensors this is the plain version; on CUDA tensors the CUDA
    kernel (table float32 [V, D], all inputs contiguous), which reads unit
    weights without materializing them. The gradient w.r.t. the table is
    dense, as `jnp.take`'s is in the reference: `embedding_bag_backward`."""
    ids = ids.to(torch.int32)
    if weights is not None:
        weights = weights.to(torch.float32)
    if table.device.type == "cuda" or _on_cpu(ids, table, weights):
        return _EmbeddingBag.apply(ids, table, weights)
    raise ValueError(f"embedding_bag: tensors on {ids.device}, "
                     f"{table.device}"
                     + ("" if weights is None else f", {weights.device}"))
