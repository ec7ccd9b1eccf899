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

Window variants. Under the row-sharded layout P("model", None) a rank
holds rows [row_lo, row_lo + n_local) of the table. `embedding_bag_window`
and `embedding_bag_backward_window` take that shard: an id outside the
window adds nothing to the lookup and writes nothing in the backward
(the test is in each kernel's inner loop; `ref.py` has their plain
versions). They launch the same two kernels, instantiated with the test
(`embedding_bag_window_f32`, `embedding_bag_backward_window_f32`), and
count on counters of their own (`window_launches`,
`window_backward_launches`). The whole-table entry points are the window
[0, V), which every id passes: there the kernels are instantiated
without the test, as before they took a window (the same bits).

On meta tensors (the dry-run) nothing is launched or counted: the
wrappers return meta outputs and report the cost the kernel would have,
assuming every id distinct (and, for a window with `n_rows_total` given,
the window's share of them).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, cost
from repro_torch.kernels.embedding_bag.ref import (
    embedding_bag_backward_ref, embedding_bag_backward_window_ref,
    embedding_bag_ref, embedding_bag_window_ref)

__all__ = ["embedding_bag", "embedding_bag_backward", "embedding_bag_window",
           "embedding_bag_backward_window", "backward_plan", "launches",
           "backward_launches", "window_launches",
           "window_backward_launches", "reset_launches"]

# The backward kernel's chunk plan (csrc/embedding_bag_backward.cu): one
# warp per chunk of sorted entries, each chunk at least TILE entries (the
# kernel's kTile, staged in shared memory per warp) and no more chunks than
# CHUNKS, one wave of resident warps on an H100 (132 SMs x 4 blocks of 8
# warps, the kernel's launch bounds), so no warp waits for a second wave.
TILE = 256
CHUNKS = 132 * 4 * 8

# launches since the last reset_launches(), by (kernel, entry point)
_COUNTS = {"lookup": 0, "backward": 0, "lookup_window": 0,
           "backward_window": 0}
_FNS: dict = {}       # (library, window) -> the bound C function


def launches() -> int:
    """Lookup kernel launches of the whole-table entry point since the last
    `reset_launches()`."""
    return _COUNTS["lookup"]


def backward_launches() -> int:
    """Backward kernel launches of the whole-table entry point since the
    last `reset_launches()` (one per call: its two passes count once)."""
    return _COUNTS["backward"]


def window_launches() -> int:
    """Lookup kernel launches of `embedding_bag_window`."""
    return _COUNTS["lookup_window"]


def window_backward_launches() -> int:
    """Backward kernel launches of `embedding_bag_backward_window` (and of
    the window lookup's autograd backward)."""
    return _COUNTS["backward_window"]


def reset_launches() -> None:
    """Set every counter to 0."""
    for k in _COUNTS:
        _COUNTS[k] = 0


def _c_function(lib: str, window: bool, n_ptrs: int, n_ints: int):
    """The C entry point of library `lib` (its window variant, which takes
    row_lo and n_local after the other integers), bound once."""
    key = (lib, window)
    if key not in _FNS:
        fn = getattr(_build.library(lib),
                     lib + ("_window_f32" if window else "_f32"))
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int64] * (
            n_ints + (2 if window else 0)) + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS[key] = fn
    return _FNS[key]


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
            weights: torch.Tensor | None,
            row_lo: int | None = None) -> torch.Tensor:
    """The lookup kernel over the whole table, or (row_lo given) over rows
    [row_lo, row_lo + len(table)) of it, which `table` holds."""
    _check(ids, table, weights)
    n_bags, bag = ids.shape
    out = torch.empty((n_bags, table.shape[1]), dtype=torch.float32,
                      device=table.device)
    if out.numel() == 0:
        return out
    window = row_lo is not None
    fn = _c_function("embedding_bag", window, 4, 3)
    rows = (row_lo, table.shape[0]) if window else ()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = fn(ids.data_ptr(), table.data_ptr(),
                 None if weights is None else weights.data_ptr(),
                 out.data_ptr(), n_bags, bag, table.shape[1], *rows, stream)
    if err != 0:
        raise RuntimeError(f"embedding_bag: kernel launch failed with CUDA "
                           f"error {err}")
    _COUNTS["lookup_window" if window else "lookup"] += 1
    if cost.active():
        cost.report("embedding_bag", lambda: _lookup_cost(
            ids, out, row_lo or 0, table.shape[0] if window else None))
    return out


def _in_window(ids: torch.Tensor, row_lo: int, n_local: int):
    return ids[(ids >= row_lo) & (ids < row_lo + n_local)]


def _distinct(ids: torch.Tensor) -> int:
    return int(torch.unique(ids).numel())


def _lookup_cost(ids: torch.Tensor, out: torch.Tensor, row_lo: int = 0,
                 n_local: int | None = None) -> tuple[int, int]:
    """(flops, bytes) of one lookup: 2 per id and column; each distinct
    row of the window read once, the ids read and the output written
    once."""
    dim = out.shape[1]
    inside = ids if n_local is None else _in_window(ids, row_lo, n_local)
    return (2 * inside.numel() * dim,
            4 * _distinct(inside) * dim + 4 * (out.numel() + ids.numel()))


def _backward_cost(ids: torch.Tensor, dim: int, row_lo: int = 0,
                   n_local: int | None = None) -> tuple[int, int]:
    """(flops, bytes) of one backward: 2 per id and column of the window;
    the ids read once, the grad_out rows of the window's ids read once,
    each touched row of the window written once."""
    inside = ids if n_local is None else _in_window(ids, row_lo, n_local)
    n = inside.numel()
    return 2 * n * dim, 4 * n * dim + 4 * ids.numel() + \
        4 * _distinct(inside) * dim


def _meta_cost(name: str, n_ids: int, dim: int, out_rows: int,
               share: float) -> None:
    """Report a meta call's cost: every id distinct, `share` of them in
    the window."""
    inside = int(round(n_ids * share))
    if name == "embedding_bag":
        cost.report(name, lambda: (2 * inside * dim,
                                   4 * inside * dim
                                   + 4 * (out_rows * dim + n_ids)))
    else:
        cost.report(name, lambda: (2 * inside * dim,
                                   8 * inside * dim + 4 * n_ids))


def backward_plan(n: int) -> tuple[int, int]:
    """(chunk, n_chunks) of the backward kernel for n sorted entries: the
    shortest chunk of at least TILE entries that cuts n into at most CHUNKS
    chunks, and the count of chunks. The kernel's sums run in an order
    fixed by the sorted ids and this plan, which depends on n alone."""
    chunk = max(TILE, -(-n // CHUNKS))
    return chunk, -(-n // chunk)


def _launch_backward(ids: torch.Tensor, grad_out: torch.Tensor,
                     grad: torch.Tensor, weights: torch.Tensor | None,
                     row_lo: int | None = None) -> torch.Tensor:
    """Write every row of grad [V, D] (or, row_lo given, of grad [n_local,
    D], rows [row_lo, row_lo + n_local) of the table's gradient) that
    `ids` touch (the other rows are left as they are: the caller
    zero-fills them) and return grad."""
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
    window = row_lo is not None
    fn = _c_function("embedding_bag_backward", window, 7, 4)
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
                 tail.data_ptr(), n, chunk, ids.shape[1], dim,
                 *((row_lo, grad.shape[0]) if window else ()), stream)
    if err != 0:
        raise RuntimeError(f"embedding_bag backward: kernel launch failed "
                           f"with CUDA error {err}")
    _COUNTS["backward_window" if window else "backward"] += 1
    if cost.active():
        n_local = grad.shape[0] if window else None
        cost.report("embedding_bag_backward",
                    lambda: _backward_cost(ids, dim, row_lo or 0, n_local))
    return grad


def _on_cpu(*ts) -> bool:
    return all(t is None or t.device.type == "cpu" for t in ts)


def _on_meta(*ts) -> bool:
    return all(t is None or t.device.type == "meta" for t in ts)


def _backward(ids, grad_out, n_rows, weights, row_lo, share):
    """The table gradient into [n_rows, D]: the whole table (row_lo None)
    or rows [row_lo, row_lo + n_rows) of it."""
    ids = ids.to(torch.int32)
    if weights is not None:
        weights = weights.to(torch.float32)
    if _on_meta(ids, grad_out, weights):
        if cost.active():
            _meta_cost("embedding_bag_backward", ids.numel(),
                       grad_out.shape[1], n_rows, share)
        return torch.zeros((n_rows, grad_out.shape[1]), dtype=torch.float32,
                           device="meta")
    if grad_out.device.type == "cuda":
        grad = torch.zeros((n_rows, grad_out.shape[1]), dtype=torch.float32,
                           device=grad_out.device)
        return _launch_backward(ids.contiguous(), grad_out.contiguous(),
                                grad, weights, row_lo)
    if _on_cpu(ids, grad_out, weights):
        if row_lo is None:
            return embedding_bag_backward_ref(
                ids, grad_out.to(torch.float32), n_rows, weights)
        return embedding_bag_backward_window_ref(
            ids, grad_out.to(torch.float32), row_lo, n_rows, weights)
    raise ValueError(f"embedding_bag backward: tensors on {ids.device}, "
                     f"{grad_out.device}")


def embedding_bag_backward(ids: torch.Tensor, grad_out: torch.Tensor,
                           n_rows: int,
                           weights: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """The lookup's table gradient: grad[ids[b, l]] += w[b, l] *
    grad_out[b] into a dense float32 [n_rows, D] (zero where no id lands;
    duplicates within and across bags accumulate). On CPU tensors the
    plain `index_add_`; on CUDA tensors the sorted-segment kernel, whose
    sums run in a fixed order (deterministic)."""
    return _backward(ids, grad_out, n_rows, weights, None, 1.0)


def embedding_bag_backward_window(ids: torch.Tensor, grad_out: torch.Tensor,
                                  row_lo: int, n_local: int,
                                  weights: torch.Tensor | None = None,
                                  n_rows_total: int | None = None
                                  ) -> torch.Tensor:
    """`embedding_bag_backward` into rows [row_lo, row_lo + n_local) of the
    table's gradient only: a dense float32 [n_local, D] where an id
    outside the window writes nothing. On CPU tensors the plain version
    (`ref.embedding_bag_backward_window_ref`), on CUDA tensors the
    backward kernel with that window; `n_rows_total` serves only a meta
    call's cost estimate."""
    share = n_local / n_rows_total if n_rows_total else 1.0
    return _backward(ids, grad_out, int(n_local), weights, int(row_lo),
                     share)


class _EmbeddingBag(torch.autograd.Function):
    """Forward: the lookup over the window [row_lo, row_lo + len(table))
    (the whole table: row_lo None); backward: its table gradient (the
    backward kernel on the card) and, when asked for, the weights'
    gradient table[ids[b, l]] . grad_out[b] in torch ops (DLRM never
    asks; whole tables only)."""

    @staticmethod
    def forward(ctx, ids, table, weights, row_lo, share):
        ctx.save_for_backward(ids, table, weights)
        ctx.row_lo, ctx.share = row_lo, share
        if table.device.type == "meta":
            if cost.active():
                _meta_cost("embedding_bag", ids.numel(), table.shape[1],
                           ids.shape[0], share)
            return torch.empty((ids.shape[0], table.shape[1]),
                               dtype=torch.float32, device="meta")
        if table.device.type == "cuda":
            return _launch(ids, table, weights, row_lo)
        if row_lo is not None:
            return embedding_bag_window_ref(ids, table.to(torch.float32),
                                            row_lo, weights)
        return embedding_bag_ref(ids, table.to(torch.float32), weights)

    @staticmethod
    def backward(ctx, g):
        ids, table, weights = ctx.saved_tensors
        g_table = g_weights = None
        if ctx.needs_input_grad[1]:
            g_table = _backward(ids, g, table.shape[0], weights,
                                ctx.row_lo, ctx.share).to(table.dtype)
        if ctx.needs_input_grad[2]:
            rows = table.index_select(0, ids.reshape(-1).long()).reshape(
                *ids.shape, -1).to(g.dtype)
            g_weights = (rows * g[:, None, :]).sum(-1)
        return None, g_table, g_weights, None, None


def _apply(ids, table, weights, row_lo, share):
    ids = ids.to(torch.int32)
    if weights is not None:
        weights = weights.to(torch.float32)
    if table.device.type == "cuda" or _on_cpu(ids, table, weights) or \
            _on_meta(ids, table, weights):
        return _EmbeddingBag.apply(ids, table, weights, row_lo, share)
    raise ValueError(f"embedding_bag: tensors on {ids.device}, "
                     f"{table.device}"
                     + ("" if weights is None else f", {weights.device}"))


def embedding_bag(ids: torch.Tensor, table: torch.Tensor,
                  weights: torch.Tensor | None = None) -> torch.Tensor:
    """Bag-sum lookup: out[b] = sum_l w[b, l] * table[ids[b, l]] -> [B, D]
    float32, differentiable in table (and weights).

    ids [B, L] are cast to int32 and weights [B, L] to float32, as the
    reference wrapper does; weights default to ones (the plain multi-hot
    sum, the DLRM case). Duplicate ids accumulate. ids must lie in [0, V):
    the whole-table kernel does not check them (that would cost a host
    sync), and one outside reads memory past the table. Only
    `embedding_bag_window` skips ids outside its window.

    On CPU tensors this is the plain version; on CUDA tensors the CUDA
    kernel (table float32 [V, D], all inputs contiguous), which reads unit
    weights without materializing them. The gradient w.r.t. the table is
    dense, as `jnp.take`'s is in the reference: `embedding_bag_backward`."""
    return _apply(ids, table, weights, None, 1.0)


def embedding_bag_window(ids: torch.Tensor, table: torch.Tensor,
                         row_lo: int, weights: torch.Tensor | None = None,
                         n_rows_total: int | None = None) -> torch.Tensor:
    """`embedding_bag` over one rank's row shard: `table` [n_local, D]
    holds rows [row_lo, row_lo + n_local) of the whole table, and an id
    outside them adds nothing (a bag of such ids gives 0). Summed over the
    ranks of the shard axis, the outputs are the whole table's lookup.
    Differentiable in table, whose gradient is the window backward
    (`embedding_bag_backward_window`); not in weights. On CPU tensors the
    plain version (`ref.embedding_bag_window_ref`), on CUDA tensors the
    lookup kernel with that window; `n_rows_total` serves only a meta
    call's cost estimate."""
    if weights is not None and weights.requires_grad:
        raise ValueError("embedding_bag_window: weights take no gradient")
    share = table.shape[0] / n_rows_total if n_rows_total else 1.0
    return _apply(ids, table, weights, int(row_lo), share)
