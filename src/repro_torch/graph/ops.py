"""Message-passing primitives for the PageRank solve, in PyTorch.

Counterpart of `repro.graph.ops`: the COO transition product y = P x with
P = A D^{-1} is one gather + one multiply + one `index_add_` over the edge
list. The reference leaves this to XLA (`jax.ops.segment_sum`), not to a
Pallas kernel, so the port uses torch ops here. The edge-update helpers
(`EdgeSlots`, `patch_device_graph`), chunked ingestion and the GNN
aggregations come with later slices.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.graph.structure import Graph

__all__ = ["DeviceGraph", "device_graph", "check_int32_range", "spmv",
           "spmm", "as_torch_dtype"]


class DeviceGraph:
    """Device-resident COO graph + precomputed 1/deg (the paper's P).

    `w` is the [m] per-edge weight of P: 1/deg[src] for real edges, 0 for
    the zero-weight padding edges the serving registry appends to keep
    shapes stable across updates. Hand-built graphs may pass w=None and
    fall back to gathering inv_deg[src] per call. `src`/`dst` are int32,
    as in the reference.
    """

    def __init__(self, n: int, src: torch.Tensor, dst: torch.Tensor,
                 inv_deg: torch.Tensor, w: torch.Tensor | None = None):
        self.n = n
        self.src = src
        self.dst = dst
        self.inv_deg = inv_deg
        self.w = w

    @property
    def device(self) -> torch.device:
        return self.src.device


_INT32_MAX = np.iinfo(np.int32).max


def check_int32_range(n: int, nnz: int, what: str = "graph") -> None:
    """Fail loudly where an index would silently wrap in the int32 edge
    arrays (vertex ids and edge slot ids are stored as int32)."""
    if n > _INT32_MAX:
        raise ValueError(
            f"{what}: n={n} exceeds int32 range ({_INT32_MAX}); "
            "vertex ids are stored as int32 device arrays")
    if nnz > _INT32_MAX:
        raise ValueError(
            f"{what}: nnz={nnz} exceeds int32 range ({_INT32_MAX}); "
            "edge slot ids are stored as int32 device arrays")


def as_torch_dtype(dtype) -> torch.dtype:
    """torch.dtype from a torch dtype or its name ("float32", "bfloat16")."""
    if isinstance(dtype, torch.dtype):
        return dtype
    out = getattr(torch, str(dtype), None)
    if not isinstance(out, torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return out


def _to_device(arr: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    """Host->device transfer, converted to `dtype` on the host first."""
    return torch.from_numpy(np.ascontiguousarray(arr)).to(dtype).to(device)


def device_graph(g: Graph, dtype=torch.float32,
                 pad_edges_to: int | None = None, weight_dtype=None,
                 device=None) -> DeviceGraph:
    """Build the device-resident COO graph.

    w = 1/deg[src] is computed exactly in float64 on the host, then cast
    to `weight_dtype` (default `dtype`; bfloat16 halves the weight array
    and the product upcasts before the multiply). `pad_edges_to` appends
    zero-weight (0 -> 0) padding edges. `device` None means CUDA (raises
    without a GPU).
    """
    dev = resolve_device(device)
    dtype = as_torch_dtype(dtype)
    wdtype = dtype if weight_dtype is None else as_torch_dtype(weight_dtype)
    check_int32_range(g.n, g.m if pad_edges_to is None else pad_edges_to,
                      what="device_graph")
    inv_deg = 1.0 / np.maximum(g.deg, 1).astype(float)   # exact host 1/deg
    src, dst, w = g.src, g.dst, inv_deg[g.src]
    if pad_edges_to is not None and pad_edges_to > g.m:
        pad = pad_edges_to - g.m
        zeros = np.zeros(pad, np.int32)
        src = np.concatenate([src, zeros])
        dst = np.concatenate([dst, zeros])
        w = np.concatenate([w, np.zeros(pad)])
    return DeviceGraph(n=g.n, src=_to_device(src, torch.int32, dev),
                       dst=_to_device(dst, torch.int32, dev),
                       inv_deg=_to_device(inv_deg, dtype, dev),
                       w=_to_device(w, wdtype, dev))


def _transition_matmul(dg: DeviceGraph, x: torch.Tensor) -> torch.Tensor:
    """Shared spmv/spmm body: y[dst] += w[e] * x[src] over the edge list.
    Packed (bf16) weights upcast to the solve dtype before the multiply,
    so the accumulation runs at full precision. On CUDA `index_add_` adds
    with atomics, so the order of the sums is not fixed."""
    w = dg.w if dg.w is not None else dg.inv_deg.index_select(0, dg.src)
    if w.dtype != x.dtype:
        w = w.to(x.dtype)
    contrib = x.index_select(0, dg.src) * (w if x.ndim == 1 else w[:, None])
    out = torch.zeros((dg.n,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return out.index_add_(0, dg.dst, contrib)


def spmv(dg: DeviceGraph, x: torch.Tensor) -> torch.Tensor:
    """y = P x with P = A D^{-1}: y[dst] += x[src] / deg[src]. x: [n]."""
    return _transition_matmul(dg, x)


def spmm(dg: DeviceGraph, x: torch.Tensor) -> torch.Tensor:
    """Batched transition: x [n, B] -> P x [n, B] (multi-source PageRank)."""
    return _transition_matmul(dg, x)
