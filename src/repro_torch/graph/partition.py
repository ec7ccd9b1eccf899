"""Edge partitioning for the distributed SpMM: a copy of
`repro.graph.partition` for the PyTorch port, which imports nothing of the
JAX package. The outputs are byte-identical to the reference's.

1D partition: destinations (rows of P) are range-partitioned into D
contiguous chunks of n/D vertices; rank d owns every edge whose dst falls
in chunk d. Each rank all-gathers the full x and computes its local rows.

2D partition: an (R x C) rank grid; nodes are split into R row-chunks and C
col-chunks; rank (r, c) owns edges with dst in chunk r AND src in chunk c.
x is kept sharded by col-chunk (replicated down each grid column); partial
row results are reduce-scattered along the row (over c). Collective volume
per round drops from O(n) per rank (1D all-gather) to O(n/R + n/C).

Edges are padded per rank to the max local count so the stacked arrays are
rectangular. Padding edges point at the last local row slot (global slot
n_pad - 1 of the chunk) with weight 0 and src 0. When n is an exact
multiple of D * lane that slot is a REAL vertex, not a spare: correctness
rests on the zero weight alone (the slot receives x[0] * 0).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.graph.structure import Graph

__all__ = ["Partition1D", "Partition2D", "partition_1d", "partition_2d",
           "col_layout_perm"]


def _round_up(x: int, q: int) -> int:
    return ((x + q - 1) // q) * q


@dataclass(frozen=True)
class Partition1D:
    """Stacked per-rank COO shards. Arrays are [D, E_pad]."""

    n: int               # padded vertex count (multiple of D * lane)
    n_orig: int
    n_dev: int
    src: np.ndarray      # [D, E_pad] int32 (global src id)
    dst_local: np.ndarray  # [D, E_pad] int32 (dst - chunk offset)
    weight: np.ndarray   # [D, E_pad] f32 = 1/deg[src], 0 on padding
    rows_per_dev: int

    @property
    def edges_per_dev(self) -> int:
        return self.src.shape[1]


def partition_1d(g: Graph, n_dev: int, lane: int = 128) -> Partition1D:
    n = _round_up(g.n, n_dev * lane)
    rows = n // n_dev
    deg = np.maximum(np.bincount(g.src, minlength=g.n), 1).astype(float)
    owner = g.dst // rows
    order = np.argsort(owner, kind="stable")
    src, dst, own = g.src[order], g.dst[order], owner[order]
    counts = np.bincount(own, minlength=n_dev)
    e_pad = _round_up(int(counts.max()) if g.m else lane, lane)
    s = np.zeros((n_dev, e_pad), np.int32)
    dl = np.full((n_dev, e_pad), rows - 1, np.int32)  # sacrificial local row
    w = np.zeros((n_dev, e_pad), np.float32)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    for d in range(n_dev):
        k = counts[d]
        sl = slice(starts[d], starts[d] + k)
        s[d, :k] = src[sl]
        dl[d, :k] = dst[sl] - d * rows
        w[d, :k] = 1.0 / deg[src[sl]]
    return Partition1D(n=n, n_orig=g.n, n_dev=n_dev, src=s, dst_local=dl,
                       weight=w, rows_per_dev=rows)


@dataclass(frozen=True)
class Partition2D:
    """Per-grid-cell COO shards for the 2D SpMV. Arrays are [R, C, E_pad].

    Layouts: destinations (rows of P) are range-partitioned into R contiguous
    chunks of `rows` = n/R. The column partition is NESTED: within each row
    chunk, `sub` = rows/C consecutive vertices belong to column group c, so

        col_of(v)   = (v % rows) // sub
        src_local(v) = (v // rows) * sub + (v % rows) % sub

    src_local indexes the vector produced by a reduce-scatter over the
    column group followed by an all-gather over the row group (see
    core/distributed.py), so the round's output layout is its input layout
    with no extra collective.
    """

    n: int
    n_orig: int
    grid: tuple[int, int]          # (R, C)
    src_local: np.ndarray          # [R, C, E_pad] int32 (index into col chunk)
    dst_local: np.ndarray          # [R, C, E_pad] int32 (dst - row-chunk offset)
    weight: np.ndarray             # [R, C, E_pad] f32
    rows_per_chunk: int            # n / R
    cols_per_chunk: int            # n / C
    sub: int                       # n / (R*C)

    @property
    def edges_per_dev(self) -> int:
        return self.src_local.shape[2]


def col_layout_perm(n: int, grid: tuple[int, int]) -> np.ndarray:
    """perm such that stitched-global-output = original_vector[perm]."""
    r_dev, c_dev = grid
    rows = n // r_dev
    sub = rows // c_dev
    blocks = []
    for c in range(c_dev):
        for r in range(r_dev):
            start = r * rows + c * sub
            blocks.append(np.arange(start, start + sub, dtype=np.int64))
    return np.concatenate(blocks)


def partition_2d(g: Graph, grid: tuple[int, int],
                 lane: int = 128) -> Partition2D:
    r_dev, c_dev = grid
    n = _round_up(g.n, r_dev * c_dev * lane)
    rows = n // r_dev
    sub = rows // c_dev
    deg = np.maximum(np.bincount(g.src, minlength=g.n), 1).astype(float)
    col_of_src = (g.src % rows) // sub
    owner = (g.dst // rows) * c_dev + col_of_src
    order = np.argsort(owner, kind="stable")
    src, dst, own = g.src[order], g.dst[order], owner[order]
    counts = np.bincount(own, minlength=r_dev * c_dev)
    e_pad = _round_up(int(counts.max()) if g.m else lane, lane)
    sl_ = np.zeros((r_dev, c_dev, e_pad), np.int32)
    dl_ = np.full((r_dev, c_dev, e_pad), rows - 1, np.int32)
    w_ = np.zeros((r_dev, c_dev, e_pad), np.float32)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    for rr in range(r_dev):
        for cc in range(c_dev):
            d = rr * c_dev + cc
            k = counts[d]
            sl = slice(starts[d], starts[d] + k)
            s = src[sl]
            sl_[rr, cc, :k] = (s // rows) * sub + (s % rows) % sub
            dl_[rr, cc, :k] = dst[sl] - rr * rows
            w_[rr, cc, :k] = 1.0 / deg[s]
    return Partition2D(n=n, n_orig=g.n, grid=tuple(grid), src_local=sl_,
                       dst_local=dl_, weight=w_, rows_per_chunk=rows,
                       cols_per_chunk=n // c_dev, sub=sub)
