"""Graph containers and tile-friendly sparse formats (host numpy).

A copy of `repro.graph.structure` for the PyTorch port, which imports
nothing of the JAX package. Outputs are byte-identical to the reference
(same BFS perm, block_cols and values, the same effective edge deltas).

The paper's datasets are undirected; we store the symmetrized directed edge
list (every undirected edge appears in both directions), so that the
column-stochastic transition P = A D^{-1} is applied with one gather +
segment-sum:  y[dst] += x[src] / deg[src].

Formats:
  * Graph      — COO (src, dst) int32 + degrees. The universal substrate; all
                 message passing (PageRank, GNNs) runs on it via segment ops.
  * BlockEll   — 128x128 block-sparse ELL for the block SpMM kernel: vertices
                 are reordered (BFS) so edges concentrate near the diagonal,
                 the adjacency is tiled, empty tiles dropped, and each
                 row-block keeps a fixed number of column-block slots.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = ["Graph", "BlockEll", "EdgeDelta", "edge_delta", "reorder_bfs",
           "build_block_ell", "block_fill_rate"]


@dataclass(frozen=True)
class Graph:
    """Symmetrized undirected graph in COO form (host numpy, int32)."""

    n: int
    src: np.ndarray  # [m] int32, m counts BOTH directions
    dst: np.ndarray  # [m] int32

    def __post_init__(self):
        # jaxlint: disable=JL001 -- Graph is the host numpy container; asarray
        object.__setattr__(self, "src", np.asarray(self.src, np.int32))
        # jaxlint: disable=JL001 -- normalizes caller input, no device involved
        object.__setattr__(self, "dst", np.asarray(self.dst, np.int32))
        if self.src.shape != self.dst.shape:
            raise ValueError("src/dst shape mismatch")

    @property
    def m(self) -> int:
        return int(self.src.shape[0])

    @property
    def deg(self) -> np.ndarray:
        d = np.bincount(self.src, minlength=self.n).astype(np.int32)
        return d

    @property
    def avg_degree(self) -> float:
        return self.m / max(self.n, 1)

    @staticmethod
    def from_undirected_edges(n: int, u: np.ndarray, v: np.ndarray,
                              add_self_loops_to_isolated: bool = True) -> "Graph":
        """Build from an undirected edge list (each edge listed once).

        Deduplicates, drops self loops, symmetrizes. Isolated vertices get a
        self loop so P stays column-stochastic (the paper assumes d_i > 0 for
        undirected graphs; generators may emit isolated vertices).
        """
        u = np.asarray(u, np.int64)
        v = np.asarray(v, np.int64)
        keep = u != v
        u, v = u[keep], v[keep]
        lo, hi = np.minimum(u, v), np.maximum(u, v)
        key = lo * n + hi
        _, idx = np.unique(key, return_index=True)
        lo, hi = lo[idx], hi[idx]
        src = np.concatenate([lo, hi])
        dst = np.concatenate([hi, lo])
        if add_self_loops_to_isolated:
            d = np.bincount(src, minlength=n)
            iso = np.nonzero(d == 0)[0]
            if iso.size:
                src = np.concatenate([src, iso])
                dst = np.concatenate([dst, iso])
        order = np.lexsort((src, dst))  # sort by dst for locality of scatter
        return Graph(n=n, src=src[order].astype(np.int32), dst=dst[order].astype(np.int32))

    def validate_symmetric(self) -> bool:
        """True iff the directed edge set equals its transpose (paper's premise)."""
        a = set(zip(self.src.tolist(), self.dst.tolist()))
        return all((j, i) in a for (i, j) in a)


@dataclass(frozen=True)
class EdgeDelta:
    """Effective change of one undirected edge-update batch.

    Keys are the canonical undirected encoding lo * n + hi (lo < hi; self
    loops — the isolated-vertex patch — are never part of the key set).
    `inserted` / `deleted` hold only the edges that actually change the set:
    duplicate inserts and deletes of absent edges are filtered out, and an
    edge both deleted and re-inserted in the same batch (delete applies
    first, so it ends up present) cancels entirely. `touched` is the unique
    vertex set incident to any changed edge — the locality handle everything
    downstream keys off: the in-place DeviceGraph patch rewrites only slots
    whose src is touched, and the serving cache drops only entries seeded
    within a hop radius of it.
    """

    n: int
    inserted: np.ndarray   # [i] int64 canonical keys newly present, sorted
    deleted: np.ndarray    # [d] int64 canonical keys removed, sorted
    touched: np.ndarray    # [t] int64 unique vertex ids of changed edges

    @property
    def is_noop(self) -> bool:
        """True iff the batch leaves the edge set bit-identical."""
        return self.inserted.size == 0 and self.deleted.size == 0


def _in_sorted(sorted_arr: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Vectorized membership of q in a sorted array: O(|q| log |arr|)."""
    if sorted_arr.size == 0 or q.size == 0:
        return np.zeros(q.shape, bool)
    pos = np.minimum(np.searchsorted(sorted_arr, q), sorted_arr.size - 1)
    return sorted_arr[pos] == q


def edge_delta(n: int, keys: np.ndarray, insert_keys=(),
               delete_keys=()) -> EdgeDelta:
    """EdgeDelta of (insert, delete) batches against the CURRENT edge set.

    keys: sorted canonical key array of the graph's undirected edges.
    insert_keys / delete_keys: canonical keys of the batch (deduped; order
    free). Deletes apply before inserts, so an edge in both batches ends up
    present. Cost is O(batch log m) — no pass over the full edge set — which
    is what lets a no-op batch be detected (and skipped) without paying the
    O(m log m) host rebuild it would otherwise trigger.
    """
    keys = np.asarray(keys, np.int64)
    ins = np.unique(np.asarray(insert_keys, np.int64))
    dele = np.unique(np.asarray(delete_keys, np.int64))
    inserted = ins[~_in_sorted(keys, ins)]
    # deleted-and-reinserted edges are net no-ops: drop them from `deleted`
    deleted = dele[_in_sorted(keys, dele) & ~_in_sorted(ins, dele)]
    changed = np.concatenate([inserted, deleted])
    touched = np.unique(np.concatenate([changed // n, changed % n]))
    return EdgeDelta(n=n, inserted=inserted, deleted=deleted, touched=touched)


def reorder_bfs(g: Graph, start: int = 0) -> np.ndarray:
    """BFS vertex order (approximate bandwidth reduction, Cuthill-McKee-ish).

    Mesh-like graphs (the paper's datasets) have strong locality; BFS order
    concentrates adjacency nonzeros near the diagonal, which raises the
    fill-rate of 128x128 tiles in BlockEll.
    Returns perm such that new_id = perm_inv[old_id]; i.e. perm[k] = old id at
    position k.
    """
    n = g.n
    deg = g.deg
    # CSR neighbour lists pre-sorted by (row, neighbour degree): each row's
    # adjacency comes out lowest-degree-first, the CM flavour, without any
    # per-vertex argsort inside the traversal.
    order = np.lexsort((deg[g.dst], g.src))
    d_sorted = g.dst[order]
    counts = np.bincount(g.src, minlength=n).astype(np.int64)
    row_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    visited = np.zeros(n, bool)
    perm = np.empty(n, np.int64)
    w = 0
    seeds = np.argsort(deg, kind="stable")  # low-degree seeds first
    seed_i = 0
    while w < n:
        while visited[seeds[seed_i]]:   # amortized O(n) over the whole run
            seed_i += 1
        frontier = seeds[seed_i:seed_i + 1]
        visited[frontier] = True
        while frontier.size:
            perm[w:w + frontier.size] = frontier
            w += frontier.size
            # whole-frontier neighbour expansion as one flat-range gather:
            # positions row_ptr[u] + 0..counts[u]-1 for every u, frontier
            # order preserved (O(level edges), no python per-vertex loop)
            cnt = counts[frontier]
            total = int(cnt.sum())
            if total == 0:
                break
            starts = np.repeat(row_ptr[frontier], cnt)
            offs = np.arange(total) - np.repeat(np.cumsum(cnt) - cnt, cnt)
            nbrs = d_sorted[starts + offs]
            nbrs = nbrs[~visited[nbrs]]
            if nbrs.size == 0:
                break
            # first-occurrence dedup keeps the sequential-BFS claim order:
            # a vertex reachable from several frontier members goes to the
            # earliest (and, per row, lowest-degree-edge) one
            _, first = np.unique(nbrs, return_index=True)
            frontier = nbrs[np.sort(first)]
            visited[frontier] = True
    return perm


@dataclass(frozen=True)
class BlockEll:
    """128x128 block-sparse ELL of the transition matrix P = A D^{-1}.

    Row-block i holds up to S column-block slots; slot s covers columns
    [block_cols[i,s]*B, ...). values[i,s] is the dense BxB tile of P in
    (row-local, col-local) layout; empty slots have block_cols = i (diagonal,
    harmless) and all-zero values, so the kernel needs no masking.
    """

    n: int          # padded vertex count (multiple of block)
    n_orig: int
    block: int
    block_cols: np.ndarray  # [n_rb, S] int32
    values: np.ndarray      # [n_rb, S, B, B] float32
    perm: np.ndarray        # [n_orig] old-id at new position (BFS order)
    fill_rate: float = field(default=0.0)

    @property
    def n_row_blocks(self) -> int:
        return self.block_cols.shape[0]

    @property
    def slots(self) -> int:
        return self.block_cols.shape[1]


def block_fill_rate(g: Graph, block: int = 128,
                    perm: np.ndarray | None = None) -> tuple[float, np.ndarray]:
    """(fill_rate, perm) of the BxB tiling WITHOUT materializing tile values.

    Counting occupied tiles is O(m) on the edge list; the [n_rb, S, B, B]
    values tensor it avoids is the expensive part of `build_block_ell`
    (hundreds of MB for scattered graphs, where S is largest). Engine
    auto-selection probes the fill with this and only builds tiles for
    graphs that clear the threshold; pass the returned perm back to
    `build_block_ell` to reuse the BFS.
    """
    perm = reorder_bfs(g) if perm is None else perm
    inv = np.empty(g.n, np.int64)
    inv[perm] = np.arange(g.n)
    n_rb = (g.n + block - 1) // block
    tiles = np.unique((inv[g.dst] // block) * n_rb + (inv[g.src] // block))
    return g.m / max(len(tiles) * block * block, 1), perm


def build_block_ell(g: Graph, block: int = 128, reorder: bool = True,
                    perm: np.ndarray | None = None) -> BlockEll:
    """Tile P into BxB dense blocks (host-side, numpy). A precomputed BFS
    `perm` (e.g. from `block_fill_rate`) skips the reorder."""
    n_orig = g.n
    if perm is None:
        perm = reorder_bfs(g) if reorder else np.arange(n_orig, dtype=np.int64)
    inv = np.empty(n_orig, np.int64)
    inv[perm] = np.arange(n_orig)
    src = inv[g.src]
    dst = inv[g.dst]
    deg = np.bincount(src, minlength=n_orig).astype(float)
    n = ((n_orig + block - 1) // block) * block
    n_rb = n // block
    rb = dst // block
    cb = src // block
    tile_key = rb * n_rb + cb
    uniq, tile_of_edge = np.unique(tile_key, return_inverse=True)
    u_rb = (uniq // n_rb).astype(np.int64)
    u_cb = (uniq % n_rb).astype(np.int64)
    # slots per row block
    counts = np.bincount(u_rb, minlength=n_rb)
    s_max = int(counts.max()) if counts.size else 1
    block_cols = np.tile(np.arange(n_rb, dtype=np.int32)[:, None], (1, s_max))
    values = np.zeros((n_rb, s_max, block, block), np.float32)
    # slot index for each unique tile within its row block
    order = np.argsort(u_rb, kind="stable")
    slot_of_tile = np.empty(len(uniq), np.int64)
    slot_of_tile[order] = np.arange(len(uniq)) - np.repeat(
        np.concatenate([[0], np.cumsum(counts)[:-1]]), counts)
    block_cols[u_rb, slot_of_tile] = u_cb.astype(np.int32)
    # scatter edge weights 1/deg[src] into tiles; (src, dst) pairs are unique
    # after dedup so each tile cell receives at most one edge -> plain store.
    w = (1.0 / deg[src]).astype(np.float32)
    values[u_rb[tile_of_edge], slot_of_tile[tile_of_edge],
           dst % block, src % block] = w
    nnz_tiles = len(uniq)
    fill = g.m / max(nnz_tiles * block * block, 1)
    return BlockEll(n=n, n_orig=n_orig, block=block, block_cols=block_cols,
                    values=values, perm=perm, fill_rate=float(fill))
