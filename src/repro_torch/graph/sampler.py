"""Neighbour sampling for minibatch GNN training (the `minibatch_lg` shape).

A copy of `repro.graph.sampler` for the PyTorch port, which imports
nothing of the JAX package: the same CSR and the same samples for the same
seed (host numpy; nothing here touches a device).

GraphSAGE-style fanout sampling over a host-side CSR, plus the paper-derived
variant: PPR-weighted sampling, where per-node personalized-PageRank mass
(computed once with CPAA) biases neighbour selection toward structurally
important vertices. The sampler is a data-pipeline component: it runs on host
numpy (like any real cluster's input workers) and emits fixed-shape padded
subgraph batches that the train steps consume.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.graph.structure import Graph

__all__ = ["Csr", "build_csr", "NeighborSampler", "SampledBlock"]


@dataclass(frozen=True)
class Csr:
    n: int
    row_ptr: np.ndarray   # [n+1] int64
    col_idx: np.ndarray   # [m] int32


def build_csr(g: Graph) -> Csr:
    order = np.argsort(g.src, kind="stable")
    col = g.dst[order]
    counts = np.bincount(g.src, minlength=g.n)
    row_ptr = np.zeros(g.n + 1, np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    return Csr(n=g.n, row_ptr=row_ptr, col_idx=col.astype(np.int32))


@dataclass(frozen=True)
class SampledBlock:
    """One hop of a sampled computation block (fixed shapes, padded).

    nodes:  [n_dst] destination (seed) node ids for this hop's output
    src:    [n_dst * fanout] sampled source ids (global), padded w/ dst itself
    dst_local: [n_dst * fanout] index into `nodes` each edge aggregates into
    mask:   [n_dst * fanout] 1.0 for real edges, 0.0 padding
    """

    nodes: np.ndarray
    src: np.ndarray
    dst_local: np.ndarray
    mask: np.ndarray


class NeighborSampler:
    """Fanout sampler: fanouts like (15, 10) produce 2 hops of blocks.

    With ppr_weights (a PageRank vector from CPAA), neighbours are sampled
    proportionally to their PPR mass instead of uniformly — the paper's
    technique applied as importance sampling.
    """

    def __init__(self, g: Graph, fanouts: tuple[int, ...],
                 ppr_weights: np.ndarray | None = None, seed: int = 0):
        self.csr = build_csr(g)
        self.fanouts = tuple(fanouts)
        self.rng = np.random.default_rng(seed)
        self.ppr = None
        if ppr_weights is not None:
            self.ppr = np.asarray(ppr_weights, float)

    def _sample_neighbors(self, seeds: np.ndarray, fanout: int) -> SampledBlock:
        rp, ci = self.csr.row_ptr, self.csr.col_idx
        n_dst = seeds.shape[0]
        src = np.repeat(seeds, fanout).astype(np.int32)  # default: self (pad)
        mask = np.zeros(n_dst * fanout, np.float32)
        for i, s in enumerate(seeds):
            beg, end = rp[s], rp[s + 1]
            deg = int(end - beg)
            if deg == 0:
                continue
            k = min(fanout, deg)
            nbrs = ci[beg:end]
            if self.ppr is not None:
                w = self.ppr[nbrs] + 1e-12
                p = w / w.sum()
                pick = self.rng.choice(deg, size=k, replace=False, p=p)
            else:
                pick = self.rng.choice(deg, size=k, replace=False)
            src[i * fanout: i * fanout + k] = nbrs[pick]
            mask[i * fanout: i * fanout + k] = 1.0
        dst_local = np.repeat(np.arange(n_dst, dtype=np.int32), fanout)
        return SampledBlock(nodes=seeds.astype(np.int32), src=src,
                            dst_local=dst_local, mask=mask)

    def sample(self, seeds: np.ndarray) -> list[SampledBlock]:
        """Returns one block per fanout hop, seed-first (top-down)."""
        blocks = []
        cur = np.asarray(seeds, np.int32)
        for f in self.fanouts:
            blk = self._sample_neighbors(cur, f)
            blocks.append(blk)
            cur = np.unique(np.concatenate([blk.nodes, blk.src]))
        return blocks
