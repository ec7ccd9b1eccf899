"""Deterministic synthetic graph generators (copy of `repro.graph.generators`).

The paper's six datasets are mesh graphs (NACA0015, M6, NLR, CHANNEL),
a Delaunay triangulation (delaunay-n21) and a k-mer de-Bruijn-ish graph
(kmer-V2). We cannot ship those files, so every benchmark runs on synthetic
graphs matched in (n, avg degree, locality class):

  dataset        paper n      paper deg   generator here
  NACA0015       1,039,183    5.99        tri_mesh (2D triangulated grid)
  delaunay-n21   2,097,152    6.0         tri_mesh + jitter diagonals
  M6             3,501,776    6.0         tri_mesh
  NLR            4,163,763    6.0         tri_mesh
  CHANNEL        4,802,000    17.78       grid3d (3D stencil, 18-ish degree)
  kmer-V2        55,042,369   2.13        kmer_chains (unions of paths/cycles)

Benchmarks use scaled-down n (CPU container) but identical degree structure;
the iteration-count results the paper reports are n-independent (they depend
only on c), which is what we validate.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graph.structure import Graph

__all__ = [
    "tri_mesh",
    "grid3d",
    "kmer_chains",
    "powerlaw_ba",
    "erdos_renyi",
    "caveman",
    "molecule_batch",
    "paper_dataset",
    "PAPER_DATASETS",
]


def tri_mesh(rows: int, cols: int, diagonal_jitter: float = 0.0,
             seed: int = 0) -> Graph:
    """Triangulated 2D grid: 4-neighbour lattice + one diagonal per cell.

    Interior degree 6 — matches the paper's aerodynamic meshes (deg ~ 6.0).
    diagonal_jitter > 0 flips a random fraction of the diagonals (delaunay-ish
    irregularity).
    """
    n = rows * cols
    ii, jj = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    vid = (ii * cols + jj).astype(np.int64)
    right_u = vid[:, :-1].ravel(); right_v = vid[:, 1:].ravel()
    down_u = vid[:-1, :].ravel(); down_v = vid[1:, :].ravel()
    # one diagonal per cell: (i,j)-(i+1,j+1) or flipped (i,j+1)-(i+1,j)
    a = vid[:-1, :-1].ravel(); b = vid[1:, 1:].ravel()
    c = vid[:-1, 1:].ravel(); d = vid[1:, :-1].ravel()
    if diagonal_jitter > 0.0:
        rng = np.random.default_rng(seed)
        flip = rng.random(a.shape[0]) < diagonal_jitter
        du = np.where(flip, c, a); dv = np.where(flip, d, b)
    else:
        du, dv = a, b
    u = np.concatenate([right_u, down_u, du])
    v = np.concatenate([right_v, down_v, dv])
    return Graph.from_undirected_edges(n, u, v)


def grid3d(nx: int, ny: int, nz: int, extended: bool = True) -> Graph:
    """3D stencil grid; extended=True adds face diagonals -> interior deg 18
    (CHANNEL analogue, paper deg 17.78)."""
    n = nx * ny * nz
    idx = np.arange(n, dtype=np.int64).reshape(nx, ny, nz)
    us, vs = [], []

    def link(au, av):
        us.append(au.ravel()); vs.append(av.ravel())

    link(idx[:-1, :, :], idx[1:, :, :])
    link(idx[:, :-1, :], idx[:, 1:, :])
    link(idx[:, :, :-1], idx[:, :, 1:])
    if extended:
        link(idx[:-1, :-1, :], idx[1:, 1:, :])
        link(idx[:-1, 1:, :], idx[1:, :-1, :])
        link(idx[:-1, :, :-1], idx[1:, :, 1:])
        link(idx[:-1, :, 1:], idx[1:, :, :-1])
        link(idx[:, :-1, :-1], idx[:, 1:, 1:])
        link(idx[:, :-1, 1:], idx[:, 1:, :-1])
    return Graph.from_undirected_edges(n, np.concatenate(us), np.concatenate(vs))


def kmer_chains(n: int, seed: int = 0) -> Graph:
    """Unions of paths with sparse random shortcuts, avg degree ~ 2.1
    (kmer-V2 analogue: de Bruijn graphs are near-functional, deg 2.13)."""
    rng = np.random.default_rng(seed)
    ids = rng.permutation(n).astype(np.int64)
    u = ids[:-1]; v = ids[1:]
    # break into chains of geometric length by dropping ~2% of links
    keep = rng.random(n - 1) > 0.02
    u, v = u[keep], v[keep]
    n_extra = max(n // 16, 1)  # shortcuts lift deg from 2.0 toward 2.13
    eu = rng.integers(0, n, n_extra); ev = rng.integers(0, n, n_extra)
    return Graph.from_undirected_edges(n, np.concatenate([u, eu]),
                                       np.concatenate([v, ev]))


def powerlaw_ba(n: int, m_attach: int = 3, seed: int = 0) -> Graph:
    """Barabasi-Albert preferential attachment (power-law degrees).

    Vectorized Batagelj-Brandes sampling: conceptually every attachment
    edge appends both endpoints to a flat history array, and picking a
    uniformly random SLOT of that history is exactly degree-proportional
    sampling. All slot picks are drawn up front (each edge j picks in
    [0, L0 + 2j), so only slots that exist when j is placed); a pick that
    lands on a target slot (odd) chases that edge's own pick, and the
    chains — strictly decreasing, geometrically short — are resolved by a
    handful of masked gather passes instead of the old per-vertex python
    loop. Duplicate picks and the rare self loop are normalized away by
    `from_undirected_edges` (the old set-based dedup, same effect), so the
    realized attachment count per vertex is <= m_attach, as before.
    """
    rng = np.random.default_rng(seed)
    n_new = n - m_attach
    if n_new <= 0:
        return Graph.from_undirected_edges(n, np.empty(0, np.int64),
                                           np.empty(0, np.int64))
    m = n_new * m_attach
    j = np.arange(m, dtype=np.int64)
    src = m_attach + j // m_attach
    # history layout: slots [0, L0) seed the initial m_attach vertices once;
    # edge j then owns slots L0+2j (its source) and L0+2j+1 (its target)
    L0 = m_attach
    r = rng.integers(0, L0 + 2 * j)
    p = r.copy()
    while True:
        odd = (p >= L0) & ((p - L0) & 1 == 1)
        if not odd.any():
            break
        p[odd] = r[(p[odd] - L0 - 1) >> 1]
    dst = np.where(p < L0, p, src[np.minimum((p - L0) >> 1, m - 1)])
    return Graph.from_undirected_edges(n, src, dst)


def erdos_renyi(n: int, avg_deg: float, seed: int = 0) -> Graph:
    rng = np.random.default_rng(seed)
    m = int(n * avg_deg / 2)
    u = rng.integers(0, n, m); v = rng.integers(0, n, m)
    return Graph.from_undirected_edges(n, u, v)


def caveman(n_cliques: int, clique: int, seed: int = 0) -> Graph:
    """Connected caveman graph — community structure for locality tests."""
    n = n_cliques * clique
    us = []; vs = []
    for k in range(n_cliques):
        base = k * clique
        for i in range(clique):
            for j in range(i + 1, clique):
                us.append(base + i); vs.append(base + j)
        us.append(base); vs.append((base + clique) % n)  # ring link
    return Graph.from_undirected_edges(n, np.array(us), np.array(vs))


def molecule_batch(batch: int, n_nodes: int = 30, n_edges: int = 64,
                   seed: int = 0) -> Graph:
    """Block-diagonal batch of small random molecular graphs."""
    rng = np.random.default_rng(seed)
    us = []; vs = []
    for b in range(batch):
        base = b * n_nodes
        # spanning path for connectivity + random extra bonds
        perm = rng.permutation(n_nodes)
        us.append(base + perm[:-1]); vs.append(base + perm[1:])
        extra = n_edges // 2 - (n_nodes - 1)
        if extra > 0:
            us.append(base + rng.integers(0, n_nodes, extra))
            vs.append(base + rng.integers(0, n_nodes, extra))
    return Graph.from_undirected_edges(batch * n_nodes, np.concatenate(us),
                                       np.concatenate(vs))


# Scaled-down stand-ins for the paper's table-1 datasets: same degree
# structure, n reduced so the CPU container can run the full benchmark suite.
PAPER_DATASETS = {
    "NACA0015": lambda scale=1.0: tri_mesh(int(104 * scale), int(100 * scale)),
    "delaunay-n21": lambda scale=1.0: tri_mesh(int(145 * scale), int(145 * scale), diagonal_jitter=0.5),
    "M6": lambda scale=1.0: tri_mesh(int(187 * scale), int(187 * scale)),
    "NLR": lambda scale=1.0: tri_mesh(int(204 * scale), int(204 * scale)),
    "CHANNEL": lambda scale=1.0: grid3d(int(17 * scale), int(17 * scale), int(17 * scale)),
    "kmer-V2": lambda scale=1.0: kmer_chains(int(55_000 * scale)),
}


def paper_dataset(name: str, scale: float = 1.0) -> Graph:
    return PAPER_DATASETS[name](scale)
