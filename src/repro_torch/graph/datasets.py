"""Scale-free graphs at paper scale (the Chung-Lu part of
`repro.graph.datasets`, copied; host numpy).

`chung_lu` and `SCALE_FAMILIES` use the reference's parameters and seeds,
so they yield byte-identical graphs, built afresh on every call. The SNAP
edge-list loader and the memory-mapped preprocessed-graph cache are not
ported yet.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

from repro_torch.graph.structure import Graph

__all__ = ["chung_lu", "SCALE_FAMILIES"]


def chung_lu(n: int, avg_deg: float = 16.0, exponent: float = 2.0,
             seed: int = 0, i0: int = 10) -> Graph:
    """Chung-Lu-style scale-free graph: expected degree of vertex i is
    proportional to (i + i0)^(-1/(exponent-1)), giving a degree power law
    with tail exponent ~`exponent`. i0 caps the top hub's share (smaller i0
    -> heavier hubs). Both endpoints of each of the n*avg_deg/2 undirected
    samples are drawn by inverse-CDF searchsorted — O(m log n), no python
    loop — then canonicalized (dedup, self-loop drop, symmetrize), so the
    realized average degree lands slightly under `avg_deg`.
    """
    rng = np.random.default_rng(seed)
    w = (np.arange(n, dtype=float) + i0) ** (-1.0 / (exponent - 1.0))
    cdf = np.cumsum(w)
    cdf /= cdf[-1]
    m = int(n * avg_deg / 2)
    u = np.searchsorted(cdf, rng.random(m)).astype(np.int64)
    v = np.searchsorted(cdf, rng.random(m)).astype(np.int64)
    return Graph.from_undirected_edges(n, u, v)


# Named operating points of the reference's scale benchmarks, with the
# same parameters (and so the same graphs).
SCALE_FAMILIES: dict[str, Callable[[], Graph]] = {
    "chunglu-100k": lambda: chung_lu(100_000, avg_deg=16.0, exponent=2.0),
    "chunglu-200k": lambda: chung_lu(200_000, avg_deg=16.0, exponent=2.0),
    "chunglu-1m": lambda: chung_lu(1_000_000, avg_deg=16.0, exponent=2.0),
}

