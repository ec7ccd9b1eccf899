"""The port's edge partitions (`repro_torch.graph.partition`) against the
reference's (`repro.graph.partition`): byte-identical arrays and equal
metadata, on the reference suites' graphs, device counts, grids and lanes;
the column-layout permutation; and the sacrificial padding slot of
tests/test_partition_padding.py (padding edges have weight 0, so a real
vertex in the slot keeps exactly its mass).
"""
import numpy as np
import pytest

from repro.graph import generators as jgen
from repro.graph import partition as jpart
from repro.graph.structure import Graph as JGraph

from repro_torch.graph import generators
from repro_torch.graph import partition as tpart
from repro_torch.graph.structure import Graph

GRAPHS = {
    "mesh": lambda gen: gen.tri_mesh(9, 11),
    "powerlaw": lambda gen: gen.powerlaw_ba(120, 3, seed=2),
    "kmer": lambda gen: gen.kmer_chains(200, seed=4),
}
LANES = (4, 8, 128)


def _pair(name):
    return GRAPHS[name](jgen), GRAPHS[name](generators)


def _same(a: np.ndarray, b: np.ndarray) -> None:
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _ring(cls, n: int):
    u = np.arange(n, dtype=np.int64)
    return cls.from_undirected_edges(
        n, np.concatenate([u, [0]]), np.concatenate([(u + 1) % n, [n // 2]]))


def _dense_p(g) -> np.ndarray:
    a = np.zeros((g.n, g.n))
    a[g.dst, g.src] = 1.0
    return a / np.maximum(a.sum(0), 1.0)[None, :]


@pytest.mark.parametrize("lane", LANES)
@pytest.mark.parametrize("n_dev", (1, 2, 8))
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_partition_1d_byte_identical(name, n_dev, lane):
    gj, gt = _pair(name)
    pj = jpart.partition_1d(gj, n_dev, lane=lane)
    pt = tpart.partition_1d(gt, n_dev, lane=lane)
    for f in ("src", "dst_local", "weight"):
        _same(getattr(pt, f), getattr(pj, f))
    assert (pt.n, pt.n_orig, pt.n_dev, pt.rows_per_dev, pt.edges_per_dev) \
        == (pj.n, pj.n_orig, pj.n_dev, pj.rows_per_dev, pj.edges_per_dev)


@pytest.mark.parametrize("lane", LANES)
@pytest.mark.parametrize("grid", [(1, 1), (1, 2), (2, 2), (2, 4)])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_partition_2d_byte_identical(name, grid, lane):
    gj, gt = _pair(name)
    pj = jpart.partition_2d(gj, grid, lane=lane)
    pt = tpart.partition_2d(gt, grid, lane=lane)
    for f in ("src_local", "dst_local", "weight"):
        _same(getattr(pt, f), getattr(pj, f))
    assert (pt.n, pt.n_orig, tuple(pt.grid), pt.rows_per_chunk,
            pt.cols_per_chunk, pt.sub, pt.edges_per_dev) == \
        (pj.n, pj.n_orig, tuple(pj.grid), pj.rows_per_chunk,
         pj.cols_per_chunk, pj.sub, pj.edges_per_dev)


@pytest.mark.parametrize("grid", [(1, 1), (1, 2), (2, 2), (2, 4), (4, 4)])
@pytest.mark.parametrize("n", [128, 1024, 4096])
def test_col_layout_perm_identical(n, grid):
    pt = tpart.col_layout_perm(n, grid)
    _same(pt, jpart.col_layout_perm(n, grid))
    np.testing.assert_array_equal(np.sort(pt), np.arange(n))


def test_edgeless_graph_pads_one_lane():
    gt = Graph(n=10, src=np.zeros(0, np.int32), dst=np.zeros(0, np.int32))
    gj = JGraph(n=10, src=np.zeros(0, np.int32), dst=np.zeros(0, np.int32))
    _same(tpart.partition_1d(gt, 2, lane=4).weight,
          jpart.partition_1d(gj, 2, lane=4).weight)
    _same(tpart.partition_2d(gt, (1, 2), lane=4).src_local,
          jpart.partition_2d(gj, (1, 2), lane=4).src_local)


class TestSacrificialSlot:
    """tests/test_partition_padding.py on the port's partitions: n is an
    exact multiple of D * lane (R * C * lane), so the padding edges' slot
    is a REAL vertex and its mass rests on their zero weight."""

    def test_partition_1d_sacrificial_slot_keeps_mass(self):
        n_dev, lane = 4, 4
        g = _ring(Graph, n_dev * lane)
        part = tpart.partition_1d(g, n_dev, lane=lane)
        assert part.n == g.n
        assert np.any(part.weight == 0)
        x = np.random.default_rng(0).random(g.n)
        y = np.zeros(part.n)
        rows = part.rows_per_dev
        for d in range(part.n_dev):
            np.add.at(y, d * rows + part.dst_local[d],
                      x[part.src[d]] * part.weight[d].astype(float))
        expect = _dense_p(g) @ x
        np.testing.assert_allclose(y, expect, rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(y[g.n - 1], expect[g.n - 1], rtol=1e-6)

    def test_partition_2d_sacrificial_slot_keeps_mass(self):
        grid, lane = (2, 2), 4
        g = _ring(Graph, grid[0] * grid[1] * lane)
        part = tpart.partition_2d(g, grid, lane=lane)
        assert part.n == g.n
        assert np.any(part.weight == 0)
        rows, sub = part.rows_per_chunk, part.sub
        x = np.random.default_rng(1).random(g.n)
        x_col = np.empty((grid[1], part.cols_per_chunk))
        for c in range(grid[1]):
            for r in range(grid[0]):
                x_col[c, r * sub:(r + 1) * sub] = \
                    x[r * rows + c * sub: r * rows + (c + 1) * sub]
        y = np.zeros(part.n)
        for r in range(grid[0]):
            for c in range(grid[1]):
                np.add.at(y, r * rows + part.dst_local[r, c],
                          x_col[c][part.src_local[r, c]]
                          * part.weight[r, c].astype(float))
        expect = _dense_p(g) @ x
        np.testing.assert_allclose(y, expect, rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(y[g.n - 1], expect[g.n - 1], rtol=1e-6)

    @pytest.mark.parametrize("kind", ["1d", "2d"])
    def test_boundary_partitions_byte_identical(self, kind):
        lane = 4
        if kind == "1d":
            pj = jpart.partition_1d(_ring(JGraph, 4 * lane), 4, lane=lane)
            pt = tpart.partition_1d(_ring(Graph, 4 * lane), 4, lane=lane)
            fields = ("src", "dst_local", "weight")
        else:
            pj = jpart.partition_2d(_ring(JGraph, 4 * lane), (2, 2),
                                    lane=lane)
            pt = tpart.partition_2d(_ring(Graph, 4 * lane), (2, 2),
                                    lane=lane)
            fields = ("src_local", "dst_local", "weight")
        assert pt.n == pj.n == 4 * lane
        for f in fields:
            _same(getattr(pt, f), getattr(pj, f))
