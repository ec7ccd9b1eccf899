"""The column top-k (`kernels.topk.topk_columns`) and the PPR rankings that
go through it, against the reference's `jax.lax.top_k`, on the CPU.

* the plain version bitwise against `lax.top_k` of the same values in
  vertex order: random f32, integer-valued ties (0..4), all-zero columns,
  k in {1, 8, 32, 128}, B in {1, 3, 128}; without a row map and with a
  random one over rows followed by padding rows of large values, which
  must never appear;
* the wrapper's checks (the ones the card enforces: k <= 128, contiguity,
  the row map), and CPU tensors launch nothing;
* the engines' `ranking_layout` (identity on COO, BFS perm on block-ELL);
* the adaptive tick, which ranks the loop's snapshot in the engine's own
  layout, against the reference's `_solve_topk_adaptive` on COO and on the
  fused engine (scores atol 1e-5; ranks equal wherever a rank is separated
  from its neighbours by more than 1e-6, test_torch_serve.py's rule), and
  the fixed-round tick and the refresh through the same kernel.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.graph import generators as jgen
from repro.serve.graph_registry import GraphRegistry as JRegistry
from repro.serve.pagerank_service import _refine_topk as j_refine_topk
from repro.serve.pagerank_service import _solve_topk as j_solve_topk
from repro.serve.pagerank_service import \
    _solve_topk_adaptive as j_solve_topk_adaptive

from repro_torch.core.engine import BlockEllEngine, CooEngine
from repro_torch.graph import generators
from repro_torch.graph.ops import device_graph
from repro_torch.kernels import _build
from repro_torch.kernels.topk import ops as topk_ops
from repro_torch.kernels.topk.ops import topk_columns
from repro_torch.kernels.topk.ref import topk_columns_ref
from repro_torch.serve.graph_registry import GraphRegistry
from repro_torch.serve.pagerank_service import (_refine_topk, _solve_topk,
                                                _solve_topk_adaptive)

N_ROWS = 257          # ranked rows: odd, above the largest k
KINDS = ("random", "ties", "zeros")


def _values(kind: str, n: int, b: int, seed: int) -> np.ndarray:
    """[n, b] f32 in vertex order."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.standard_normal((n, b)).astype(np.float32)
    if kind == "ties":
        return rng.integers(0, 5, (n, b)).astype(np.float32)
    return np.zeros((n, b), np.float32)


def _lax(vert: np.ndarray, k: int):
    """lax.top_k of each column of a vertex-order [n, B] array."""
    v, i = jax.lax.top_k(jnp.asarray(vert.T), k)
    return np.asarray(i), np.asarray(v)


def _assert_bitwise(got, want):
    idx, vals = got
    assert idx.dtype == torch.int32 and vals.dtype == torch.float32
    assert np.array_equal(idx.numpy(), want[0])
    assert np.array_equal(vals.numpy().view(np.int32),
                          want[1].view(np.int32))


class TestPlainVsLaxTopK:
    @pytest.mark.parametrize("kind", KINDS)
    @pytest.mark.parametrize("k", [1, 8, 32, 128])
    @pytest.mark.parametrize("b", [1, 3, 128])
    def test_vertex_order(self, kind, k, b):
        vert = _values(kind, N_ROWS, b, seed=k * 1000 + b)
        got = topk_columns(torch.from_numpy(vert), k)
        _assert_bitwise(got, _lax(vert, k))

    @pytest.mark.parametrize("kind", KINDS)
    @pytest.mark.parametrize("k", [1, 8, 32, 128])
    @pytest.mark.parametrize("b", [1, 3, 128])
    def test_row_map_and_padding(self, kind, k, b):
        """Row r holds vertex perm[r]; the rows past n_valid hold values
        above every real one and are never ranked."""
        rng = np.random.default_rng(k * 1000 + b + 7)
        vert = _values(kind, N_ROWS, b, seed=k * 1000 + b + 1)
        perm = rng.permutation(N_ROWS).astype(np.int32)
        pad = (1e6 * (1.0 + rng.random((31, b)))).astype(np.float32)
        rows = np.concatenate([vert[perm], pad])
        got = topk_columns(torch.from_numpy(rows), k, n_valid=N_ROWS,
                           ids=torch.from_numpy(perm))
        _assert_bitwise(got, _lax(vert, k))
        assert int(got[0].max()) < N_ROWS

    def test_ties_go_to_the_lower_vertex_id_not_the_lower_row(self):
        vert = np.array([[1.0], [2.0], [2.0], [1.0], [2.0]], np.float32)
        perm = np.array([4, 3, 2, 1, 0], np.int32)
        idx, vals = topk_columns(torch.from_numpy(vert[perm].copy()), 4,
                                 ids=torch.from_numpy(perm))
        assert idx.tolist() == [[1, 2, 4, 0]]
        assert vals.tolist() == [[2.0, 2.0, 2.0, 1.0]]

    def test_negative_zero_ranks_and_comes_out_as_zero(self):
        x = torch.tensor([[-0.0], [0.0], [-0.0], [-1.0]])
        idx, vals = topk_columns(x, 3)
        assert idx.tolist() == [[0, 1, 2]]
        assert not torch.signbit(vals).any()

    def test_k_above_128_is_plain_on_the_cpu(self):
        vert = _values("ties", 300, 2, seed=3)
        got = topk_columns(torch.from_numpy(vert), 150)
        _assert_bitwise(got, _lax(vert, 150))


class TestWrapper:
    def _x(self, n=40, b=4):
        return torch.from_numpy(_values("random", n, b, seed=0))

    def test_cpu_calls_launch_nothing(self):
        topk_ops.reset_launches()
        topk_columns(self._x(), 3)
        _refine_topk(CooEngine(device_graph(generators.tri_mesh(5, 6),
                                            device="cpu")),
                     torch.full((30,), 1 / 30), torch.eye(30)[0], 0.85, 3, 4)
        assert topk_ops.launches() == 0
        assert "topk_columns" not in _build._LIBS

    @pytest.mark.parametrize("k", [0, 129])
    def test_k_outside_the_kernel_raises(self, k):
        x = self._x(n=200)
        with pytest.raises(ValueError, match="k"):
            topk_ops._check(x, k, 200, None)

    def test_k_above_the_ranked_rows_raises(self):
        with pytest.raises(ValueError, match="k"):
            topk_ops._check(self._x(n=40), 20, 10, None)

    def test_layout_checks(self):
        x = self._x()
        with pytest.raises(ValueError, match="contiguous"):
            topk_ops._check(self._x(b=40, n=4).T, 2, 40, None)
        with pytest.raises(ValueError, match="takes \\[R, B\\]"):
            topk_ops._check(x[:, 0], 2, 40, None)
        with pytest.raises(TypeError, match="float32 or float64"):
            topk_ops._check(x.half(), 2, 40, None)
        with pytest.raises(ValueError, match="n_valid"):
            topk_ops._check(x, 2, 41, None)
        ids = torch.arange(40, dtype=torch.int32)
        topk_ops._check(x, 2, 40, ids)
        for bad in (ids.long(), ids[:39], torch.arange(80,
                    dtype=torch.int32)[::2]):
            with pytest.raises(ValueError, match="ids"):
                topk_ops._check(x, 2, 40, bad)

    def test_other_devices_raise(self):
        with pytest.raises(ValueError, match="topk_columns"):
            topk_columns(self._x().to("meta"), 2)

    def test_source_entry_points(self):
        src = _build.sources()["topk_columns"].read_text()
        for name in ("topk_columns_f32", "topk_columns_f64"):
            assert f'extern "C" int {name}(' in src
        assert "kMaxK = 128;" in src and topk_ops.MAX_K == 128


class TestLaunchCounts:
    """The plan and its path are the kernel's (`topk_columns_plan`, held
    on the card in tests/test_torch_gpu.py); a CPU call counts nothing."""

    def test_counters_by_path_start_at_zero(self):
        topk_ops.reset_launches()
        topk_columns(torch.rand(40, 3), 2)
        assert topk_ops.launches_by_path() == dict.fromkeys(topk_ops.PATHS,
                                                            0)


class TestRankingLayout:
    def test_coo_is_vertex_order(self):
        eng = CooEngine(device_graph(generators.tri_mesh(6, 7),
                                     device="cpu"))
        x = torch.rand(eng.n, 3)
        rows, n_valid, ids = eng.ranking_layout(x)
        assert rows is x and n_valid == eng.n and ids is None

    def test_block_ell_rows_hold_the_bfs_perm(self):
        g = generators.tri_mesh(20, 30)
        eng = BlockEllEngine.from_graph(g, block=128, device="cpu")
        vert = torch.rand(g.n, 5)
        rows, n_valid, ids = eng.ranking_layout(eng.to_internal(vert))
        assert rows.shape[0] == eng.n_pad > n_valid == g.n
        assert ids.dtype == torch.int32 and torch.equal(ids.long(),
                                                        eng.perm)
        assert torch.equal(rows[:n_valid][torch.argsort(ids.long())], vert)
        a = topk_columns(rows, 10, n_valid=n_valid, ids=ids)
        b = topk_columns(vert, 10)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def _pinned_equal(a_idx, a_scores, b_idx, b_scores):
    """test_torch_serve.py's rule, row by row."""
    np.testing.assert_allclose(b_scores, a_scores, rtol=0, atol=1e-5)
    for ai, a, bi in zip(a_idx, a_scores.astype(np.float64), b_idx):
        gap = np.abs(np.diff(a)) > 1e-6
        pinned = np.ones(len(a), bool)
        pinned[1:] &= gap
        pinned[:-1] &= gap
        pinned[-1] = False
        assert np.array_equal(ai[pinned], bi[pinned])


def _registries(engine: str):
    g_j, g_t = jgen.tri_mesh(40, 50), generators.tri_mesh(40, 50)
    reg_j = JRegistry(engine=engine)
    reg_j.register("mesh", g_j)
    reg_t = GraphRegistry(device="cpu", engine=engine)
    reg_t.register("mesh", g_t)
    return reg_j, reg_t, g_t.n


def _personalization(n: int, b: int, live: int, seed: int) -> np.ndarray:
    """b columns, the first `live` seeded at 1-3 vertices, the rest uniform
    (a tick's padded columns)."""
    rng = np.random.default_rng(seed)
    p = np.zeros((n, b), np.float32)
    for j in range(live):
        p[rng.choice(n, int(rng.integers(1, 4)), replace=False), j] = 1.0
    p[:, live:] = 1.0
    return p


class TestTicksVsReference:
    @pytest.mark.parametrize("engine,name", [("coo", "coo"),
                                             ("fused", "block_ell_fused")])
    def test_adaptive_tick(self, engine, name):
        reg_j, reg_t, n = _registries(engine)
        rg_j, rg_t = reg_j.get("mesh"), reg_t.get("mesh")
        assert rg_t.engine.name == rg_j.engine.name == name
        p = _personalization(n, 16, live=11, seed=4)
        plan = reg_t.adaptive_schedule(0.85, 1e-4)
        ij, sj, used_j, cols_j, _ = j_solve_topk_adaptive(
            rg_j.engine, jnp.asarray(p), plan.c, plan.tol,
            max_rounds=plan.max_rounds, chunk=plan.chunk, k=12)
        it, st, used_t, cols_t, _ = _solve_topk_adaptive(
            rg_t.engine, torch.from_numpy(p), plan.c, plan.tol,
            max_rounds=plan.max_rounds, chunk=plan.chunk, k=12)
        assert it.dtype == torch.int32 and it.shape == (16, 12)
        assert int(used_j) == used_t
        assert np.array_equal(np.asarray(cols_j), cols_t.numpy())
        _pinned_equal(np.asarray(ij), np.asarray(sj), it.numpy(),
                      st.numpy())

    @pytest.mark.parametrize("engine", ["coo", "fused"])
    def test_fixed_tick(self, engine):
        reg_j, reg_t, n = _registries(engine)
        p = _personalization(n, 8, live=5, seed=5)
        sched_j, coeffs_j = reg_j.schedule(0.85, 1e-4)
        sched_t, coeffs_t = reg_t.schedule(0.85, 1e-4)
        ij, sj = j_solve_topk(reg_j.get("mesh").engine, coeffs_j,
                              jnp.asarray(p), rounds=sched_j.rounds, k=9)
        it, st = _solve_topk(reg_t.get("mesh").engine, coeffs_t,
                             torch.from_numpy(p), rounds=sched_t.rounds, k=9)
        _pinned_equal(np.asarray(ij), np.asarray(sj), it.numpy(),
                      st.numpy())

    def test_refresh(self):
        reg_j, reg_t, n = _registries("fused")
        rng = np.random.default_rng(6)
        x0 = rng.random(n).astype(np.float32)
        p = np.zeros(n, np.float32)
        p[[3, 700]] = 1.0
        ij, sj = j_refine_topk(reg_j.get("mesh").engine, jnp.asarray(x0),
                               jnp.asarray(p), 0.85, rounds=12, k=10)
        it, st = _refine_topk(reg_t.get("mesh").engine,
                              torch.from_numpy(x0), torch.from_numpy(p),
                              0.85, rounds=12, k=10)
        assert it.shape == (10,) and it.dtype == torch.int32
        _pinned_equal(np.asarray(ij)[None], np.asarray(sj)[None],
                      it.numpy()[None], st.numpy()[None])

    def test_tick_ranks_the_snapshot_without_building_pi(self, monkeypatch):
        """The adaptive tick never calls from_internal on a single-device
        engine: it ranks the snapshot through the row map."""
        _, reg_t, n = _registries("fused")
        eng = reg_t.get("mesh").engine

        def refuse(x):
            raise AssertionError("from_internal on the adaptive tick")
        monkeypatch.setattr(eng, "from_internal", refuse)
        plan = reg_t.adaptive_schedule(0.85, 1e-4)
        p = torch.from_numpy(_personalization(n, 4, live=4, seed=7))
        idx, scores, *_ = _solve_topk_adaptive(
            eng, p, plan.c, plan.tol, max_rounds=plan.max_rounds,
            chunk=plan.chunk, k=5)
        assert idx.shape == (4, 5) and bool(torch.isfinite(scores).all())
