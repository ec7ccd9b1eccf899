"""The paper's baseline solvers in the port (`power`, `forward_push`,
`monte_carlo`, `true_pagerank_dense`, `core.orthopoly`) against the
reference's.

`power` and `forward_push` are held to L1 <= 1e-5 on normalized PageRank
(both sum in f32, in different orders), and `power` to the reference's
iteration count at tolerances well above the f32 resolution of its
residual (max|x' - x| / max|x'| moves in steps of about 1e-7, one ulp of
the largest entry, so at tol 1e-6 the summation order alone can move the
stop by a round); the dense oracle to 1e-12 (the same float64 solve);
`ortho_pagerank` to L1 <= 1e-5 for each basis. `monte_carlo` cannot share
the reference's random stream, so it is held statistically, as
`tests/test_pagerank.py` holds the reference's.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import orthopoly as jortho
from repro.core import pagerank as jpr
from repro.core.engine import FusedBlockEllEngine as JFused
from repro.graph import generators as jgen
from repro.graph import ops as jops

from repro_torch.core import orthopoly as tortho
from repro_torch.core import pagerank as tpr
from repro_torch.core.chebyshev import make_schedule
from repro_torch.core.engine import CooEngine, FusedBlockEllEngine
from repro_torch.graph import generators
from repro_torch.graph.ops import device_graph
from repro_torch.graph.structure import Graph

GRAPHS = {
    "caveman": lambda gen: gen.caveman(6, 10, seed=0),
    "mesh": lambda gen: gen.tri_mesh(9, 11),
    "powerlaw": lambda gen: gen.powerlaw_ba(120, 3, seed=2),
    "er": lambda gen: gen.erdos_renyi(150, 8.0, seed=3),
    "kmer": lambda gen: gen.kmer_chains(200, seed=4),
}


def _pair(name):
    gj, gt = GRAPHS[name](jgen), GRAPHS[name](generators)
    return gj, jops.device_graph(gj), gt, device_graph(gt, device="cpu")


def _l1(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).sum(axis=0).max())


def _seeded_p(n, cols, seed):
    rng = np.random.default_rng(seed)
    p = np.zeros((n, cols), np.float32)
    for j in range(cols):
        p[rng.choice(n, int(rng.integers(1, 4)), replace=False), j] = 1.0
    return p


class TestPower:
    @pytest.mark.parametrize("tol", [1e-3, 1e-4, 1e-5])
    @pytest.mark.parametrize("name", sorted(GRAPHS))
    def test_matches_reference_pi_and_iterations(self, name, tol):
        _, djg, _, dtg = _pair(name)
        rj = jpr.power(djg, c=0.85, tol=tol)
        rt = tpr.power(dtg, c=0.85, tol=tol)
        assert rt.iterations == rj.iterations
        assert _l1(rt.pi.numpy(), rj.pi) <= 1e-5

    @pytest.mark.parametrize("name", sorted(GRAPHS))
    def test_stop_round_at_tol_1e6_within_one_round(self, name):
        """At tol 1e-6 the f32 residual's ~1e-7 steps let the summation
        order move the stop by a round: held to |delta rounds| <= 1 and
        the result to L1 <= 1e-5."""
        _, djg, _, dtg = _pair(name)
        rj = jpr.power(djg, c=0.85, tol=1e-6)
        rt = tpr.power(dtg, c=0.85, tol=1e-6)
        assert abs(rt.iterations - rj.iterations) <= 1
        assert _l1(rt.pi.numpy(), rj.pi) <= 1e-5

    @pytest.mark.parametrize("name", ["mesh", "powerlaw"])
    def test_batched_seeded_personalization(self, name):
        gj, djg, gt, dtg = _pair(name)
        p = _seeded_p(gt.n, 5, seed=1)
        rj = jpr.power(djg, c=0.85, tol=1e-5, p=jnp.asarray(p))
        rt = tpr.power(dtg, c=0.85, tol=1e-5, p=torch.from_numpy(p))
        assert rt.iterations == rj.iterations
        assert _l1(rt.pi.numpy(), rj.pi) <= 1e-5

    @pytest.mark.parametrize("check_every", [1, 3, 8, 1000])
    def test_check_period_never_changes_the_result(self, check_every,
                                                   monkeypatch):
        _, djg, _, dtg = _pair("er")
        monkeypatch.setattr(tpr, "POWER_CHECK_EVERY", 1)
        ref = tpr.power(dtg, tol=1e-5)
        monkeypatch.setattr(tpr, "POWER_CHECK_EVERY", check_every)
        r = tpr.power(dtg, tol=1e-5)
        assert r.iterations == ref.iterations == \
            jpr.power(djg, tol=1e-5).iterations
        assert torch.equal(r.pi, ref.pi)

    @pytest.mark.parametrize("max_iter", [1, 5, 17])
    def test_max_iter_caps_like_the_reference(self, max_iter):
        _, djg, _, dtg = _pair("mesh")
        rj = jpr.power(djg, tol=1e-10, max_iter=max_iter)
        rt = tpr.power(dtg, tol=1e-10, max_iter=max_iter)
        assert rt.iterations == rj.iterations == max_iter
        assert _l1(rt.pi.numpy(), rj.pi) <= 1e-5

    def test_default_tol_matches_dense_oracle(self):
        gj, djg, gt, dtg = _pair("caveman")
        r = tpr.power(dtg)
        assert _l1(r.pi.numpy(), tpr.true_pagerank_dense(gt)) <= 1e-5
        assert _l1(r.pi.numpy(), jpr.power(djg).pi) <= 1e-5

    def test_fused_engine_matches_reference_fused(self):
        gj, gt = jgen.tri_mesh(30, 40), generators.tri_mesh(30, 40)
        ej = JFused.from_graph(gj, block=128)
        et = FusedBlockEllEngine.from_graph(gt, block=128, device="cpu")
        rj = jpr.power(ej, tol=1e-5)
        rt = tpr.power(et, tol=1e-5)
        assert rt.iterations == rj.iterations
        assert _l1(rt.pi.numpy(), rj.pi) <= 1e-5

    def test_host_graph_entry_point(self):
        g = generators.caveman(5, 4)
        r = tpr.power(g, device="cpu")
        assert r.pi.device.type == "cpu"
        np.testing.assert_allclose(float(r.pi.sum()), 1.0, rtol=1e-5)


class TestForwardPush:
    @pytest.mark.parametrize("rounds", [1, 12, 50])
    @pytest.mark.parametrize("name", sorted(GRAPHS))
    def test_matches_reference(self, name, rounds):
        _, djg, _, dtg = _pair(name)
        rj = jpr.forward_push(djg, c=0.85, rounds=rounds)
        rt = tpr.forward_push(dtg, c=0.85, rounds=rounds)
        assert rt.iterations == rj.iterations == rounds
        assert _l1(rt.pi.numpy(), rj.pi) <= 1e-5

    def test_batched_on_fused(self):
        gj, gt = jgen.tri_mesh(30, 40), generators.tri_mesh(30, 40)
        p = _seeded_p(gt.n, 4, seed=2)
        rj = jpr.forward_push(JFused.from_graph(gj, block=128), rounds=20,
                              p=jnp.asarray(p))
        rt = tpr.forward_push(FusedBlockEllEngine.from_graph(
            gt, block=128, device="cpu"), rounds=20, p=torch.from_numpy(p))
        assert _l1(rt.pi.numpy(), rj.pi) <= 1e-5


class TestDenseOracle:
    @pytest.mark.parametrize("cols", [None, 3])
    @pytest.mark.parametrize("name", sorted(GRAPHS))
    def test_equal_to_reference(self, name, cols):
        gj, _, gt, _ = _pair(name)
        p = None if cols is None else _seeded_p(gt.n, cols, seed=3)
        np.testing.assert_allclose(
            tpr.true_pagerank_dense(gt, 0.85, p=p),
            np.asarray(jpr.true_pagerank_dense(gj, 0.85, p=p)),
            rtol=1e-12, atol=1e-15)


class TestOrthoPolynomials:
    @pytest.mark.parametrize("basis", ["chebyshev", "legendre", "chebyshev2"])
    def test_recurrence_and_coefficients_equal(self, basis):
        for k in range(6):
            assert tortho.basis_recurrence(basis, k) == \
                jortho.basis_recurrence(basis, k)
        np.testing.assert_array_equal(
            tortho.series_coefficients(basis, 0.85, 12),
            jortho.series_coefficients(basis, 0.85, 12))
        with pytest.raises(ValueError):
            tortho.basis_recurrence("laguerre", 0)

    @pytest.mark.parametrize("rounds", [10, 40])
    @pytest.mark.parametrize("basis", ["chebyshev", "legendre", "chebyshev2"])
    def test_ortho_pagerank_matches_reference(self, basis, rounds):
        gj, gt = jgen.tri_mesh(13, 15), generators.tri_mesh(13, 15)
        pj = jortho.ortho_pagerank(jops.device_graph(gj), basis, 0.85,
                                   rounds=rounds)
        pt = tortho.ortho_pagerank(device_graph(gt, device="cpu"), basis,
                                   0.85, rounds=rounds)
        assert _l1(pt.numpy(), pj) <= 1e-5

    @pytest.mark.parametrize("basis", ["chebyshev", "legendre", "chebyshev2"])
    def test_batched_matches_reference(self, basis):
        gj, gt = jgen.tri_mesh(13, 15), generators.tri_mesh(13, 15)
        p = _seeded_p(gt.n, 3, seed=4)
        pj = jortho.ortho_pagerank(jops.device_graph(gj), basis, 0.85,
                                   rounds=20, p=jnp.asarray(p))
        pt = tortho.ortho_pagerank(device_graph(gt, device="cpu"), basis,
                                   0.85, rounds=20, p=torch.from_numpy(p))
        assert _l1(pt.numpy(), pj) <= 1e-5

    def test_all_bases_converge_and_chebyshev_is_best(self):
        g = generators.tri_mesh(13, 15)
        dg = device_graph(g, device="cpu")
        truth = tpr.true_pagerank_dense(g, 0.85)
        errs = {}
        for basis in ("chebyshev", "legendre", "chebyshev2"):
            pi = tortho.ortho_pagerank(dg, basis, 0.85, rounds=40).numpy()
            assert np.max(np.abs(pi - truth) / truth) < 1e-4, basis
            pi10 = tortho.ortho_pagerank(dg, basis, 0.85, rounds=10).numpy()
            errs[basis] = np.max(np.abs(pi10 - truth) / truth)
        assert errs["chebyshev"] <= min(errs.values()) * 1.001
        err_fp = np.max(np.abs(tpr.forward_push(dg, 0.85, rounds=10).pi
                               .numpy() - truth) / truth)
        assert max(errs.values()) < err_fp


class TestMonteCarlo:
    def test_correlates_on_skewed_graph(self):
        g = generators.powerlaw_ba(150, 3, seed=6)
        pi_true = tpr.true_pagerank_dense(g, 0.85)
        mc = tpr.monte_carlo(device_graph(g, device="cpu"),
                             walks_per_node=64, max_len=80, seed=1).pi
        assert np.corrcoef(mc.numpy(), pi_true)[0, 1] > 0.97

    def test_terminates_at_isolated_vertices(self):
        base = generators.powerlaw_ba(80, 3, seed=1)
        n = base.n + 3
        g = Graph.from_undirected_edges(n, base.src, base.dst,
                                        add_self_loops_to_isolated=False)
        iso = [base.n, base.n + 1, base.n + 2]
        assert all(g.deg[v] == 0 for v in iso)
        walks = 64
        pi = tpr.monte_carlo(device_graph(g, device="cpu"),
                             walks_per_node=walks, max_len=60, seed=3).pi
        pi = pi.numpy()
        assert np.all(np.isfinite(pi)) and \
            pi.sum() == pytest.approx(1.0, abs=1e-5)
        for v in iso:
            assert pi[v] == pytest.approx(walks / (n * walks), rel=1e-6)
        corr = np.corrcoef(pi[: base.n],
                           tpr.true_pagerank_dense(base, 0.85))[0, 1]
        assert corr > 0.9

    def test_edgeless_graph_is_uniform(self):
        g = Graph.from_undirected_edges(7, np.array([], np.int64),
                                        np.array([], np.int64),
                                        add_self_loops_to_isolated=False)
        pi = tpr.monte_carlo(device_graph(g, device="cpu")).pi.numpy()
        np.testing.assert_allclose(pi, 1.0 / 7, rtol=1e-6)

    def test_seeded_and_reproducible(self):
        dg = device_graph(generators.tri_mesh(9, 11), device="cpu")
        a = tpr.monte_carlo(dg, seed=5).pi
        assert torch.equal(a, tpr.monte_carlo(dg, seed=5).pi)
        assert not torch.equal(a, tpr.monte_carlo(dg, seed=6).pi)

    def test_statistically_agrees_with_the_reference(self):
        """Both estimators, many walks, the same graph: each close to the
        oracle, and to each other, in L1."""
        gj, gt = jgen.powerlaw_ba(100, 3, seed=4), \
            generators.powerlaw_ba(100, 3, seed=4)
        truth = tpr.true_pagerank_dense(gt, 0.85)
        mt = tpr.monte_carlo(device_graph(gt, device="cpu"),
                             walks_per_node=400, max_len=80, seed=0).pi
        mj = jpr.monte_carlo(jops.device_graph(gj), walks_per_node=400,
                             max_len=80, seed=0).pi
        assert _l1(mt.numpy(), truth) < 0.05
        assert _l1(mj, truth) < 0.05
        assert _l1(mt.numpy(), mj) < 0.08

    def test_rejects_non_coo_engines(self):
        g = generators.tri_mesh(30, 40)
        with pytest.raises(TypeError, match="COO"):
            tpr.monte_carlo(FusedBlockEllEngine.from_graph(g, device="cpu"))
        assert isinstance(tpr.monte_carlo(CooEngine(device_graph(
            g, device="cpu"))).pi, torch.Tensor)


class TestCsrView:
    @pytest.mark.parametrize("pad", [None, 4096])
    def test_csr_equal_to_reference(self, pad):
        gj, gt = jgen.powerlaw_ba(300, 3, seed=9), \
            generators.powerlaw_ba(300, 3, seed=9)
        cj = jops.device_graph(gj, pad_edges_to=pad).csr()
        ct = device_graph(gt, pad_edges_to=pad, device="cpu").csr()
        for a, b in zip(ct, cj):
            assert a.dtype == torch.int32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    def test_csr_view_follows_an_in_place_patch(self):
        from repro_torch.graph.ops import EdgeSlots, patch_device_graph
        from repro_torch.graph.structure import edge_delta
        g = generators.tri_mesh(9, 11)
        es = EdgeSlots.from_graph(g, cap=1024)
        dg = es.to_device(device="cpu")
        before = [t.clone() for t in dg.csr()]
        delta = edge_delta(g.n, es.ekeys, np.array([0 * g.n + 98]))
        patch_device_graph(dg, es.apply_delta(delta))
        after = dg.csr()
        fresh = device_graph(es.to_graph(), device="cpu").csr()
        assert not torch.equal(after[0], before[0])
        assert torch.equal(after[0], fresh[0])
        assert torch.equal(after[1], fresh[1])


class TestUnitMassDefaults:
    def test_default_personalization_unit_mass(self):
        """The default personalization of every solver is uniform with
        unit mass, so un-normalized readings compare across solvers."""
        g = generators.tri_mesh(9, 11)
        dg = device_graph(g, device="cpu")
        p = torch.full((g.n,), 1.0 / g.n)
        for solve in (lambda **k: tpr.power(dg, tol=1e-6, **k),
                      lambda **k: tpr.forward_push(dg, rounds=12, **k),
                      lambda **k: tpr.cpaa(dg, tol=1e-6, **k)):
            assert torch.allclose(solve().pi, solve(p=p).pi, rtol=1e-6,
                                  atol=1e-9)

    def test_paper_operating_point_round_counts(self):
        """At the paper's operating point (c = 0.85, ERR < 1e-3) CPAA
        runs 12 rounds; power needs more to reach the same L1 gap."""
        g = generators.tri_mesh(13, 15)
        dg = device_graph(g, device="cpu")
        truth = tpr.true_pagerank_dense(g, 0.85)
        sched = make_schedule(0.85, 1e-3)
        assert sched.rounds == 12
        gap = _l1(tpr.cpaa(dg, schedule=sched).pi.numpy(), truth)
        k = next(k for k in range(1, 200)
                 if _l1(tpr.power(dg, tol=0.0, max_iter=k).pi.numpy(),
                        truth) <= gap)
        assert k > sched.rounds
