"""Port's CPAA solvers vs the reference's (`repro.core.pagerank`).

The same graphs and personalizations, made with numpy from a seed, go
through both packages on the CPU. PageRank vectors are held to L1 <= 1e-5
per column (the reference's f32 parity bound, tests/test_engine.py and
tests/test_sharded_engine.py): both sides run the same f32 recurrence but
sum the SpMM in different orders.

Adaptive solves must also take the same number of rounds. The residual
that decides a chunk exit is an f32 sum, so a column whose residual at
some check lies within rounding of tol may exit one chunk earlier on one
side: such a one-chunk difference is accepted only where the reference's
residual at that check lies within 1% of tol (`_assert_rounds_match`).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import engine as jeng
from repro.core import pagerank as jpr
from repro.graph import generators as jgen
from repro.graph import ops as jops

from repro_torch.core import engine as teng
from repro_torch.core import pagerank as tpr
from repro_torch.core.chebyshev import default_chunk, make_schedule
from repro_torch.graph import generators, ops

GRAPHS = {
    "tri_mesh": lambda gen: gen.tri_mesh(30, 34),
    "kmer": lambda gen: gen.kmer_chains(2500, seed=4),
    "caveman": lambda gen: gen.caveman(30, 10),
    "powerlaw": lambda gen: gen.powerlaw_ba(1200, seed=5),
}
L1 = 1e-5


def _coo_pair(name):
    gj, gt = GRAPHS[name](jgen), GRAPHS[name](generators)
    return jops.device_graph(gj), ops.device_graph(gt, device="cpu")


def _personalization(n, ndim, seed):
    """[n] or [n, 6] seeded restart vectors (unnormalized seed indicators,
    as the service builds them, plus one uniform column)."""
    rng = np.random.default_rng(seed)
    if ndim == 1:
        p = np.zeros(n, np.float32)
        p[rng.choice(n, 3, replace=False)] = 1.0
        return p
    p = np.zeros((n, 6), np.float32)
    for j in range(5):
        p[rng.choice(n, int(rng.integers(1, 4)), replace=False), j] = 1.0
    p[:, 5] = 1.0 / n
    return p


def _assert_l1_per_column(a, b):
    a = np.asarray(a, np.float64).reshape(a.shape[0], -1)
    b = np.asarray(b, np.float64).reshape(b.shape[0], -1)
    l1 = np.abs(a - b).sum(axis=0)
    assert np.all(l1 <= L1), l1


def _assert_rounds_match(ref_engine, p, c, tol, max_rounds, chunk,
                         ref_cols, port_cols):
    """Column rounds equal, or one chunk apart where the reference's
    residual at the earlier check lies within 1% of tol."""
    ref_cols = np.atleast_1d(np.asarray(ref_cols))
    port_cols = np.atleast_1d(np.asarray(port_cols))
    for j in np.nonzero(ref_cols != port_cols)[0]:
        lo, hi = sorted((int(ref_cols[j]), int(port_cols[j])))
        assert hi - lo <= chunk, (j, lo, hi)
        _, _, _, resid = jpr.cpaa_adaptive_fixed(
            ref_engine, jnp.asarray(p), c, tol, max_rounds=lo, chunk=chunk)
        r = float(np.atleast_1d(np.asarray(resid))[j])
        assert abs(r - tol) <= 0.01 * tol, (j, r, tol)


class TestCpaa:
    @pytest.mark.parametrize("ndim", [1, 2])
    @pytest.mark.parametrize("name", sorted(GRAPHS))
    def test_cpaa_matches_reference(self, name, ndim):
        dj, dt = _coo_pair(name)
        p = _personalization(dt.n, ndim, seed=ndim)
        rj = jpr.cpaa(dj, c=0.85, tol=1e-6, p=jnp.asarray(p))
        rt = tpr.cpaa(dt, c=0.85, tol=1e-6, p=torch.from_numpy(p))
        assert rt.iterations == rj.iterations
        assert rt.pi.shape == tuple(rj.pi.shape)
        _assert_l1_per_column(rj.pi, rt.pi.numpy())

    @pytest.mark.parametrize("name", ["tri_mesh", "kmer"])
    def test_cpaa_fixed_and_history(self, name):
        dj, dt = _coo_pair(name)
        sched = make_schedule(0.85, 1e-4)
        p = _personalization(dt.n, 2, seed=7)
        pj, hj = jpr.cpaa_fixed(dj, jnp.asarray(sched.coeffs, jnp.float32),
                                jnp.asarray(p), rounds=sched.rounds,
                                keep_history=True)
        pt, ht = tpr.cpaa_fixed(dt, torch.as_tensor(sched.coeffs,
                                                    dtype=torch.float32),
                                torch.from_numpy(p), rounds=sched.rounds,
                                keep_history=True)
        _assert_l1_per_column(pj, pt.numpy())
        assert tuple(ht.shape) == tuple(hj.shape)
        np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=1e-5,
                                   atol=1e-6)

    def test_uniform_default_and_normalization(self):
        dj, dt = _coo_pair("caveman")
        rj = jpr.cpaa(dj)
        rt = tpr.cpaa(dt)
        _assert_l1_per_column(rj.pi, rt.pi.numpy())
        assert abs(float(rt.pi.sum()) - 1.0) < 1e-5

    def test_all_zero_column_stays_zero(self):
        _, dt = _coo_pair("caveman")
        p = torch.zeros(dt.n, 2)
        p[0, 0] = 1.0
        pi = tpr.cpaa(dt, p=p).pi
        assert torch.isfinite(pi).all() and float(pi[:, 1].abs().sum()) == 0

    def test_host_graph_goes_to_the_requested_device(self):
        g = GRAPHS["caveman"](generators)
        rt = tpr.cpaa(g, device="cpu")
        _, dt = _coo_pair("caveman")
        assert torch.equal(rt.pi, tpr.cpaa(dt).pi)
        with pytest.raises(ValueError, match="lives on"):
            tpr.cpaa(dt, device="meta")


class TestAdaptive:
    @pytest.mark.parametrize("ndim", [1, 2])
    @pytest.mark.parametrize("name", sorted(GRAPHS))
    @pytest.mark.parametrize("tol", [1e-4, 1e-6])
    def test_adaptive_matches_reference(self, name, ndim, tol):
        dj, dt = _coo_pair(name)
        p = _personalization(dt.n, ndim, seed=11 + ndim)
        rj = jpr.cpaa_adaptive(dj, c=0.85, tol=tol, p=jnp.asarray(p))
        rt = tpr.cpaa_adaptive(dt, c=0.85, tol=tol, p=torch.from_numpy(p))
        _assert_l1_per_column(rj.pi, rt.pi.numpy())
        assert rt.rounds_bound == rj.rounds_bound
        assert rt.iterations <= rt.rounds_bound
        chunk = default_chunk(0.85, tol)
        _assert_rounds_match(jeng.CooEngine(dj), p, 0.85, tol,
                             rj.rounds_bound, chunk, rj.column_rounds,
                             rt.column_rounds)
        if np.array_equal(np.atleast_1d(rj.column_rounds),
                          np.atleast_1d(rt.column_rounds)):
            assert rt.iterations == rj.iterations
        assert rt.column_rounds.shape == np.asarray(rj.column_rounds).shape
        assert rt.column_rounds.dtype == np.int32

    @pytest.mark.parametrize("chunk", [1, 3, 8])
    def test_adaptive_fixed_core_rounds(self, chunk):
        dj, dt = _coo_pair("tri_mesh")
        p = _personalization(dt.n, 2, seed=3)
        pj, kj, cj, resj = jpr.cpaa_adaptive_fixed(
            dj, jnp.asarray(p), 0.85, 1e-4, max_rounds=16, chunk=chunk)
        pt, kt, ct, rest = tpr.cpaa_adaptive_fixed(
            dt, torch.from_numpy(p), 0.85, 1e-4, max_rounds=16, chunk=chunk)
        _assert_l1_per_column(pj, pt.numpy())
        _assert_rounds_match(jeng.CooEngine(dj), p, 0.85, 1e-4, 16, chunk,
                             cj, ct.numpy())
        assert isinstance(kt, int) and kt == int(ct.max())
        np.testing.assert_allclose(rest.numpy(), np.asarray(resj),
                                   rtol=1e-2, atol=1e-7)

    def test_coefficients_on_device_match_reference(self):
        """sq, beta, c0 and c_k as the reference computes them in f32: a
        single-seed solve that hits the cap equals the fixed-round answer
        computed from the same recurrence (tests/test_adaptive.py)."""
        _, dt = _coo_pair("kmer")
        p = torch.zeros(dt.n)
        p[17] = 1.0
        sched = make_schedule(0.85, 1e-6)
        pi_a, k, _, _ = tpr.cpaa_adaptive_fixed(dt, p, 0.85, 1e-30,
                                                max_rounds=sched.rounds,
                                                chunk=4)
        pi_f = tpr.cpaa(dt, c=0.85, tol=1e-6, p=p).pi
        assert k == sched.rounds
        assert float((pi_a - pi_f).abs().sum()) <= L1


class TestBlockEngineSolves:
    """The solver through the block engines (plain versions on the CPU)
    vs the reference's Pallas kernels in interpret mode."""

    @pytest.mark.parametrize("fused", [False, True])
    def test_cpaa_block_engines(self, fused):
        g_j, g_t = jgen.tri_mesh(20, 26), generators.tri_mesh(20, 26)
        cls_j = jeng.FusedBlockEllEngine if fused else jeng.BlockEllEngine
        cls_t = teng.FusedBlockEllEngine if fused else teng.BlockEllEngine
        ej = cls_j.from_graph(g_j, use_kernel=True, interpret=True)
        et = cls_t.from_graph(g_t, device="cpu")
        p = _personalization(g_t.n, 2, seed=21)
        rj = jpr.cpaa(ej, tol=1e-4, p=jnp.asarray(p))
        rt = tpr.cpaa(et, tol=1e-4, p=torch.from_numpy(p))
        _assert_l1_per_column(rj.pi, rt.pi.numpy())

    def test_adaptive_fused_matches_coo_and_reference(self):
        g_j, g_t = jgen.tri_mesh(24, 30), generators.tri_mesh(24, 30)
        ej = jeng.FusedBlockEllEngine.from_graph(g_j, use_kernel=True,
                                                 interpret=True)
        et = teng.FusedBlockEllEngine.from_graph(g_t, device="cpu")
        p = _personalization(g_t.n, 2, seed=22)
        rj = jpr.cpaa_adaptive(ej, tol=1e-4, p=jnp.asarray(p))
        rt = tpr.cpaa_adaptive(et, tol=1e-4, p=torch.from_numpy(p))
        _assert_l1_per_column(rj.pi, rt.pi.numpy())
        _assert_rounds_match(ej, p, 0.85, 1e-4, rj.rounds_bound,
                             default_chunk(0.85, 1e-4), rj.column_rounds,
                             rt.column_rounds)
        rc = tpr.cpaa_adaptive(ops.device_graph(g_t, device="cpu"), tol=1e-4,
                               p=torch.from_numpy(p))
        _assert_l1_per_column(rc.pi.numpy(), rt.pi.numpy())


class TestPowerRefine:
    """Warm-started power rounds vs the reference's `power_refine`, from a
    perturbed start, through COO and the block engines (the reference's
    Pallas kernels in interpret mode)."""

    @staticmethod
    def _start(n, ndim, seed):
        rng = np.random.default_rng(seed)
        x0 = rng.random(n if ndim == 1 else (n, 6)).astype(np.float32)
        return x0 / x0.sum(axis=0)

    @pytest.mark.parametrize("rounds", [1, 8, 30])
    @pytest.mark.parametrize("ndim", [1, 2])
    @pytest.mark.parametrize("name", sorted(GRAPHS))
    def test_coo_matches_reference(self, name, ndim, rounds):
        dj, dt = _coo_pair(name)
        p = _personalization(dt.n, ndim, seed=30 + ndim)
        x0 = self._start(dt.n, ndim, seed=rounds)
        pj = jpr.power_refine(dj, jnp.asarray(x0), jnp.asarray(p), 0.85,
                              rounds)
        pt = tpr.power_refine(dt, torch.from_numpy(x0), torch.from_numpy(p),
                              0.85, rounds)
        assert pt.shape == x0.shape and pt.dtype == torch.float32
        _assert_l1_per_column(pj, pt.numpy())

    @pytest.mark.parametrize("fused", [False, True])
    def test_block_engines(self, fused):
        g_j, g_t = jgen.tri_mesh(20, 26), generators.tri_mesh(20, 26)
        cls_j = jeng.FusedBlockEllEngine if fused else jeng.BlockEllEngine
        cls_t = teng.FusedBlockEllEngine if fused else teng.BlockEllEngine
        ej = cls_j.from_graph(g_j, use_kernel=True, interpret=True)
        et = cls_t.from_graph(g_t, device="cpu")
        p = _personalization(g_t.n, 1, seed=40)
        x0 = self._start(g_t.n, 1, seed=41)
        pj = jpr.power_refine(ej, jnp.asarray(x0), jnp.asarray(p), 0.85, 16)
        pt = tpr.power_refine(et, torch.from_numpy(x0), torch.from_numpy(p),
                              0.85, 16)
        _assert_l1_per_column(pj, pt.numpy())

    def test_converges_to_the_cpaa_answer(self):
        _, dt = _coo_pair("tri_mesh")
        p = _personalization(dt.n, 1, seed=3)
        want = tpr.cpaa(dt, tol=1e-8, p=torch.from_numpy(p)).pi
        x0 = torch.full((dt.n,), 1.0 / dt.n)
        got = tpr.power_refine(dt, x0, torch.from_numpy(p), 0.85, 120)
        assert float((got - want).abs().sum()) <= L1


# ---- tests/test_adaptive.py's cap, masking and service cases on the port,
# beside the reference (the loop whose per-chunk host read TL001 marks)

def _seed_batch(n, b=4, seed=3):
    rng = np.random.default_rng(seed)
    p = np.zeros((n, b), np.float32)
    for j in range(b):
        p[rng.choice(n, rng.integers(1, 4), replace=False), j] = 1.0
    return p


def _caveman_pair():
    gj, gt = jgen.caveman(12, 16, seed=0), generators.caveman(12, 16, seed=0)
    return gt, jops.device_graph(gj), ops.device_graph(gt, device="cpu")


class TestAprioriCap:
    @pytest.mark.parametrize("c,tol", [(0.5, 1e-8), (0.85, 1e-4),
                                       (0.85, 1e-8), (0.95, 1e-6)])
    def test_never_exceeds_the_formula8_bound(self, c, tol):
        g = generators.tri_mesh(9, 11)
        dt = ops.device_graph(g, device="cpu")
        dj = jops.device_graph(jgen.tri_mesh(9, 11))
        sched = make_schedule(c, tol)
        for p in (None, _seed_batch(g.n)):
            res = tpr.cpaa_adaptive(
                dt, c, tol, p=None if p is None else torch.from_numpy(p))
            ref = jpr.cpaa_adaptive(
                dj, c, tol, p=None if p is None else jnp.asarray(p))
            assert res.rounds_bound == ref.rounds_bound == sched.rounds
            assert res.iterations <= sched.rounds
            assert int(np.max(res.column_rounds)) <= sched.rounds
            _assert_l1_per_column(ref.pi, res.pi.numpy())

    def test_broad_personalization_exits_early(self):
        """The degree prior is near-stationary on an undirected graph, so
        the residual exit fires well under the bound (4 of 12 rounds), at
        the reference's round."""
        g, dj, dt = _caveman_pair()
        deg = np.maximum(g.deg.astype(float), 1.0)
        pdeg = (deg / deg.sum()).astype(np.float32)
        res = tpr.cpaa_adaptive(dt, 0.85, 1e-3, p=torch.from_numpy(pdeg))
        ref = jpr.cpaa_adaptive(dj, 0.85, 1e-3, p=jnp.asarray(pdeg))
        assert res.iterations < res.rounds_bound
        assert res.iterations == ref.iterations
        truth = tpr.true_pagerank_dense(g, 0.85, p=pdeg)
        assert np.abs(res.pi.numpy().astype(float) - truth).sum() <= 1e-3


class TestPerColumnMasking:
    def test_mixed_batch_converges_per_column(self):
        """An easy (uniform) column freezes before a hard (single-seed)
        one; a column that exited early is within tol of the oracle, and
        every column within tol of the fixed-round solve; the column
        rounds are the reference's."""
        tol = 1e-5
        g, dj, dt = _caveman_pair()
        n = g.n
        p = np.zeros((n, 3), np.float32)
        p[:, 0] = 1.0 / n
        p[3, 1] = 1.0
        p[[5, n - 1], 2] = 0.5
        res = tpr.cpaa_adaptive(dt, 0.85, tol, p=torch.from_numpy(p))
        ref = jpr.cpaa_adaptive(dj, 0.85, tol, p=jnp.asarray(p))
        assert res.column_rounds[0] < res.column_rounds[1]
        np.testing.assert_array_equal(res.column_rounds,
                                      np.asarray(ref.column_rounds))
        oracle = tpr.true_pagerank_dense(g, 0.85, p=p)
        fixed = tpr.cpaa(dt, 0.85, tol,
                         p=torch.from_numpy(p)).pi.numpy().astype(float)
        pi = res.pi.numpy().astype(float)
        for j in range(3):
            if res.column_rounds[j] < res.rounds_bound:   # early exit
                assert np.abs(pi[:, j] - oracle[:, j]).sum() <= tol
            assert np.abs(pi[:, j] - fixed[:, j]).sum() <= tol

    def test_batched_equals_columnwise_singles(self):
        g = generators.powerlaw_ba(120, 3, seed=2)
        dt = ops.device_graph(g, device="cpu")
        p = _seed_batch(g.n, b=5, seed=11)
        batched = tpr.cpaa_adaptive(dt, 0.85, 1e-6,
                                    p=torch.from_numpy(p)).pi.numpy()
        for j in range(p.shape[1]):
            single = tpr.cpaa_adaptive(
                dt, 0.85, 1e-6, p=torch.from_numpy(p[:, j])).pi.numpy()
            np.testing.assert_allclose(batched[:, j], single,
                                       rtol=1e-5, atol=1e-8)


class TestAdaptiveService:
    @staticmethod
    def _service(g, **kw):
        from repro_torch.serve import GraphRegistry, PageRankService
        reg = GraphRegistry(device="cpu")
        reg.register("g", g)
        return PageRankService(reg, max_batch=8, cache_capacity=64,
                               max_top_k=8, adaptive=True, **kw)

    def test_adaptive_tick_matches_oracle(self):
        g = generators.tri_mesh(8, 9)
        svc = self._service(g)
        seeds = (3, 40)
        res = svc.query("g", seeds, tol=1e-8, top_k=8)
        p = np.zeros(g.n)
        p[list(seeds)] = 0.5
        oracle = tpr.true_pagerank_dense(g, 0.85, p=p)
        assert set(res.indices.tolist()) == \
            set(np.argsort(-oracle, kind="stable")[:8].tolist())
        np.testing.assert_allclose(res.scores, oracle[res.indices],
                                   rtol=1e-4, atol=1e-6)
        assert 0 < svc.stats["rounds_used"] <= svc.stats["rounds_bound"]

    def test_registry_adaptive_schedule_cached_and_capped(self):
        from repro_torch.serve import GraphRegistry
        reg = GraphRegistry(device="cpu")
        plan = reg.adaptive_schedule(0.85, 1e-4)
        assert plan is reg.adaptive_schedule(0.85, 1e-4)   # cache hit
        sched, _ = reg.schedule(0.85, 1e-4)
        assert plan.max_rounds == sched.rounds
        assert reg.adaptive_schedule(0.85, 1e-4, chunk=2).chunk == 2

    def test_per_tick_rounds_drop_on_broad_queries(self):
        """A broad seed set converges before the bound, and the tick's
        round telemetry shows it, as the reference's does."""
        from repro.serve import GraphRegistry as JRegistry
        from repro.serve import PageRankService as JService
        from repro.serve import PPRQuery as JQuery
        from repro_torch.serve import PPRQuery
        g = generators.caveman(12, 16, seed=0)
        svc = self._service(g)
        svc.submit(PPRQuery(qid=0, graph="g", seeds=tuple(range(g.n)),
                            tol=1e-3, top_k=4))
        svc.run_until_drained()
        jreg = JRegistry()
        jreg.register("g", jgen.caveman(12, 16, seed=0))
        jsvc = JService(jreg, max_batch=8, cache_capacity=64, max_top_k=8,
                        adaptive=True)
        jsvc.submit(JQuery(qid=0, graph="g", seeds=tuple(range(g.n)),
                           tol=1e-3, top_k=4))
        jsvc.run_until_drained()
        assert svc.stats["rounds_used"] < svc.stats["rounds_bound"]
        assert svc.stats["rounds_used"] == jsvc.stats["rounds_used"]
        assert svc.stats["rounds_bound"] == jsvc.stats["rounds_bound"]
