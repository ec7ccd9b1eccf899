"""Port's hub/tail engine vs the reference's (mirrors tests/test_hub_tail.py).

The same numpy-seeded graphs (Chung-Lu, Barabasi-Albert) and
personalizations go through the reference's engines (JAX on the CPU) and
the port's `HubTailEngine` (torch on the CPU). Normalized PageRank is held
to L1 <= 1e-5 per column in f32 and <= 1e-3 with bf16-packed inv_deg, the
reference suite's bounds; raw applies to rtol/atol 1e-5 (sums in other
orders). The host build must give the reference's split array for array.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import make_schedule as jmake_schedule
from repro.core.engine import CooEngine as JCoo
from repro.core.engine import HubTailEngine as JHubTail
from repro.core.pagerank import cpaa_fixed as jcpaa_fixed
from repro.core.pagerank import degree_prior as jdegree_prior
from repro.graph import datasets as jdatasets
from repro.graph import generators as jgen
from repro.graph.ops import device_graph as jdevice_graph

from repro_torch import interop
from repro_torch.core import make_schedule
from repro_torch.core.engine import (HUB_TAIL_MIN_N, CooEngine,
                                     HubTailEngine, apply_counts,
                                     reset_apply_counts, select_engine)
from repro_torch.core.pagerank import cpaa_fixed, degree_prior
from repro_torch.graph import datasets, generators
from repro_torch.graph.ops import device_graph

SPLIT = ("tail_src", "tail_dst", "panel_cols", "panel_hub", "hub_ids")


def _pagerank(eng, n, p=None):
    """Normalized CPAA PageRank through a port engine (tol 1e-6 rounds)."""
    sched = make_schedule(0.85, 1e-6)
    coeffs = torch.as_tensor(sched.coeffs, dtype=torch.float32)
    if p is None:
        p = torch.full((n,), 1.0 / n)
    pi, _ = cpaa_fixed(eng, coeffs, p, rounds=sched.rounds)
    return pi.numpy()


def _jpagerank(eng, n, p=None):
    """The same through a reference engine."""
    sched = jmake_schedule(0.85, 1e-6)
    coeffs = jnp.asarray(sched.coeffs, jnp.float32)
    p = jnp.full((n,), 1.0 / n, jnp.float32) if p is None else jnp.asarray(p)
    pi, _ = jcpaa_fixed(eng, coeffs, p, rounds=sched.rounds)
    return np.asarray(pi)


def _l1(a, b, axis=None):
    return np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)) \
        .sum(axis=axis)


@pytest.fixture(scope="module")
def skewed():
    return (jdatasets.chung_lu(20_000, avg_deg=16.0, seed=1),
            datasets.chung_lu(20_000, avg_deg=16.0, seed=1))


class TestDatasets:
    @pytest.mark.parametrize("n,avg_deg,exponent,seed",
                             [(5_000, 16.0, 2.0, 0), (3_000, 8.0, 2.5, 7)])
    def test_chung_lu_identical(self, n, avg_deg, exponent, seed):
        gj = jdatasets.chung_lu(n, avg_deg=avg_deg, exponent=exponent,
                                seed=seed)
        gt = datasets.chung_lu(n, avg_deg=avg_deg, exponent=exponent,
                               seed=seed)
        assert gt.n == gj.n
        assert gt.src.tobytes() == gj.src.tobytes()
        assert gt.dst.tobytes() == gj.dst.tobytes()

    def test_scale_families_match(self):
        assert sorted(datasets.SCALE_FAMILIES) == \
            sorted(jdatasets.SCALE_FAMILIES)


class TestParity:
    def test_host_split_identical(self, skewed):
        gj, gt = skewed
        ej = JHubTail.from_graph(gj)
        et = HubTailEngine.from_graph(gt, device="cpu")
        assert et.n_hubs == ej.n_hubs > 0
        for name in SPLIT:
            np.testing.assert_array_equal(getattr(et, name).numpy(),
                                          np.asarray(getattr(ej, name)),
                                          err_msg=name)
        np.testing.assert_array_equal(et.inv_deg.numpy(),
                                      np.asarray(ej.inv_deg))

    def test_f32_matches_reference(self, skewed):
        gj, gt = skewed
        ref = _jpagerank(JCoo(jdevice_graph(gj)), gj.n)
        ref_ht = _jpagerank(JHubTail.from_graph(gj), gj.n)
        ht = _pagerank(HubTailEngine.from_graph(gt, device="cpu"), gt.n)
        assert _l1(ht, ref) <= 1e-5
        assert _l1(ht, ref_ht) <= 1e-5

    def test_bf16_weights_within_rounding(self, skewed):
        gj, gt = skewed
        ref = _jpagerank(JCoo(jdevice_graph(gj)), gj.n)
        eng = HubTailEngine.from_graph(gt, weight_dtype="bfloat16",
                                       device="cpu")
        assert eng.weight_dtype == torch.bfloat16
        assert eng.dtype == torch.float32     # solve dtype stays f32
        ht = _pagerank(eng, gt.n)
        assert ht.dtype == np.float32
        assert _l1(ht, ref) <= 1e-3
        ref_bf = _jpagerank(JHubTail.from_graph(gj,
                                                weight_dtype=jnp.bfloat16),
                            gj.n)
        assert _l1(ht, ref_bf) <= 1e-3

    def test_bf16_seeded_columns_match_reference_bf16(self, skewed):
        """On seeded columns bf16 packing can move PageRank by more than
        the 1e-3 the reference states for a uniform personalization, in
        both packages; with the same packed weights the port matches the
        reference's bf16 engine at the f32 bound."""
        gj, gt = skewed
        p = np.zeros((gt.n, 8), np.float32)
        p[np.arange(8) * 2011, np.arange(8)] = 1.0
        ref = _jpagerank(JHubTail.from_graph(gj, weight_dtype=jnp.bfloat16),
                         gj.n, p=p)
        eng = HubTailEngine.from_graph(gt, weight_dtype="bfloat16",
                                       device="cpu")
        np.testing.assert_array_equal(
            eng.inv_deg.float().numpy(),
            np.asarray(JHubTail.from_graph(gj, weight_dtype=jnp.bfloat16)
                       .inv_deg, np.float32))
        assert _l1(_pagerank(eng, gt.n, p=torch.from_numpy(p)), ref,
                   axis=0).max() <= 1e-5

    def test_batched_personalizations(self, skewed):
        gj, gt = skewed
        rng = np.random.default_rng(0)
        p = rng.random((gt.n, 4)).astype(np.float32)
        p /= p.sum(0, keepdims=True)
        ref = _jpagerank(JCoo(jdevice_graph(gj)), gj.n, p=p)
        ht = _pagerank(HubTailEngine.from_graph(gt, device="cpu"), gt.n,
                       p=torch.from_numpy(p))
        assert _l1(ht, ref, axis=0).max() <= 1e-5

    def test_apply_matches_reference_on_the_same_split(self, skewed):
        gj, _ = skewed
        ej = JHubTail.from_graph(gj)
        eng = interop.hub_tail_engine(
            *(np.asarray(getattr(ej, a)) for a in ("inv_deg",) + SPLIT),
            n=gj.n, device="cpu")
        x = np.random.default_rng(2).random((gj.n, 3)).astype(np.float32)
        np.testing.assert_allclose(eng.apply(torch.from_numpy(x)).numpy(),
                                   np.asarray(ej.apply(jnp.asarray(x))),
                                   rtol=1e-5, atol=1e-5)

    def test_mass_preserved(self, skewed):
        """P is column-stochastic; the sentinel row must not leak mass."""
        _, gt = skewed
        eng = HubTailEngine.from_graph(gt, device="cpu")
        x = torch.from_numpy(
            np.random.default_rng(1).random(gt.n, np.float32))
        y = eng.apply(x)
        assert y.shape == (gt.n,)
        np.testing.assert_allclose(float(y.sum()), float(x.sum()), rtol=1e-5)

    @pytest.mark.parametrize("hub_min_deg", [1, 10**9])
    def test_degenerate_splits(self, hub_min_deg):
        """All-hub and no-hub splits are both just P."""
        gj = jgen.powerlaw_ba(2_000, m_attach=4, seed=2)
        gt = generators.powerlaw_ba(2_000, m_attach=4, seed=2)
        ref = _jpagerank(JCoo(jdevice_graph(gj)), gj.n)
        eng = HubTailEngine.from_graph(gt, hub_min_deg=hub_min_deg,
                                       device="cpu")
        assert eng.n_hubs == (gt.n if hub_min_deg == 1 else 0)
        assert _l1(_pagerank(eng, gt.n), ref) <= 1e-5


class TestEngineContract:
    def test_apply_counts_and_identity_layout(self, skewed):
        _, gt = skewed
        eng = HubTailEngine.from_graph(gt, device="cpu")
        x = torch.ones(gt.n)
        assert eng.to_internal(x) is x and eng.from_internal(x) is x
        reset_apply_counts()
        eng.apply(x)
        eng.apply(x[:, None])
        assert apply_counts() == {"hub_tail": 2}

    def test_refresh_rebuilds_current_graph(self):
        g = generators.powerlaw_ba(3_000, m_attach=4, seed=0)
        eng = HubTailEngine.from_graph(g, weight_dtype="bfloat16",
                                       device="cpu")
        g2 = generators.powerlaw_ba(3_000, m_attach=5, seed=1)
        gj2 = jgen.powerlaw_ba(3_000, m_attach=5, seed=1)
        eng2 = eng.refresh(g2)
        assert eng2.n == g2.n and eng2.device.type == "cpu"
        assert eng2.weight_dtype == torch.bfloat16   # knobs survive
        ref = _jpagerank(JCoo(jdevice_graph(gj2)), gj2.n)
        assert _l1(_pagerank(eng2, g2.n), ref) <= 1e-3

    def test_select_engine_forced_and_auto(self):
        g = generators.powerlaw_ba(2_000, m_attach=4, seed=0)
        assert select_engine(g, mode="hub-tail", device="cpu").name == \
            "hub_tail"
        big = datasets.chung_lu(HUB_TAIL_MIN_N, avg_deg=16.0, seed=0)
        assert isinstance(select_engine(big, mode="auto", device="cpu"),
                          HubTailEngine)
        mesh = generators.tri_mesh(40, 40)
        assert not isinstance(select_engine(mesh, mode="auto", device="cpu"),
                              HubTailEngine)


class TestServing:
    def test_registry_hub_tail_bf16_with_updates(self):
        from repro.serve import GraphRegistry as JRegistry
        from repro.serve import PageRankService as JService
        from repro_torch.serve import GraphRegistry, PageRankService
        gj = jgen.powerlaw_ba(2_000, m_attach=4, seed=3)
        gt = generators.powerlaw_ba(2_000, m_attach=4, seed=3)
        reg_j = JRegistry(engine="hub_tail", weight_dtype="bfloat16")
        reg_j.register("g", gj)
        reg = GraphRegistry(engine="hub_tail", weight_dtype="bfloat16",
                            device="cpu")
        reg.register("g", gt)
        assert reg.get("g").engine.weight_dtype == torch.bfloat16
        kw = dict(max_batch=4, cache_capacity=16, max_top_k=8)
        svc_j, svc = JService(reg_j, **kw), PageRankService(reg, **kw)
        for seeds in [(7,), (7, 900)]:
            a = svc_j.query("g", seeds, tol=1e-6, top_k=8)
            b = svc.query("g", seeds, tol=1e-6, top_k=8)
            assert np.all(np.isfinite(b.scores))
            np.testing.assert_allclose(b.scores, a.scores, atol=1e-5)
        # the refresh keeps the engine class and its knobs
        reg_j.apply_updates("g", insert=[(0, 1500)])
        reg.apply_updates("g", insert=[(0, 1500)])
        eng = reg.get("g").engine
        assert eng.name == "hub_tail" and eng.weight_dtype == torch.bfloat16
        a = svc_j.query("g", (7,), tol=1e-6, top_k=8)
        b = svc.query("g", (7,), tol=1e-6, top_k=8)
        assert b.epoch == a.epoch == 1
        np.testing.assert_allclose(b.scores, a.scores, atol=1e-5)


class TestDegreePriorOracle:
    def test_prior_matches_reference_and_is_stationary(self):
        """deg/2m is exactly stationary for P = A D^-1 on an undirected
        graph, so PageRank personalized at the prior returns the prior."""
        gj = jdatasets.chung_lu(100_000, avg_deg=16.0, seed=0)
        gt = datasets.chung_lu(100_000, avg_deg=16.0, seed=0)
        prior = degree_prior(gt)
        np.testing.assert_array_equal(prior, jdegree_prior(gj))
        np.testing.assert_allclose(prior.sum(), 1.0, rtol=1e-12)
        p = torch.from_numpy(prior.astype(np.float32))
        for eng in (CooEngine(device_graph(gt, device="cpu")),
                    HubTailEngine.from_graph(gt, device="cpu")):
            assert _l1(_pagerank(eng, gt.n, p=p), p.numpy()) <= 1e-3
