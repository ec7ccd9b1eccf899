"""Port's PPR service vs the reference's, query for query.

Both services get the same seeded queries (distinct seed sets plus exact
repeats). Scores are held to 1e-5 absolute (the f32 parity bound of the
solves underneath); ranked ids must be equal wherever adjacent scores
differ by more than 1e-6, since entries closer than that may swap on
rounding. The service counters must be equal. Ties that are exact (a
symmetric graph) must come out lower index first, as `lax.top_k` orders
them.
"""
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import pagerank_serve as jcfg
from repro.graph.structure import Graph as JGraph
from repro.serve.graph_registry import GraphRegistry as JRegistry
from repro.serve.pagerank_service import PageRankService as JService
from repro.serve.pagerank_service import PPRQuery as JQuery

from repro_torch.configs import pagerank_serve as tcfg
from repro_torch.graph.structure import Graph
from repro_torch.launch import serve as tlaunch
from repro_torch.serve.graph_registry import GraphRegistry
from repro_torch.serve.pagerank_service import (PageRankService, PPRQuery,
                                                topk_lower_index_first)

COUNTERS = ("queries", "cache_hits", "solves", "solved_queries", "ticks",
            "padded_columns", "rounds_used", "rounds_bound")


def _queries(names_n, count, seed, top_k):
    """`count` distinct seeded queries over (name, n) graphs + 10% repeats."""
    rng = np.random.default_rng(seed)
    seen, out = set(), []
    while len(out) < count:
        name, n = names_n[int(rng.integers(0, len(names_n)))]
        seeds = tuple(sorted(int(s) for s in rng.choice(
            n, int(rng.integers(1, 4)), replace=False)))
        if (name, seeds) in seen:
            continue
        seen.add((name, seeds))
        out.append((len(out), name, seeds))
    repeats = [(count + j, name, seeds)
               for j, (_, name, seeds) in enumerate(out[:count // 10])]
    return out, repeats, top_k


def _drive(svc, query_cls, batches, c, tol, top_k):
    results = {}
    for batch in batches:
        for qid, name, seeds in batch:
            svc.submit(query_cls(qid=qid, graph=name, seeds=seeds, c=c,
                                 tol=tol, top_k=top_k))
        results.update(svc.run_until_drained())
    return results


def _assert_same_answers(res_j, res_t):
    assert sorted(res_j) == sorted(res_t)
    for qid in res_j:
        a, b = res_j[qid], res_t[qid]
        assert a.cached == b.cached and a.epoch == b.epoch
        assert b.indices.dtype == np.int32 and b.scores.dtype == np.float32
        np.testing.assert_allclose(b.scores, a.scores, rtol=0, atol=1e-5)
        s = a.scores.astype(np.float64)
        gap = np.abs(np.diff(s)) > 1e-6
        # rank i is pinned when it is separated from both neighbours; the
        # last rank's lower neighbour lies outside the answer, so it is not
        pinned = np.ones(len(s), bool)
        pinned[1:] &= gap
        pinned[:-1] &= gap
        pinned[-1] = False
        assert np.array_equal(a.indices[pinned], b.indices[pinned]), qid


def _parity(cfg_j, cfg_t, n_queries, seed):
    svc_j = jcfg.make_service(cfg_j)
    svc_t = tcfg.make_service(cfg_t, device="cpu")
    names_n = [(nm, svc_t.registry.get(nm).n)
               for nm in svc_t.registry.names()]
    for nm, n in names_n:
        assert svc_j.registry.get(nm).n == n
        assert svc_t.registry.get(nm).engine.name == \
            svc_j.registry.get(nm).engine.name
    qs, reps, k = _queries(names_n, n_queries, seed, min(8, cfg_t.max_top_k))
    res_j = _drive(svc_j, JQuery, [qs, reps], cfg_t.c, cfg_t.tol, k)
    res_t = _drive(svc_t, PPRQuery, [qs, reps], cfg_t.c, cfg_t.tol, k)
    _assert_same_answers(res_j, res_t)
    st_j, st_t = svc_j.stats, svc_t.stats
    assert set(st_t) == set(st_j)
    for key in COUNTERS:
        assert st_t[key] == st_j[key], key
    assert st_t["queries"] == st_t["cache_hits"] + st_t["solved_queries"] \
        + st_t["dropped_queries"]
    assert st_t["cache_hits"] == len(reps)
    return svc_t


class TestServiceParity:
    @pytest.mark.parametrize("adaptive", [True, False])
    def test_smoke_config_on_coo(self, adaptive):
        svc = _parity(replace(jcfg.smoke_config(), adaptive=adaptive),
                      replace(tcfg.smoke_config(), adaptive=adaptive),
                      n_queries=40, seed=1)
        assert svc.registry.get("mesh").engine.name == "coo"

    @pytest.mark.parametrize("adaptive", [True, False])
    def test_fused_engine_on_tri_mesh(self, adaptive):
        # NACA0015 at scale 0.5 is a 52 x 50 tri_mesh (>= 40 x 50)
        kw = dict(graphs=(("mesh", "NACA0015", 0.5),), engine="fused",
                  max_batch=16, max_top_k=8, adaptive=adaptive)
        svc = _parity(jcfg.PPRServeConfig(**kw), tcfg.PPRServeConfig(**kw),
                      n_queries=36, seed=2)
        assert svc.registry.get("mesh").engine.name == "block_ell_fused"
        assert svc.registry.get("mesh").n == 52 * 50


def _ring(cls, n):
    u = np.arange(n)
    return cls.from_undirected_edges(n, u, (u + 1) % n)


class TestTies:
    def test_exact_ties_lower_index_first_like_reference(self):
        n = 64
        reg_j = JRegistry()
        reg_j.register("ring", _ring(JGraph, n))
        reg_t = GraphRegistry(device="cpu")
        reg_t.register("ring", _ring(Graph, n))
        svc_j = JService(reg_j, max_batch=4, max_top_k=9)
        svc_t = PageRankService(reg_t, max_batch=4, max_top_k=9)
        for seeds in [(0,), (10,), (5, 37)]:
            a = svc_j.query("ring", seeds, top_k=9)
            b = svc_t.query("ring", seeds, top_k=9)
            assert np.array_equal(a.indices, b.indices), seeds
            np.testing.assert_allclose(b.scores, a.scores, atol=1e-5)
        b = svc_t.query("ring", (0,), top_k=9)
        assert list(b.indices[:5]) == [0, 1, 63, 2, 62]
        assert b.scores[1] == b.scores[2] and b.scores[3] == b.scores[4]

    @pytest.mark.parametrize("k", [1, 3, 8])
    def test_topk_helper_matches_lax_top_k(self, k):
        rng = np.random.default_rng(k)
        x = rng.integers(0, 5, size=(6, 40)).astype(np.float32)
        vj, ij = jax.lax.top_k(jnp.asarray(x), k)
        it, vt = topk_lower_index_first(torch.from_numpy(x), k)
        assert np.array_equal(np.asarray(ij), it.numpy())
        assert np.array_equal(np.asarray(vj), vt.numpy())
        assert it.dtype == torch.int32


class TestServiceSurface:
    def _svc(self, **kw):
        return tcfg.make_service(replace(tcfg.smoke_config(), **kw),
                                 device="cpu")

    def test_stats_keys_match_reference(self):
        from repro.serve.pagerank_service import PageRankService as JS
        js = JS(JRegistry())
        assert set(self._svc().stats) == set(js.stats)

    def test_unported_knobs_raise(self):
        # updates, the refresh tick, the deadline scheduler, async dispatch
        # and hub/tail are ported; measured selection and the sharded
        # engines still raise when the registry builds a graph
        for engine in ("tuned", "sharded-1d", "sharded-2d"):
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                self._svc(engine=engine)
        svc = self._svc(scheduler="deadline", async_dispatch=True,
                        engine="hub-tail")
        assert svc.registry.get("mesh").engine.name == "hub_tail"
        assert svc.update_graph("mesh", insert=[(0, 5)]) == 1
        assert svc.refresh_tick() == 0

    def test_unported_knobs_are_stored(self):
        svc = self._svc(invalidation_radius=3, refresh_batch=5)
        assert svc.invalidation_radius == 3 and svc.refresh_batch == 5

    def test_validation_and_cache(self):
        svc = self._svc()
        with pytest.raises(ValueError):
            svc.submit(PPRQuery(qid=0, graph="mesh", seeds=()))
        with pytest.raises(ValueError, match="top_k"):
            svc.submit(PPRQuery(qid=0, graph="mesh", seeds=(1,), top_k=99))
        with pytest.raises(KeyError):
            svc.submit(PPRQuery(qid=0, graph="nope", seeds=(1,)))
        r1 = svc.query("mesh", (3, 1, 3), top_k=4)
        r2 = svc.query("mesh", (1, 3), top_k=2)
        assert not r1.cached and r2.cached
        assert np.array_equal(r1.indices[:2], r2.indices)
        st = svc.stats
        assert st["queries"] == 2 and st["cache_hits"] == 1

    def test_overrun_drop_counts(self):
        svc = self._svc()
        for i in range(3):
            svc.submit(PPRQuery(qid=i, graph="mesh", seeds=(i,)))
        with pytest.warns(RuntimeWarning, match="dropped"):
            svc.run_until_drained(max_ticks=0, on_overrun="drop")
        st = svc.stats
        assert st["dropped_queries"] == 3
        assert st["queries"] == st["cache_hits"] + st["solved_queries"] + \
            st["dropped_queries"]


class TestLauncher:
    def test_smoke_run_on_cpu(self, capsys):
        out = tlaunch.main(["--arch", "pagerank-serve", "--smoke",
                            "--requests", "24", "--device", "cpu"])
        text = capsys.readouterr().out
        assert "warm graphs + engines: {'mesh': 'coo'}" in text
        assert "rounds used" in text
        assert out["served"] == 24 + 2
        assert out["rounds_used"] <= out["rounds_bound"]

    def test_fused_fixed_rounds(self):
        out = tlaunch.main(["--arch", "pagerank-serve", "--smoke",
                            "--requests", "8", "--device", "cpu",
                            "--engine", "fused", "--fixed-rounds"])
        assert out["engines"] == {"mesh": "block_ell_fused"}
        assert out["rounds_used"] == out["rounds_bound"]

    def test_updates_rejected(self):
        # an unknown update mode is rejected; --updates now runs
        with pytest.raises(SystemExit):
            tlaunch.main(["--arch", "pagerank-serve", "--smoke",
                          "--update-mode", "bogus", "--device", "cpu"])
        out = tlaunch.main(["--arch", "pagerank-serve", "--smoke",
                            "--requests", "8", "--updates", "2",
                            "--device", "cpu"])
        assert out["updates"] == 2
        assert out["incremental_updates"] + out["noop_updates"] == 2
