"""Port's incremental edge-update path vs the reference's (mirrors
tests/test_update_churn.py and TestDynamicUpdates of
tests/test_pagerank_service.py).

The same numpy-seeded graphs and update batches go through both packages.
Host state (edge deltas, the slot mirror, key sets) must be equal array
for array; device patches must round-trip bitwise and equal the mirror's
weights cast the port's way; incremental solves must equal rebuilt ones to
L1 <= 1e-6, and the port's cache dispositions and counters must equal the
reference's on the same query/update stream. The port runs on the CPU.
"""
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro.configs import pagerank_serve as jcfg
from repro.graph import generators as jgen
from repro.graph.ops import EdgeSlots as JEdgeSlots
from repro.graph.structure import edge_delta as jedge_delta
from repro.serve import GraphRegistry as JRegistry
from repro.serve import PageRankService as JService
from repro.serve import PPRQuery as JQuery

from repro_torch.configs import pagerank_serve as tcfg
from repro_torch.core.pagerank import cpaa
from repro_torch.graph import generators
from repro_torch.graph.ops import EdgeSlots, device_graph, patch_device_graph
from repro_torch.graph.structure import Graph, edge_delta
from repro_torch.serve import GraphRegistry, PageRankService, PPRQuery
from repro_torch.serve.graph_registry import _undirected_keys

DG_FIELDS = ("src", "dst", "w", "inv_deg")
ENGINES = ["coo", "hub_tail", "block_ell", "fused"]


def mesh_non_edges(count, offset=13, start=0):
    """(i, i + offset) pairs that are NOT tri_mesh edges (mesh offsets are
    1, cols, cols+1; callers pass an offset that avoids all three)."""
    return [(start + i, start + i + offset) for i in range(count)]


def random_non_edges(g, count, seed=0):
    rng = np.random.default_rng(seed)
    have = set(zip(np.minimum(g.src, g.dst).tolist(),
                   np.maximum(g.src, g.dst).tolist()))
    out = []
    while len(out) < count:
        u, v = int(rng.integers(0, g.n)), int(rng.integers(0, g.n))
        e = (min(u, v), max(u, v))
        if u != v and e not in have:
            have.add(e)
            out.append(e)
    return out


def service(g, mode="incremental", engine="auto", **kw):
    reg = GraphRegistry(update_mode=mode, engine=engine, device="cpu")
    reg.register("g", g)
    defaults = dict(max_batch=8, cache_capacity=64, max_top_k=8)
    defaults.update(kw)
    return PageRankService(reg, **defaults)


def jservice(g, mode="incremental", engine="auto", **kw):
    reg = JRegistry(update_mode=mode, engine=engine)
    reg.register("g", g)
    defaults = dict(max_batch=8, cache_capacity=64, max_top_k=8)
    defaults.update(kw)
    return JService(reg, **defaults)


def dense_ppr(g, c, seeds):
    """float64 x = (1 - c)(I - cP)^{-1} p, p uniform over `seeds`."""
    deg = np.maximum(np.bincount(g.src, minlength=g.n), 1).astype(float)
    P = np.zeros((g.n, g.n))
    np.add.at(P, (g.dst, g.src), 1.0 / deg[g.src])
    p = np.zeros(g.n)
    p[list(seeds)] = 1.0 / len(seeds)
    return (1.0 - c) * np.linalg.solve(np.eye(g.n) - c * P, p)


def solve(eng, n, seed_v, tol=1e-8):
    p = torch.zeros(n)
    p[seed_v] = 1.0
    return cpaa(eng, tol=tol, p=p).pi.numpy()


def _host(dg):
    return {k: getattr(dg, k).clone() for k in DG_FIELDS}


class TestEdgeDelta:
    def test_effective_sets_and_touched(self):
        g = generators.tri_mesh(5, 7)
        keys = _undirected_keys(g)
        n = g.n
        present, absent = keys[0], 0 * n + 13
        d = edge_delta(n, keys, insert_keys=[present, absent],
                       delete_keys=[keys[1]])
        np.testing.assert_array_equal(d.inserted, [absent])
        np.testing.assert_array_equal(d.deleted, [keys[1]])
        assert not d.is_noop
        assert set(d.touched.tolist()) == \
            {0, 13, int(keys[1] // n), int(keys[1] % n)}

    def test_noop_batch(self):
        g = generators.tri_mesh(5, 7)
        keys = _undirected_keys(g)
        n = g.n
        d = edge_delta(n, keys, insert_keys=[keys[0], keys[2]],
                       delete_keys=[keys[2], 0 * n + 13])
        assert d.is_noop and d.touched.size == 0

    def test_empty_key_set(self):
        d = edge_delta(10, np.empty(0, np.int64), insert_keys=[13],
                       delete_keys=[27])
        np.testing.assert_array_equal(d.inserted, [13])
        assert d.deleted.size == 0

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_random_batches_match_reference(self, seed):
        g = generators.tri_mesh(9, 11)
        keys = _undirected_keys(g)
        rng = np.random.default_rng(seed)
        ins = rng.integers(0, g.n * g.n, 12)
        dele = np.concatenate([rng.choice(keys, 6), ins[:3]])
        a = edge_delta(g.n, keys, ins, dele)
        b = jedge_delta(g.n, keys, ins, dele)
        for f in ("inserted", "deleted", "touched"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert a.is_noop == b.is_noop


class TestDevicePatchRoundTrip:
    """Insert a batch, then delete it: the DeviceGraph returns bit for bit,
    through both patch strategies (index_copy_ for slivers, the bulk copy
    past cap/64 touched slots)."""

    @pytest.mark.parametrize("weight_dtype", [None, "bfloat16"])
    @pytest.mark.parametrize("batch_size", [1, 40])
    def test_bit_for_bit(self, batch_size, weight_dtype):
        g = generators.tri_mesh(9, 11)
        es = EdgeSlots.from_graph(g, 1024)
        dg = es.to_device(weight_dtype=weight_dtype, device="cpu")
        tensors = {k: getattr(dg, k) for k in DG_FIELDS}
        orig = _host(dg)
        keys0 = es.ekeys.copy()
        ins = np.array([u * g.n + v for u, v in mesh_non_edges(batch_size)],
                       np.int64)
        d1 = edge_delta(g.n, es.ekeys, ins, ())
        assert d1.inserted.size == batch_size
        p1 = es.apply_delta(d1)
        assert (p1.slots.size * 64 >= es.cap) == (batch_size == 40)
        patch_device_graph(dg, p1)
        assert not torch.equal(dg.src, orig["src"])
        patch_device_graph(dg, es.apply_delta(
            edge_delta(g.n, es.ekeys, (), ins)))
        for k, v in orig.items():
            assert torch.equal(getattr(dg, k), v), k
            assert getattr(dg, k) is tensors[k], k    # patched in place
        np.testing.assert_array_equal(es.ekeys, keys0)

    @pytest.mark.parametrize("weight_dtype", [None, "bfloat16"])
    @pytest.mark.parametrize("batch_size", [3, 40])
    def test_patched_arrays_equal_the_mirror(self, batch_size, weight_dtype):
        g = generators.tri_mesh(9, 11)
        es = EdgeSlots.from_graph(g, 1024)
        dg = es.to_device(weight_dtype=weight_dtype, device="cpu")
        ins = [u * g.n + v for u, v in mesh_non_edges(batch_size)]
        patch_device_graph(dg, es.apply_delta(
            edge_delta(g.n, es.ekeys, ins, ())))
        wdtype = torch.float32 if weight_dtype is None else torch.bfloat16
        assert torch.equal(dg.w, torch.from_numpy(es.w64).to(wdtype))
        assert torch.equal(dg.src, torch.from_numpy(es.src))
        assert torch.equal(dg.dst, torch.from_numpy(es.dst))
        inv = 1.0 / np.maximum(es.deg, 1)
        assert torch.equal(dg.inv_deg, torch.from_numpy(inv).float())
        # and a fresh device_graph of the patched graph casts the same way
        fresh = device_graph(es.to_graph(), weight_dtype=weight_dtype,
                             device="cpu")
        live = torch.from_numpy(np.flatnonzero(es.live))
        assert torch.equal(dg.w[live], fresh.w)

    def test_mirror_matches_device_graph(self):
        g = generators.tri_mesh(9, 11)
        dg = EdgeSlots.from_graph(g, 1024).to_device(device="cpu")
        ref = device_graph(g, pad_edges_to=1024, device="cpu")
        for k in DG_FIELDS:
            assert torch.equal(getattr(dg, k), getattr(ref, k)), k

    def test_mirror_state_matches_reference(self):
        gt = generators.tri_mesh(9, 11)
        gj = jgen.tri_mesh(9, 11)
        es, js = EdgeSlots.from_graph(gt, 1024), JEdgeSlots.from_graph(gj,
                                                                       1024)
        batches = [(mesh_non_edges(5), ()), ((), mesh_non_edges(2)),
                   (mesh_non_edges(40, start=3), mesh_non_edges(3))]
        for ins, dele in batches:
            ik = [u * gt.n + v for u, v in ins]
            dk = [u * gt.n + v for u, v in dele]
            pt = es.apply_delta(edge_delta(gt.n, es.ekeys, ik, dk))
            pj = js.apply_delta(jedge_delta(gj.n, js.ekeys, ik, dk))
            for f in ("slots", "src", "dst", "w", "rows", "inv_deg"):
                np.testing.assert_array_equal(getattr(pt, f),
                                              getattr(pj, f), err_msg=f)
            for f in ("src", "dst", "w64", "live", "deg", "iso_slot",
                      "ekeys", "eslots", "free"):
                np.testing.assert_array_equal(getattr(es, f),
                                              getattr(js, f), err_msg=f)

    def test_device_arrays_never_alias_the_mutable_mirror(self):
        """On the CPU `torch.from_numpy` shares the numpy buffer and the
        mirror mutates its arrays in place on every batch, so the device
        graph must hold private copies, at build and after a bulk patch."""
        g = generators.tri_mesh(9, 11)
        es = EdgeSlots.from_graph(g, 1024)
        dg = es.to_device(device="cpu")
        for k, arr in (("src", es.src), ("dst", es.dst)):
            assert not np.shares_memory(getattr(dg, k).numpy(), arr), k
        src0 = dg.src.clone()
        es.src[:] = -1
        assert torch.equal(dg.src, src0)
        es.src[:len(g.src)] = g.src        # restore
        es.src[len(g.src):] = 0
        # the bulk path: a batch big enough to copy the whole mirror over
        ins = np.array([u * g.n + v for u, v in mesh_non_edges(40)],
                       np.int64)
        p = es.apply_delta(edge_delta(g.n, es.ekeys, ins, ()))
        assert p.slots.size * 64 >= es.cap
        patch_device_graph(dg, p)
        snap = _host(dg)
        es.apply_delta(edge_delta(g.n, es.ekeys, (), ins))  # mutates mirror
        for k, v in snap.items():
            assert torch.equal(getattr(dg, k), v), k

    def test_overflow_returns_none_and_leaves_mirror_untouched(self):
        g = generators.tri_mesh(9, 11)
        es = EdgeSlots.from_graph(g, g.m)    # zero headroom
        keys0, deg0 = es.ekeys.copy(), es.deg.copy()
        d = edge_delta(g.n, es.ekeys,
                       [u * g.n + v for u, v in mesh_non_edges(2)], ())
        assert es.apply_delta(d) is None
        np.testing.assert_array_equal(es.ekeys, keys0)
        np.testing.assert_array_equal(es.deg, deg0)


class TestIncrementalVsRebuildParity:
    """The delta path lands on the same solve as a rebuild (L1 <= 1e-6),
    per engine, and on the reference's key set."""

    @staticmethod
    def _churn(svc, batches):
        for i, b in enumerate(batches):
            svc.update_graph("g", insert=b)
            if i % 2 == 1:
                svc.update_graph("g", delete=b)

    @pytest.mark.parametrize("engine", ENGINES)
    def test_parity_after_churn(self, engine):
        g = generators.tri_mesh(9, 11)
        batches = [mesh_non_edges(3, offset=13, start=7 * i)
                   for i in range(4)]
        svc_inc = service(g, "incremental", engine)
        svc_reb = service(g, "rebuild", engine)
        svc_ref = jservice(jgen.tri_mesh(9, 11), "incremental", engine)
        for svc in (svc_inc, svc_reb, svc_ref):
            self._churn(svc, batches)
        rg_i, rg_r = svc_inc.registry.get("g"), svc_reb.registry.get("g")
        assert svc_inc.stats["incremental_updates"] > 0
        assert rg_i.engine.name == rg_r.engine.name
        np.testing.assert_array_equal(rg_i.keys, rg_r.keys)
        np.testing.assert_array_equal(rg_i.keys,
                                      svc_ref.registry.get("g").keys)
        g_fresh = Graph.from_undirected_edges(g.n, rg_i.keys // g.n,
                                              rg_i.keys % g.n)
        pi_f = solve(device_graph(g_fresh, device="cpu"), g.n, 5)
        assert np.abs(solve(rg_i.engine, g.n, 5) - pi_f).sum() <= 1e-6
        assert np.abs(solve(rg_r.engine, g.n, 5) - pi_f).sum() <= 1e-6

    def test_bucket_boundary_crossing_falls_back_and_stays_correct(self):
        g = generators.tri_mesh(9, 11)
        svc = service(g, "incremental", "coo", max_top_k=4)
        cap0 = svc.registry.get("g").slots.cap
        big = random_non_edges(g, (cap0 - g.m) // 2 + 8, seed=3)
        svc.update_graph("g", insert=big)
        rg = svc.registry.get("g")
        assert not rg.last_update_incremental      # fallback taken
        assert rg.slots.cap > cap0                 # bucket grew
        assert rg.epoch == 1
        g_fresh = Graph.from_undirected_edges(g.n, rg.keys // g.n,
                                              rg.keys % g.n)
        assert np.abs(solve(rg.engine, g.n, 3) - solve(
            device_graph(g_fresh, device="cpu"), g.n, 3)).sum() <= 1e-6
        svc.update_graph("g", delete=big[:4])
        assert svc.registry.get("g").last_update_incremental

    @pytest.mark.parametrize("engine", ["block_ell", "fused"])
    def test_block_ell_refresh_keeps_perm_for_local_delta(self, engine):
        g = generators.tri_mesh(12, 12)
        svc = service(g, "incremental", engine)
        perm0 = svc.registry.get("g").engine.perm.clone()
        svc.update_graph("g", insert=[(0, 20)])
        rg = svc.registry.get("g")
        assert rg.last_update_incremental
        assert torch.equal(rg.engine.perm, perm0)
        assert rg.engine.name == svc.registry.engine_mode.replace(
            "fused", "block_ell_fused")

    def test_coo_engine_shares_the_patched_graph(self):
        g = generators.tri_mesh(9, 11)
        svc = service(g, "incremental", "coo")
        rg = svc.registry.get("g")
        eng0, dg0 = rg.engine, rg.dg
        svc.update_graph("g", insert=[(0, 20)])
        assert rg.engine is eng0 and rg.dg is dg0 and eng0.dg is dg0


class TestNoopUpdates:
    def test_noop_skips_rebuild_epoch_and_cache_flush(self):
        g = generators.tri_mesh(9, 11)
        svc = service(g, "incremental", "coo")
        svc.submit(PPRQuery(qid=0, graph="g", seeds=(50,)))
        svc.run_until_drained()
        assert len(svc.cache) == 1
        rg = svc.registry.get("g")
        engine0, dg0, epoch0 = rg.engine, rg.dg, rg.epoch
        u, v = int(g.src[0]), int(g.dst[0])
        ep = svc.update_graph("g", insert=[(u, v)], delete=[(0, 98)])
        rg = svc.registry.get("g")
        assert ep == epoch0 and rg.epoch == epoch0
        assert rg.engine is engine0 and rg.dg is dg0
        assert len(svc.cache) == 1
        assert svc.stats["updates"] == 1 and svc.stats["noop_updates"] == 1
        hit = svc.submit(PPRQuery(qid=1, graph="g", seeds=(50,)))
        assert hit is not None and hit.cached

    def test_noop_in_rebuild_mode_too(self):
        g = generators.tri_mesh(9, 11)
        svc = service(g, "rebuild", "coo")
        svc.update_graph("g", delete=[(0, 98)])
        assert svc.registry.get("g").epoch == 0


class TestDeleteToEmpty:
    @pytest.mark.parametrize("engine", ENGINES)
    @pytest.mark.parametrize("mode", ["incremental", "rebuild"])
    def test_delete_every_edge_then_reinsert(self, engine, mode):
        g = generators.tri_mesh(5, 7)
        svc = service(g, mode, engine, max_top_k=4)
        keys0 = _undirected_keys(g)
        edges = [(int(k // g.n), int(k % g.n)) for k in keys0]
        svc.update_graph("g", delete=edges)
        rg = svc.registry.get("g")
        assert rg.keys.size == 0
        # every vertex isolated (self-loop patch): P = I, mass stays put
        r = svc.query("g", (3,), top_k=4)
        assert r.indices[0] == 3 and r.scores[0] == pytest.approx(1.0)
        assert np.all(np.isfinite(r.scores))
        pi = cpaa(rg.engine, tol=1e-6).pi.numpy()
        np.testing.assert_allclose(pi, 1.0 / g.n, atol=1e-6)
        svc.update_graph("g", insert=edges)
        rg = svc.registry.get("g")
        np.testing.assert_array_equal(rg.keys, keys0)
        assert np.abs(solve(rg.engine, g.n, 3) - solve(
            device_graph(g, device="cpu"), g.n, 3)).sum() <= 1e-6


class TestSelectiveInvalidation:
    def test_far_entries_survive_near_entries_drop(self):
        g = generators.tri_mesh(13, 17)
        svc = service(g, invalidation_radius=2)
        far_seed, near_seed = 220, 1
        svc.submit(PPRQuery(qid=0, graph="g", seeds=(near_seed,)))
        svc.submit(PPRQuery(qid=1, graph="g", seeds=(far_seed,)))
        svc.run_until_drained()
        ep = svc.update_graph("g", insert=[(0, 35)])
        assert svc.stats["cache_dropped"] == 1
        assert svc.stats["cache_retained"] == 1
        solves = svc.stats["solves"]
        hit = svc.submit(PPRQuery(qid=2, graph="g", seeds=(far_seed,)))
        assert hit is not None and hit.cached and hit.epoch == ep
        assert svc.stats["solves"] == solves
        assert svc.submit(PPRQuery(qid=3, graph="g",
                                   seeds=(near_seed,))) is None

    def test_blanket_default_unchanged(self):
        g = generators.tri_mesh(9, 11)
        svc = service(g)               # invalidation_radius=None
        svc.submit(PPRQuery(qid=0, graph="g", seeds=(90,)))
        svc.run_until_drained()
        svc.update_graph("g", insert=[(0, 20)])
        assert len(svc.cache) == 0 and svc.stats["cache_dropped"] == 1

    def test_retained_entry_accuracy_vs_fresh_solve(self):
        g = generators.tri_mesh(13, 17)
        svc = service(g, invalidation_radius=2)
        far = 212
        svc.submit(PPRQuery(qid=0, graph="g", seeds=(far,), tol=1e-6))
        svc.run_until_drained()
        svc.update_graph("g", insert=[(0, 35)])
        idx, scores = svc.cache.get(("g", 1, (far,), 0.85, 1e-6),
                                    count=False)
        oracle = dense_ppr(svc.registry.get("g").host, 0.85, (far,))
        assert np.max(np.abs(scores - oracle[idx])) < 1e-4

    @pytest.mark.parametrize("radius,extra", [(0, 0), (1, 0), (2, 1),
                                              (0, 2), (3, 2)])
    @pytest.mark.parametrize("walk", ["slots", "csr"])
    def test_hop_neighborhood_matches_reference(self, radius, extra, walk):
        gt, gj = generators.tri_mesh(13, 17), jgen.tri_mesh(13, 17)
        reg = GraphRegistry(device="cpu")
        reg.register("g", gt)
        reg_j = JRegistry()
        reg_j.register("g", gj)
        if walk == "csr":
            reg.get("g").slots = reg_j.get("g").slots = None
        got = reg.hop_neighborhood("g", [0, 120], radius, extra=extra)
        want = reg_j.hop_neighborhood("g", [0, 120], radius, extra=extra)
        for a, b in zip(got if extra else [got], want if extra else [want]):
            np.testing.assert_array_equal(a, b)

    def test_index_consistency_after_selective(self):
        from itertools import chain
        g = generators.tri_mesh(9, 11)
        svc = service(g, invalidation_radius=1)
        for i, s in enumerate([(0,), (50,), (90,)]):
            svc.submit(PPRQuery(qid=i, graph="g", seeds=s))
        svc.run_until_drained()
        svc.update_graph("g", insert=[(0, 20)])
        cache = svc.cache
        assert set(chain.from_iterable(cache._by_graph.values())) == \
            set(cache._d)
        assert cache.stats()["retained"] == cache.retained > 0


class TestRefreshTick:
    def test_near_boundary_entry_refreshes_toward_oracle(self):
        g = generators.tri_mesh(13, 17)
        svc = service(g, invalidation_radius=1, refresh_batch=4,
                      refresh_rounds=30)
        near_boundary = 2              # 2 hops from vertex 0
        svc.submit(PPRQuery(qid=0, graph="g", seeds=(near_boundary,)))
        svc.run_until_drained()
        ep = svc.update_graph("g", insert=[(0, 120)])
        assert len(svc._refresh) == 1
        assert svc.refresh_tick() == 1
        assert svc.stats["refreshes"] == 1
        idx, scores = svc.cache.get(("g", ep, (near_boundary,), 0.85, 1e-4),
                                    count=False)
        oracle = dense_ppr(svc.registry.get("g").host, 0.85,
                           (near_boundary,))
        assert np.max(np.abs(scores - oracle[idx])) < 1e-3

    @pytest.mark.parametrize("engine", ["coo", "fused", "hub_tail"])
    def test_refreshed_entry_matches_reference(self, engine):
        kw = dict(invalidation_radius=1, refresh_batch=4, refresh_rounds=30)
        svc = service(generators.tri_mesh(13, 17), engine=engine, **kw)
        svc_j = jservice(jgen.tri_mesh(13, 17), engine=engine, **kw)
        for s in (svc, svc_j):
            s.query("g", (2,), top_k=8)
            s.update_graph("g", insert=[(0, 120)])
            assert s.refresh_tick() == 1
        key = ("g", 1, (2,), 0.85, 1e-4)
        idx, scores = svc.cache.get(key, count=False)
        idx_j, scores_j = svc_j.cache.get(key, count=False)
        assert idx.dtype == np.int32 and scores.dtype == np.float32
        np.testing.assert_allclose(scores, scores_j, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(idx[:4], idx_j[:4])

    def test_refresh_never_degrades_a_retained_entry(self):
        g = generators.caveman(12, 10, seed=0)   # spread-out PPR mass
        svc = service(g, invalidation_radius=1, refresh_batch=4,
                      refresh_rounds=8)
        seed_v = 25
        svc.submit(PPRQuery(qid=0, graph="g", seeds=(seed_v,)))
        svc.run_until_drained()
        ep = svc.update_graph("g", insert=[(85, 95)])
        key = ("g", ep, (seed_v,), 0.85, 1e-4)
        idx0, s0 = svc.cache.get(key, count=False)
        oracle = dense_ppr(svc.registry.get("g").host, 0.85, (seed_v,))
        before = np.max(np.abs(s0 - oracle[idx0]))
        if len(svc._refresh):
            assert svc.refresh_tick() >= 1
            idx1, s1 = svc.cache.get(key, count=False)
            after = np.max(np.abs(s1 - oracle[idx1]))
            assert after <= max(before, 1e-4) + 1e-6

    def test_superseded_epoch_is_skipped(self):
        g = generators.tri_mesh(13, 17)
        svc = service(g, invalidation_radius=1, refresh_batch=4)
        svc.submit(PPRQuery(qid=0, graph="g", seeds=(2,)))
        svc.run_until_drained()
        svc.update_graph("g", insert=[(0, 120)])
        assert len(svc._refresh) == 1
        svc.update_graph("g", insert=[(2, 121)])
        assert svc.refresh_tick() == 0
        assert svc.stats["refreshes"] == 0

    def test_refresh_yields_to_foreground_work(self):
        g = generators.tri_mesh(13, 17)
        svc = service(g, invalidation_radius=1, refresh_batch=4,
                      async_dispatch=True)
        svc.query("g", (2,))
        svc.update_graph("g", insert=[(0, 120)])
        assert len(svc._refresh) == 1
        svc.submit(PPRQuery(qid=1, graph="g", seeds=(40,)))
        assert svc.refresh_tick() == 0          # queued foreground query
        svc.tick(force=True)                    # now in flight, not done
        assert svc.pending() == 1
        assert svc.refresh_tick() == 0          # in-flight foreground
        assert svc.stats["refresh_deferred"] == 2
        assert len(svc._refresh) == 1
        while svc.pending():
            svc.tick(force=True)
        assert svc.refresh_tick() == 1
        assert svc.stats["refreshes"] == 1


class TestDynamicUpdates:
    def test_update_bumps_epoch_and_invalidates(self):
        g = generators.tri_mesh(9, 11)
        svc = service(g)
        svc.submit(PPRQuery(qid=0, graph="g", seeds=(5, 50), top_k=5))
        stale = svc.run_until_drained()[0]
        assert stale.epoch == 0
        assert svc.update_graph("g", insert=[(5, 90)]) == 1
        assert svc.cache.invalidations == 1
        assert svc.submit(PPRQuery(qid=1, graph="g", seeds=(5, 50),
                                   top_k=5)) is None
        fresh = svc.run_until_drained()[1]
        assert fresh.epoch == 1 and not fresh.cached
        assert not np.allclose(fresh.scores, stale.scores, atol=1e-7)
        oracle = dense_ppr(svc.registry.get("g").host, 0.85, (5, 50))
        np.testing.assert_allclose(fresh.scores, oracle[fresh.indices],
                                   rtol=0, atol=2e-4)

    def test_insert_then_delete_roundtrips(self):
        g = generators.tri_mesh(9, 11)
        svc = service(g)
        keys0 = _undirected_keys(svc.registry.get("g").host)
        svc.update_graph("g", insert=[(0, 77)])
        assert len(_undirected_keys(svc.registry.get("g").host)) == \
            len(keys0) + 1
        svc.update_graph("g", delete=[(77, 0)])  # orientation-insensitive
        np.testing.assert_array_equal(
            _undirected_keys(svc.registry.get("g").host), keys0)
        assert svc.registry.get("g").epoch == 2

    def test_bad_edges_rejected(self):
        svc = service(generators.tri_mesh(9, 11))
        with pytest.raises(ValueError, match="range"):
            svc.update_graph("g", insert=[(0, 99)])
        with pytest.raises(ValueError, match="self loop"):
            svc.update_graph("g", insert=[(3, 3)])
        with pytest.raises(KeyError):
            svc.update_graph("nope", insert=[(0, 1)])
        with pytest.raises(ValueError, match="update_mode"):
            GraphRegistry(update_mode="lazy", device="cpu")


class TestSameStreamAsReference:
    """One query/update stream through both packages' `full_config()`-style
    services: the same dispositions (cached or solved, epoch) per answer,
    scores within 1e-5, and equal counters."""

    @pytest.mark.parametrize("update_mode", ["incremental", "rebuild"])
    def test_dispositions_and_counters(self, update_mode):
        kw = dict(graphs=(("mesh", "NACA0015", 0.3), ("kmer", "kmer-V2",
                                                       0.05)),
                  max_batch=16, max_top_k=8, update_mode=update_mode)
        svc_j = jcfg.make_service(jcfg.PPRServeConfig(**kw))
        svc_t = tcfg.make_service(tcfg.PPRServeConfig(**kw), device="cpu")
        names = svc_t.registry.names()
        rng = np.random.default_rng(5)

        def queries(base, count):
            out = []
            for i in range(count):
                nm = names[int(rng.integers(0, len(names)))]
                n = svc_t.registry.get(nm).n
                seeds = tuple(int(s) for s in rng.choice(n, 2, replace=False))
                out.append((base + i, nm, seeds))
            return out

        stream = [queries(0, 40)]
        for b in range(6):
            nm = names[b % 2]
            n = svc_t.registry.get(nm).n
            ins = [(int(rng.integers(0, n // 2)),
                    int(rng.integers(n // 2, n))) for _ in range(3)]
            stream.append(("update", nm, ins, ins[:1] if b % 2 else []))
            stream.append(queries(100 * (b + 1), 6) + stream[0][b::7])
        res = []
        for svc, qcls in ((svc_j, JQuery), (svc_t, PPRQuery)):
            out = {}
            for step_no, step in enumerate(stream):
                if step[0] == "update":
                    svc.update_graph(step[1], insert=step[2], delete=step[3])
                    continue
                for qid, nm, seeds in step:     # repeats get fresh qids
                    svc.submit(qcls(qid=qid + 10_000 * step_no, graph=nm,
                                    seeds=seeds, top_k=8))
                out.update(svc.run_until_drained())
            res.append(out)
        res_j, res_t = res
        assert sorted(res_j) == sorted(res_t)
        for qid in res_j:
            a, b = res_j[qid], res_t[qid]
            assert (a.cached, a.epoch) == (b.cached, b.epoch), qid
            np.testing.assert_allclose(b.scores, a.scores, rtol=0, atol=1e-5)
        st_j, st_t = svc_j.stats, svc_t.stats
        for key in st_t:
            assert st_t[key] == st_j[key], key
        assert st_t["cache_retained"] > 0 and st_t["refreshes"] > 0
        if update_mode == "incremental":
            assert st_t["incremental_updates"] > 0
