"""The port's sharded engines (`Sharded1DEngine`, `Sharded2DEngine`,
`core.distributed`) against the JAX package, at world sizes 1, 2, 4 and 8.

Mirrors tests/test_sharded_engine.py, tests/test_multidevice.py and
tests/test_partition_padding.py with the reference's own tolerances:
L1 <= 1e-5 against JAX's COO `cpaa`, max relative error < 5e-5 against
`true_pagerank_dense`, apply against JAX's `spmv` at rtol 2e-4 / atol
1e-5, the bf16 wire's rank-stability bounds, and adaptive round counts
equal to the reference's.

World size 1 runs in this process (a single-rank gloo group); 2, 4 (2x2)
and 8 (2x4) run as one spawned group each — the counterpart of the
reference's 8 fake XLA devices. Every rank of a group runs
tests/torch_dist_worker.py's battery over gloo; rank 0 writes the results,
and this process holds them against the JAX package. The three groups
start together, on the first test that needs one.
"""
import json
import os
import pickle
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from repro.configs import pagerank_cpaa as jcpaa_cfg
from repro.core import pagerank as jpr
from repro.core import engine as jeng
from repro.core.chebyshev import make_schedule as jmake_schedule
from repro.graph import generators as jgen
from repro.graph import ops as jops
from repro.graph import partition as jpart
from repro.graph.structure import Graph as JGraph

import torch_dist_worker as W
from repro_torch import interop
from repro_torch.configs import pagerank_cpaa as tcpaa_cfg
from repro_torch.core import distributed as tdist
from repro_torch.core import pagerank as tpr

HERE = Path(__file__).resolve().parent
SRC = HERE.parent / "src"
WORLDS = (1, 2, 4, 8)
SPAWNED = (2, 4, 8)
KINDS = W.KINDS
GNAMES = sorted(W.GRAPHS)
JGRAPHS = {
    "mesh": lambda: jgen.tri_mesh(9, 11),
    "powerlaw": lambda: jgen.powerlaw_ba(120, 3, seed=2),
    "kmer": lambda: jgen.kmer_chains(200, seed=4),
}


def _l1(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).sum(axis=0).max())


def _free_ports(count: int) -> list[int]:
    """`count` distinct free localhost ports (all held open while picked)."""
    socks = [socket.socket() for _ in range(count)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


class _Group:
    """One spawned gloo group running the worker battery."""

    def __init__(self, ws: int, out: Path, port: int):
        self.ws, self.out = ws, out
        self.procs = []
        for r in range(ws):
            env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(ws),
                       LOCAL_RANK=str(r), MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                       PYTHONPATH=str(SRC) + os.pathsep
                       + os.environ.get("PYTHONPATH", ""))
            self.procs.append(subprocess.Popen(
                [sys.executable, str(HERE / "torch_dist_worker.py"),
                 str(out)], env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        self.t0 = time.perf_counter()
        self._result = None

    def result(self, timeout: float = 300.0) -> dict:
        if self._result is None:
            errs = []
            for r, p in enumerate(self.procs):
                left = max(1.0, timeout - (time.perf_counter() - self.t0))
                try:
                    out, err = p.communicate(timeout=left)
                except subprocess.TimeoutExpired:
                    for q in self.procs:
                        q.kill()
                    raise AssertionError(f"world {self.ws}: rank {r} timed "
                                         f"out after {timeout} s")
                if p.returncode != 0:
                    errs.append(f"rank {r} rc {p.returncode}\n{out}\n{err}")
            assert not errs, "\n".join(errs)
            with open(self.out / "results.pkl", "rb") as f:
                res = pickle.load(f)
            res["ranks"] = [json.loads((self.out / f"rank{r}.json")
                                       .read_text()) for r in range(self.ws)]
            self._result = res
        return self._result


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ports = _free_ports(len(SPAWNED))
    groups = {ws: _Group(ws, tmp_path_factory.mktemp(f"world{ws}"), port)
              for ws, port in zip(SPAWNED, ports)}
    cache = {}

    def get(ws: int) -> dict:
        if ws not in cache:
            if ws == 1:
                tdist.init_process_group("cpu")
                assert tdist.world_size() == 1
                tmp = tmp_path_factory.mktemp("world1")
                res = W.battery(1, 0, tmp)
                res["ranks"] = [{"digest": W.digest(res)}]
                cache[1] = res
            else:
                cache[ws] = groups[ws].result()
        return cache[ws]
    yield get
    for grp in groups.values():
        for p in grp.procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.fixture(scope="module")
def refs():
    """The JAX package's answers on one device, per case."""
    out = {}
    for gname, make in JGRAPHS.items():
        g = make()
        dg = jops.device_graph(g)
        out[("vec", gname)] = np.asarray(jpr.cpaa(dg, 0.85, 1e-8).pi)
        out[("oracle", gname)] = jpr.true_pagerank_dense(g, 0.85)
        r = jpr.cpaa_adaptive(dg, 0.85, 1e-8)
        out[("adaptive", gname)] = (np.asarray(r.pi), r.iterations)
    g = JGRAPHS["mesh"]()
    dg = jops.device_graph(g)
    p = W.seeded_p(g.n, 4, 3)
    out["batched"] = np.asarray(jpr.cpaa(dg, 0.85, 1e-8,
                                         p=jnp.asarray(p)).pi)
    out["batched_oracle"] = np.asarray(jpr.true_pagerank_dense(g, 0.85, p=p))
    r = jpr.cpaa_adaptive(dg, 0.85, 1e-8,
                          p=jnp.asarray(W.seeded_p(g.n, 4, 5, True)))
    out["adaptive_batched"] = (np.asarray(r.pi),
                               np.asarray(r.column_rounds))
    r = jpr.power(dg, 0.85, tol=1e-6)
    out["power"] = (np.asarray(r.pi), r.iterations)
    out["forward_push"] = np.asarray(jpr.forward_push(dg, 0.85,
                                                      rounds=30).pi)
    x0 = W.seeded_p(g.n, 3, 7) + 0.01
    out["power_refine"] = np.asarray(jpr.power_refine(
        dg, jnp.asarray(x0), jnp.asarray(W.seeded_p(g.n, 3, 8)), 0.85, 20))
    x = np.random.default_rng(2).standard_normal(g.n).astype(np.float32)
    out["apply"] = np.asarray(jops.spmv(dg, jnp.asarray(x)))
    g = jgen.tri_mesh(23, 31)
    sched = jmake_schedule(0.85, 1e-8)
    dg = jops.device_graph(g)
    out["md"] = np.asarray(jpr.cpaa(dg, 0.85, schedule=sched).pi,
                           np.float64)
    rng = np.random.default_rng(0)   # the worker's batched columns
    pm = np.zeros((g.n, 4), np.float32)
    for b in range(4):
        pm[rng.integers(0, g.n), b] = 1.0
    out["md_batched"] = (pm, np.stack(
        [np.asarray(jpr.cpaa(dg, 0.85, schedule=sched,
                             p=jnp.asarray(pm[:, b])).pi) for b in range(4)],
        1))
    return out


def _serve_oracle(n, keys, seeds):
    g = JGraph.from_undirected_edges(n, keys // n, keys % n)
    p = np.zeros(n)
    p[list(seeds)] = 1.0 / len(seeds)
    return jpr.true_pagerank_dense(g, 0.85, p=p)


class TestShardedParity:
    @pytest.mark.parametrize("ws", WORLDS)
    @pytest.mark.parametrize("kind", KINDS)
    @pytest.mark.parametrize("gname", GNAMES)
    def test_vector_matches_coo_and_oracle(self, runs, refs, gname, kind,
                                           ws):
        pi = runs(ws)[("vec", gname, kind)].astype(np.float64)
        truth = refs[("oracle", gname)]
        assert pi.shape == truth.shape
        assert _l1(pi, refs[("vec", gname)]) <= 1e-5
        assert np.max(np.abs(pi - truth) / truth) < 5e-5

    @pytest.mark.parametrize("ws", WORLDS)
    @pytest.mark.parametrize("kind", KINDS)
    @pytest.mark.parametrize("gname", GNAMES)
    def test_adaptive_matches_coo_rounds_and_cap(self, runs, refs, gname,
                                                 kind, ws):
        pi, iters, bound = runs(ws)[("adaptive", gname, kind)]
        ref_pi, ref_iters = refs[("adaptive", gname)]
        assert _l1(pi, ref_pi) <= 1e-5
        truth = refs[("oracle", gname)]
        assert np.max(np.abs(pi.astype(np.float64) - truth) / truth) < 5e-5
        assert iters == ref_iters <= bound

    @pytest.mark.parametrize("ws", WORLDS)
    @pytest.mark.parametrize("kind", KINDS)
    def test_batched_matches_coo(self, runs, refs, kind, ws):
        pi = runs(ws)[("batched", kind)]
        np.testing.assert_allclose(pi, refs["batched"], rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(pi, refs["batched_oracle"], rtol=1e-4,
                                   atol=1e-7)

    @pytest.mark.parametrize("ws", WORLDS)
    @pytest.mark.parametrize("kind", KINDS)
    def test_adaptive_batched_column_masks(self, runs, refs, kind, ws):
        pi, col_rounds, bound = runs(ws)[("adaptive_batched", kind)]
        ref_pi, ref_rounds = refs["adaptive_batched"]
        np.testing.assert_allclose(pi, ref_pi, rtol=1e-5, atol=1e-7)
        np.testing.assert_array_equal(col_rounds, ref_rounds)
        assert int(col_rounds.max()) <= bound

    @pytest.mark.parametrize("ws", WORLDS)
    @pytest.mark.parametrize("kind", KINDS)
    def test_power_forward_push_and_refine(self, runs, refs, kind, ws):
        res = runs(ws)
        pi, iters = res[("power", kind)]
        ref_pi, ref_iters = refs["power"]
        # the residual steps by ~1e-7 in f32: at tol 1e-6 the summation
        # order may move the stop by one round (tests/test_torch_solvers.py)
        assert abs(iters - ref_iters) <= 1
        assert _l1(pi, ref_pi) <= 1e-5
        assert _l1(res[("forward_push", kind)], refs["forward_push"]) <= 1e-5
        np.testing.assert_allclose(res[("power_refine", kind)],
                                   refs["power_refine"], rtol=1e-5,
                                   atol=1e-7)


class TestShardedLayout:
    @pytest.mark.parametrize("ws", WORLDS)
    @pytest.mark.parametrize("kind", KINDS)
    def test_to_from_internal_is_identity(self, runs, kind, ws):
        same, n, n_pad = runs(ws)[("identity", kind)]
        assert same == [True, True]
        assert n_pad >= n == 120

    @pytest.mark.parametrize("ws", WORLDS)
    @pytest.mark.parametrize("kind", KINDS)
    def test_apply_matches_coo_spmv(self, runs, refs, kind, ws):
        np.testing.assert_allclose(runs(ws)[("apply", kind)], refs["apply"],
                                   rtol=2e-4, atol=1e-5)

    @pytest.mark.parametrize("ws", WORLDS)
    @pytest.mark.parametrize("kind", KINDS)
    def test_collectives_per_apply(self, runs, kind, ws):
        """1D: one all-gather of n_pad * B * 4 bytes. 2D: one reduce-scatter
        on the column group (n_pad / R rows in) and one all-gather on the
        row group (n_pad / C rows out) — the counterpart of the
        reference's "the HLO has a reduce-scatter" check."""
        counts, n_pad = runs(ws)[("counts", kind)]
        b = 3 * 4
        if kind == "1d":
            assert counts == {"sharded_1d/apply/all_gather/world":
                              {"calls": 1, "bytes": n_pad * b}}
        else:
            r, c = W.factor_grid(ws)
            assert counts == {
                "sharded_2d/apply/reduce_scatter/col":
                    {"calls": 1, "bytes": n_pad // r * b},
                "sharded_2d/apply/all_gather/row":
                    {"calls": 1, "bytes": n_pad // c * b}}

    @pytest.mark.parametrize("ws", WORLDS)
    @pytest.mark.parametrize("kind", KINDS)
    def test_solve_at_exact_padding_boundary(self, runs, kind, ws):
        pi, n_pad, n = runs(ws)[("padding", kind)]
        assert n_pad == n
        truth = jpr.true_pagerank_dense(_ring(n), 0.85)
        np.testing.assert_allclose(pi.astype(np.float64), truth, rtol=5e-5,
                                   atol=1e-9)

    @pytest.mark.parametrize("ws", WORLDS)
    def test_every_rank_holds_the_same_answers(self, runs, ws):
        ranks = runs(ws)["ranks"]
        assert len(ranks) == ws
        assert len({r["digest"] for r in ranks}) == 1


def _ring(n):
    u = np.arange(n, dtype=np.int64)
    return JGraph.from_undirected_edges(
        n, np.concatenate([u, [0]]), np.concatenate([(u + 1) % n, [n // 2]]))


class TestDistributedBuilders:
    @pytest.mark.parametrize("ws", WORLDS)
    @pytest.mark.parametrize("kind", KINDS)
    def test_adaptive_and_fixed_agree(self, runs, refs, kind, ws):
        pi_a, pi_f = runs(ws)[("builder", kind)]
        assert _l1(pi_a, pi_f) <= 1e-5
        if kind == "1d":
            assert _l1(pi_f, refs[("vec", "mesh")]) <= 1e-5

    @pytest.mark.parametrize("ws", WORLDS)
    def test_1d_matches_single_device(self, runs, refs, ws):
        pi = runs(ws)[("md", "1d")].astype(np.float64)
        assert np.max(np.abs(pi - refs["md"]) / refs["md"]) < 1e-5

    @pytest.mark.parametrize("ws", WORLDS)
    def test_1d_batched_personalization(self, runs, refs, ws):
        pi, pm = runs(ws)[("md", "1d_batched")]
        np.testing.assert_array_equal(pm, refs["md_batched"][0])
        assert float(np.max(np.abs(pi - refs["md_batched"][1]))) < 1e-5

    @pytest.mark.parametrize("ws", WORLDS)
    def test_2d_matches_single_device(self, runs, refs, ws):
        pi, counts = runs(ws)[("md", "2d")]
        pi = pi.astype(np.float64)
        assert np.max(np.abs(pi - refs["md"]) / refs["md"]) < 1e-5
        assert counts["sharded_2d/apply/reduce_scatter/col"]["calls"] == \
            counts["sharded_2d/apply/all_gather/row"]["calls"] > 0

    @pytest.mark.parametrize("ws", WORLDS)
    def test_2d_bf16_transport_rank_stable(self, runs, refs, ws):
        """bf16 wire format: error bounded for 1e-2-tolerance targets and
        the top decile preserved; the row all-gather moves half the
        bytes of the f32 run's."""
        res = runs(ws)
        pi, counts = res[("md", "2d_bf16")]
        ref = refs["md"]
        n = ref.shape[0]
        assert np.max(np.abs(pi.astype(np.float64) - ref) / ref) < 2e-2
        top = set(np.argsort(-ref)[: n // 10].tolist())
        top_b = set(np.argsort(-pi)[: n // 10].tolist())
        assert len(top & top_b) / len(top) >= 0.95
        f32 = res[("md", "2d")][1]["sharded_2d/apply/all_gather/row"]
        b16 = counts["sharded_2d/apply/all_gather/row"]
        assert b16["calls"] == f32["calls"]
        assert 2 * b16["bytes"] == f32["bytes"]


class TestShardedSelection:
    @pytest.mark.parametrize("ws", WORLDS)
    def test_auto_branches(self, runs, ws):
        res = runs(ws)
        # tri_mesh(9, 11): n = 99, the bars lowered instead of building 64k
        assert res[("auto", "low_bar")] == (
            "sharded_2d" if ws >= 4 else "sharded_1d" if ws >= 2 else "coo")
        assert res[("auto", "between_bars")] == (
            "sharded_1d" if ws >= 2 else "coo")
        assert res[("auto", "default_bar")] == "coo"

    @pytest.mark.parametrize("ws", WORLDS)
    def test_tuned_decision_is_rank_0s(self, runs, ws):
        res = runs(ws)
        mode, name, candidates = res[("tuned",)]
        assert name == {"fused": "block_ell_fused"}.get(mode, mode)
        want = {"coo", "fused"} | ({"sharded_1d"} if ws >= 2 else set()) \
            | ({"sharded_2d"} if ws >= 4 else set())
        assert set(candidates) == want
        assert {tuple(r.get("tuned", [mode, name])) for r in res["ranks"]} \
            == {(mode, name)}

    def test_cuda_mesh_never_runs_on_gloo(self, runs, monkeypatch):
        runs(1)    # a single-rank gloo group is up
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.distributed, "is_nccl_available",
                            lambda: False)
        with pytest.raises(RuntimeError, match="NCCL"):
            tdist.init_mesh((1,), ("dev",), device="cuda")
        monkeypatch.setattr(torch.distributed, "is_nccl_available",
                            lambda: True)
        with pytest.raises(RuntimeError, match="nccl process group"):
            tdist.init_mesh((1,), ("dev",), device="cuda")


class TestShardedServe:
    @pytest.mark.parametrize("ws", WORLDS)
    @pytest.mark.parametrize("mode", ["sharded-1d", "sharded-2d"])
    def test_service_answers_match_oracle(self, runs, mode, ws):
        """sharded-1d under FIFO, sync; sharded-2d under the deadline
        scheduler with async dispatch. Answers before and after an edge
        update (epoch bump: the partition is rebuilt on the same mesh)
        against the dense oracle of the graph of their epoch."""
        res = runs(ws)
        out = res[("serve", mode)]
        assert out["engine"] == mode.replace("-", "_")
        assert out["rebuilt"] and out["epoch"] == 1
        n = 72
        keys0 = W.generators.tri_mesh(8, 9)
        k0 = np.unique(np.minimum(keys0.src, keys0.dst).astype(np.int64) * n
                       + np.maximum(keys0.src, keys0.dst))
        k0 = k0[k0 // n != k0 % n]
        seeds_of = dict(enumerate(W.SERVE_SEEDS))
        seeds_of.update({100 + i: s
                         for i, s in enumerate(W.SERVE_SEEDS_AFTER)})
        assert set(out["answers"]) == set(seeds_of)
        for qid, (idx, scores, epoch) in out["answers"].items():
            assert epoch == (1 if qid >= 100 else 0)
            keys = k0 if epoch == 0 else out["keys"]
            oracle = _serve_oracle(n, keys, seeds_of[qid])
            assert set(idx.tolist()) == \
                set(np.argsort(-oracle, kind="stable")[:8].tolist())
            np.testing.assert_allclose(scores, oracle[idx], rtol=1e-4,
                                       atol=1e-6)
        st = out["stats"]
        assert st["queries"] == st["cache_hits"] + st["solved_queries"]
        for r in res["ranks"][1:]:
            # each follower ran every plan: 3 solves, 1 update, 1 refresh
            assert r["followed"][mode] == st["solves"] + st["updates"] + \
                st["refreshes"]

    @pytest.mark.parametrize("ws", WORLDS)
    @pytest.mark.parametrize("mode", ["sharded-1d", "sharded-2d"])
    def test_sharded_registry_uploads_no_whole_graph(self, runs, mode, ws):
        """Every rank's registry keeps no whole-graph DeviceGraph under a
        sharded engine — at registration, and after the update batch (which
        patches only the host mirror) — so each card holds its shard
        alone."""
        res = runs(ws)
        for r, rec in enumerate(res["ranks"]):
            flags = res[("serve", mode, "no_dg")] if r == 0 else \
                rec["no_dg"][mode]
            assert flags == [True, True], (r, flags)

    @pytest.mark.parametrize("ws", WORLDS)
    def test_tuned_sharded_winner_drops_whole_graph(self, runs, ws):
        """A tuned registry uploads the whole graph to measure COO, and
        keeps it only when a single-card engine wins."""
        no_dg, sharded = runs(ws)[("tuned", "no_dg")]
        assert no_dg == sharded

    @pytest.mark.parametrize("ws", [w for w in WORLDS if w > 1])
    def test_lockstep_plans_ride_a_host_only_group(self, runs, ws):
        """The plans and decisions travel over one gloo group of their
        own, never over the world's group (NCCL on cuda, whose object
        collectives would stage the pickle on the card behind the batch in
        flight)."""
        backend, separate, cached = runs(ws)[("host_group",)]
        assert backend == "gloo" and separate and cached

    @pytest.mark.parametrize("ws", WORLDS)
    def test_launcher_rank_0_serves_and_prints(self, runs, ws):
        res = runs(ws)
        st, text = res[("launcher",)]
        assert st["engines"] == {"mesh": "sharded_2d"}
        assert st["served"] >= 6 and st["updates"] == 1
        assert "warm graphs + engines" in text
        for r in res["ranks"][1:]:
            follower_st, follower_text = r["launcher"]
            assert follower_text == ""
            assert follower_st == {"followed": st["solves"] + st["updates"]
                                   + st["refreshes"]}


class TestWorldOneAgainstJaxSharded:
    """World size 1: the port's engines over the reference's own partition
    arrays (`interop`) against JAX's sharded engines on a 1-device mesh."""

    @pytest.mark.parametrize("kind", KINDS)
    @pytest.mark.parametrize("gname", GNAMES)
    def test_interop_engine_matches_jax_sharded(self, runs, gname, kind):
        runs(1)
        gj = JGRAPHS[gname]()
        devs = np.asarray(jax.devices()[:1])
        if kind == "1d":
            je = jeng.Sharded1DEngine.from_graph(
                gj, mesh=Mesh(devs, ("dev",)), lane=4)
            part = jpart.partition_1d(gj, 1, lane=4)
            te = interop.sharded_1d_engine(part.src, part.dst_local,
                                           part.weight, gj.n, part.n,
                                           part.rows_per_dev, device="cpu")
        else:
            je = jeng.Sharded2DEngine.from_graph(
                gj, mesh=Mesh(devs.reshape(1, 1), ("row", "col")),
                grid=(1, 1), lane=4)
            part = jpart.partition_2d(gj, (1, 1), lane=4)
            te = interop.sharded_2d_engine(
                part.src_local, part.dst_local, part.weight,
                jpart.col_layout_perm(part.n, part.grid), gj.n, part.n,
                part.rows_per_chunk, device="cpu")
        assert (te.n, te.n_pad) == (je.n, je.n_pad)
        pj = np.asarray(jpr.cpaa(je, 0.85, 1e-8).pi)
        assert _l1(tpr.cpaa(te, 0.85, 1e-8).pi.numpy(), pj) <= 1e-5
        rj = jpr.cpaa_adaptive(je, 0.85, 1e-8)
        rt = tpr.cpaa_adaptive(te, 0.85, 1e-8)
        assert rt.iterations == rj.iterations
        x = np.random.default_rng(1).standard_normal(gj.n).astype(np.float32)
        yj = np.asarray(je.from_internal(je.apply(je.to_internal(
            jnp.asarray(x)))))
        yt = te.from_internal(te.apply(te.to_internal(torch.from_numpy(x))))
        np.testing.assert_allclose(yt.numpy(), yj, rtol=2e-4, atol=1e-5)


class TestCpaaConfig:
    def test_constants_and_shapes_match_reference(self):
        for name in ("NAME", "FAMILY", "C", "TOL", "LANE", "IMBALANCE",
                     "ENGINE", "MESH_GRID", "PARTITION_LANE", "ADAPTIVE",
                     "ADAPTIVE_CHUNK", "SHAPES"):
            assert getattr(tcpaa_cfg, name) == getattr(jcpaa_cfg, name), name
        assert tcpaa_cfg.full_config() == jcpaa_cfg.full_config()
        assert tcpaa_cfg.smoke_config() == jcpaa_cfg.smoke_config()

    @pytest.mark.parametrize("shape", sorted(jcpaa_cfg.SHAPES))
    def test_abstract_partitions_and_flops_match(self, shape):
        info = jcpaa_cfg.SHAPES[shape]
        n, m = info["n"], int(info["n"] * info["deg"])
        for n_dev in (8, 256):
            assert vars(tcpaa_cfg.abstract_partition_1d(n, m, n_dev)) == \
                vars(jcpaa_cfg.abstract_partition_1d(n, m, n_dev))
        for grid in ((2, 4), (16, 16)):
            assert vars(tcpaa_cfg.abstract_partition_2d(n, m, grid)) == \
                vars(jcpaa_cfg.abstract_partition_2d(n, m, grid))
        assert tcpaa_cfg.model_flops(n, m, 12, info["batch"]) == \
            jcpaa_cfg.model_flops(n, m, 12, info["batch"])

    def test_smoke_run_meets_the_reference(self):
        ref = jcpaa_cfg.smoke_run()
        out = tcpaa_cfg.smoke_run(device="cpu")
        assert set(ref) <= set(out)
        assert out["max_rel_err"] < 5e-5 and ref["max_rel_err"] < 5e-5
        assert out["adaptive_max_rel_err"] < 5e-5
        for key in ("adaptive_rounds", "adaptive_rounds_bound", "loss"):
            assert float(out[key]) == float(ref[key]), key
