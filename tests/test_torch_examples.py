"""The four examples' launchers (`repro_torch.launch.{quickstart,
serve_pagerank, serve_lm, distributed_pagerank}`) against the reference's
examples on the same inputs, on the CPU:

* quickstart: CPAA, power, forward push and the batched PPR within L1 1e-5
  of the reference's calls, the same round counts where the round count is
  fixed by the schedule;
* serve_pagerank: the same service stats (solves, cache hits,
  invalidations, epochs) and top-5 scores within 1e-5 for every query;
* serve_lm: tokens identical to the reference's engine, with the
  reference's parameters carried over by `interop.lm_params`;
* distributed_pagerank: world size 1 in process and one spawned gloo group
  of 2, the sharded engines within rel err 1e-5 of the single-device solve,
  and the same auto pick as the reference;
* every launcher raises without `--device` on a host without a GPU.
"""
import importlib
import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.core import (cpaa as jcpaa, forward_push as jforward_push,
                        make_schedule as jmake_schedule, power as jpower,
                        select_engine as jselect_engine)
from repro.graph import generators as jgen
from repro.graph.ops import device_graph as jdevice_graph
from repro.models import transformer as jtf
from repro.serve import GraphRegistry as JRegistry
from repro.serve import PageRankService as JService
from repro.serve import PPRQuery as JQuery
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine

from repro_torch import interop
from repro_torch.launch import (distributed_pagerank, quickstart, serve_lm,
                                serve_pagerank)

REPO = Path(__file__).resolve().parent.parent
L1 = 1e-5
SCALE = 0.3      # delaunay-n21 at tri_mesh(43, 43): n = 1,849


def _l1(a, b) -> float:
    a = np.asarray(a, np.float64).reshape(len(a), -1)
    b = np.asarray(b, np.float64).reshape(len(b), -1)
    return float(np.abs(a - b).sum(axis=0).max())


def _quiet(msg):
    pass


class TestQuickstart:
    @pytest.fixture(scope="class")
    def both(self):
        out = quickstart.main(["--device", "cpu"])
        g = jgen.tri_mesh(30, 40)
        dg = jdevice_graph(g)
        sched = jmake_schedule(0.85, tol=1e-6)
        seeds = [0, g.n // 2, g.n - 1]
        p = np.zeros((g.n, len(seeds)), np.float32)
        for j, s in enumerate(seeds):
            p[s, j] = 1.0
        ref = {"cpaa": jcpaa(dg, c=0.85, schedule=sched),
               "power": jpower(dg, c=0.85, tol=1e-12),
               "forward-push": jforward_push(dg, c=0.85,
                                             rounds=sched.rounds),
               "ppr": jcpaa(dg, c=0.85, schedule=sched, p=jnp.asarray(p)),
               "rounds": sched.rounds}
        return out, ref

    def test_cpaa_matches_reference(self, both):
        out, ref = both
        assert out["rounds"] == ref["rounds"]
        assert out["iterations"]["cpaa"] == ref["cpaa"].iterations
        assert _l1(out["pi"], ref["cpaa"].pi) <= L1
        assert out["errors"]["cpaa"] <= 1e-4      # vs the dense solve

    def test_baselines_match_reference(self, both):
        out, ref = both
        assert out["iterations"]["forward-push"] == \
            ref["forward-push"].iterations
        # power runs to tol 1e-12, below float32's resolution of these
        # scores (~1e-10): rounding picks its stop round, so the counts
        # sit a few rounds apart while the vectors agree
        assert abs(out["iterations"]["power"] - ref["power"].iterations) \
            <= 8
        assert out["errors"]["power"] <= 1e-5
        assert out["errors"]["forward-push"] <= 1e-2
        # Monte Carlo: the same walk count and length, its own generator
        assert out["errors"]["monte-carlo"] < 1.0

    def test_batched_ppr_matches_reference(self, both):
        out, ref = both
        assert _l1(out["ppr_pi"], ref["ppr"].pi) <= L1
        col = np.asarray(ref["ppr"].pi)
        for j, (s, mass, nbr) in enumerate(out["ppr"]):
            assert mass == pytest.approx(float(col[s, j]), abs=1e-5)
            assert nbr == int(np.argsort(-col[:, j], kind="stable")[1])


def _reference_serve_pagerank() -> dict:
    """The reference example's flow (examples/serve_pagerank.py), kept as
    data instead of prints."""
    registry = JRegistry()
    registry.register("mesh", jgen.tri_mesh(40, 50))
    registry.register("social", jgen.powerlaw_ba(1500, 4, seed=1))
    svc = JService(registry, max_batch=16, cache_capacity=1024, max_top_k=8)
    rng = np.random.default_rng(0)
    queries = []
    for i in range(24):
        name = "mesh" if i % 2 else "social"
        n = registry.get(name).host.n
        seeds = tuple(int(s) for s in rng.choice(n, 2, replace=False))
        queries.append(JQuery(qid=i, graph=name, seeds=seeds, top_k=5))
    for q in queries:
        svc.submit(q)
    results = svc.run_until_drained()
    r0 = results[0]
    again = svc.submit(JQuery(qid=100, graph=r0.graph,
                              seeds=queries[0].seeds, top_k=5))
    hub = int(r0.indices[0])
    n0 = registry.get(r0.graph).host.n
    epoch = svc.update_graph(r0.graph, insert=[(hub, (hub + n0 // 2) % n0)])
    fresh = svc.query(r0.graph, queries[0].seeds, top_k=5)
    return {"results": results, "again": again, "epoch": epoch,
            "fresh": fresh, "stats": svc.stats, "cache": svc.cache.stats()}


class TestServePagerank:
    @pytest.fixture(scope="class")
    def both(self):
        return serve_pagerank.run("cpu", log=_quiet), \
            _reference_serve_pagerank()

    def test_stats_match_reference(self, both):
        out, ref = both
        for k in ("queries", "cache_hits", "solves", "solved_queries",
                  "updates"):
            assert out["stats"][k] == ref["stats"][k], k
        assert out["cache"]["invalidations"] == ref["cache"]["invalidations"]
        assert out["cache"]["hits"] == ref["cache"]["hits"] == 1
        assert out["epoch"] == ref["epoch"] == 1
        assert out["fresh"].epoch == ref["fresh"].epoch == 1
        assert out["again"].cached and ref["again"].cached
        assert not out["fresh"].cached

    def test_every_query_answered_within_tolerance(self, both):
        out, ref = both
        assert sorted(out["results"]) == sorted(ref["results"]) == \
            list(range(24))
        for qid, r in out["results"].items():
            np.testing.assert_allclose(r.scores, ref["results"][qid].scores,
                                       atol=1e-5, rtol=0)
        np.testing.assert_allclose(out["fresh"].scores, ref["fresh"].scores,
                                   atol=1e-5, rtol=0)


class TestServeLm:
    def test_tokens_identical_to_reference(self):
        cfg = jget("h2o-danube-1.8b").smoke_config()
        params = jax.tree.map(np.asarray,
                              jtf.init_params(jax.random.PRNGKey(0), cfg))
        out = serve_lm.run("cpu", params=interop.lm_params(params,
                                                           device="cpu"),
                           log=_quiet)
        rng = np.random.default_rng(0)
        ref = [JRequest(rid=i,
                        prompt=rng.integers(0, cfg.vocab, rng.integers(
                            3, 12)).astype(np.int32),
                        max_new_tokens=int(rng.integers(4, 12)))
               for i in range(10)]
        JEngine(params, cfg, max_batch=4, max_len=64).run_until_drained(ref)
        assert len(out["requests"]) == 10
        for r, j in zip(out["requests"], ref):
            np.testing.assert_array_equal(r.prompt, j.prompt)
            assert r.done and r.out_tokens == j.out_tokens, r.rid

    def test_random_weights_drain(self):
        out = serve_lm.main(["--device", "cpu"])
        assert all(r.done and len(r.out_tokens) >= r.max_new_tokens
                   for r in out["requests"])


def _free_port() -> int:
    s = socket.socket()
    try:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
    finally:
        s.close()


def _reference_auto(scale: float) -> str:
    return jselect_engine(jgen.paper_dataset("delaunay-n21", scale),
                          lane=8).name


class TestDistributedPagerank:
    def test_world_size_one_in_process(self):
        before = torch.distributed.is_initialized()
        out = distributed_pagerank.run("cpu", scale=SCALE, log=_quiet)
        assert out["world_size"] == 1 and out["grid"] == (1, 1)
        assert out["err_1d"] <= 1e-5 and out["err_2d"] <= 1e-5
        # a group it started is gone; one it found is left to its owner
        assert torch.distributed.is_initialized() == before
        g = jgen.paper_dataset("delaunay-n21", SCALE)
        assert (out["n"], out["m"]) == (g.n, g.m)
        ref = np.asarray(jcpaa(jdevice_graph(g),
                               schedule=jmake_schedule(0.85, 1e-6)).pi)
        assert _l1(out["pi_ref"], ref) <= L1
        assert out["auto"] == _reference_auto(SCALE)

    def test_gloo_group_of_two(self):
        port = _free_port()
        procs = []
        for r in range(2):
            env = dict(os.environ, RANK=str(r), WORLD_SIZE="2",
                       LOCAL_RANK=str(r), MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                       PYTHONPATH=str(REPO / "src"))
            procs.append(subprocess.Popen(
                [sys.executable, "-m",
                 "repro_torch.launch.distributed_pagerank", "--device",
                 "cpu", "--scale", str(SCALE)], cwd=REPO, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        outs = []
        try:
            for p in procs:
                out, err = p.communicate(timeout=120)
                assert p.returncode == 0, err[-3000:]
                outs.append(out)
        finally:
            for p in procs:
                p.kill()
        text = outs[0]
        assert outs[1] == ""                     # rank 0 alone prints
        assert "ranks: 2 (gloo on cpu)" in text
        errs = [float(x) for x in re.findall(
            r"max rel err vs single-device (\S+)", text)]
        assert len(errs) == 2 and max(errs) <= 1e-5, text
        assert "grid (1, 2)" in text
        auto = re.search(r"picks: (\S+)", text).group(1)
        # below the sharding bar the pick does not depend on the ranks
        assert auto == _reference_auto(SCALE)


@pytest.mark.parametrize("name", ["quickstart", "serve_pagerank", "serve_lm",
                                  "distributed_pagerank"])
def test_examples_need_a_device_without_a_gpu(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"repro_torch.launch.{name}")
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main([])
