"""The port's observability layer (`repro_torch.obs` and the service's
wiring) against the reference's (`repro.obs`, `repro.serve`).

The metric primitives, traces, convergence log and exposition are copies:
the same sequence of instrument operations must give byte-identical
Prometheus text and equal snapshots in both packages. The service wiring
is held to the reference by running one query/update stream, on a fake
clock and the same engines, through both services: the counter families,
their label sets, the histogram counts and the per-tick rounds used and
bound must be equal, the per-tick residuals within rtol 1e-4 (both solves
sum in f32, in different orders). The rest mirrors `tests/test_obs.py` on
the port.
"""
import ast
import inspect
import json
import subprocess
import sys
import textwrap
import urllib.request
import warnings
from pathlib import Path

import numpy as np
import pytest

from repro.graph import generators as jgen
from repro.obs import export as jexport
from repro.obs import metrics as jmetrics
from repro.serve import GraphRegistry as JRegistry
from repro.serve import PageRankService as JService
from repro.serve import PPRQuery as JQuery

from repro_torch.graph import generators
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs.convergence import (ConvergenceLog, TickTelemetry,
                                         UpdateTelemetry)
from repro_torch.obs.export import (MetricsServer, SNAPSHOT_SCHEMA,
                                    render_summary, snapshot, to_prometheus,
                                    validate_snapshot)
from repro_torch.obs.metrics import Histogram, MetricsRegistry, NULL_REGISTRY
from repro_torch.obs.trace import NULL_TRACE, Trace, Tracer, profiled
from repro_torch.serve import pagerank_service as tsvc_mod
from repro_torch.serve import (GraphRegistry, PageRankService, PPRQuery,
                               ServeMetrics)

REPO = Path(__file__).resolve().parent.parent


def make_service(g, **kw):
    registry = GraphRegistry(device="cpu")
    registry.register("g", g)
    defaults = dict(max_batch=8, cache_capacity=64, max_top_k=8)
    defaults.update(kw)
    return PageRankService(registry, **defaults)


class FakeClock:
    """Deterministic service clock: every read advances 1 ms."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1e-3
        return self.t


# ---------------------------------------------------------------------------
# the same instrument operations in both packages
# ---------------------------------------------------------------------------

def _drive_registry(mod, seed: int):
    """A seeded sequence of counter/gauge/histogram operations."""
    reg = mod.MetricsRegistry()
    rng = np.random.default_rng(seed)
    c = reg.counter("t_served_total", "served", ("graph", "disposition"))
    gg = reg.gauge("t_depth", "queue depth")
    h = reg.histogram("t_latency_seconds", "latency", ("graph",))
    h2 = reg.histogram("t_stage_seconds", "stages", ("stage",), gamma=1.05)
    for _ in range(400):
        op = int(rng.integers(0, 4))
        graph = ["mesh", "kmer", "pl"][int(rng.integers(0, 3))]
        if op == 0:
            c.labels(graph=graph, disposition=["solved", "cache_hit"][
                int(rng.integers(0, 2))]).inc(float(rng.integers(1, 4)))
        elif op == 1:
            gg.set(float(rng.integers(0, 50)))
        elif op == 2:
            h.labels(graph=graph).observe(float(rng.lognormal(-6, 2)))
        else:
            h2.labels(stage=["queue", "solve"][int(rng.integers(0, 2))]
                      ).observe(float(rng.exponential(1e-3)))
    h.labels(graph="zero").observe(0.0)
    return reg


class TestParityWithReference:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_prometheus_text_byte_identical(self, seed):
        assert to_prometheus(_drive_registry(tmetrics, seed)) == \
            jexport.to_prometheus(_drive_registry(jmetrics, seed))

    @pytest.mark.parametrize("seed", [0, 1])
    def test_snapshots_equal(self, seed):
        meta = {"elapsed_s": 1.5, "arch": "x"}
        a = snapshot(_drive_registry(tmetrics, seed), meta=meta)
        b = jexport.snapshot(_drive_registry(jmetrics, seed), meta=meta)
        assert a == b
        assert validate_snapshot(a) == [] and \
            jexport.validate_snapshot(a) == []
        assert render_summary(a) == jexport.render_summary(b)

    def test_histogram_quantiles_equal(self):
        rng = np.random.default_rng(5)
        a, b = Histogram(), jmetrics.Histogram()
        for v in rng.lognormal(-5, 3, 3000):
            a.observe(float(v))
            b.observe(float(v))
        for q in (0.0, 0.5, 0.9, 0.99, 0.999, 1.0):
            assert a.quantile(q) == b.quantile(q)
        assert a.bucket_bounds() == b.bucket_bounds()

    def test_validators_agree_on_broken_snapshots(self):
        snap = snapshot(_drive_registry(tmetrics, 0))
        snap["metrics"]["t_served_total"]["series"][0]["value"] = -1
        snap["metrics"]["t_latency_seconds"]["series"][0]["p99"] = 1e9
        assert validate_snapshot(snap) == jexport.validate_snapshot(snap)
        assert len(validate_snapshot(snap)) == 2


def _stream(g, seed: int, count: int):
    """Seeded query/update ops: submit (small seed pool: hits, twins),
    update, tick, refresh tick."""
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(count):
        op = int(rng.integers(0, 10))
        if op < 6:
            ops.append(("submit", i, tuple(int(s) for s in rng.choice(
                8, int(rng.integers(1, 3)), replace=False))))
        elif op < 7:
            u, v = int(rng.integers(0, g.n)), int(rng.integers(0, g.n))
            if u != v:
                ops.append(("update", u, v))
        elif op < 9:
            ops.append(("tick",))
        else:
            ops.append(("refresh",))
    return ops


def _run_stream(svc, query_cls, ops):
    for op in ops:
        if op[0] == "submit":
            svc.submit(query_cls(qid=op[1], graph="g", seeds=op[2],
                                 tol=1e-3, top_k=4))
        elif op[0] == "update":
            svc.update_graph("g", insert=[(op[1], op[2])])
        elif op[0] == "tick":
            svc.tick()
        else:
            svc.refresh_tick()
    svc.run_until_drained()


def _families(reg):
    """{name: (kind, labelnames, {labels: value-or-count})}."""
    out = {}
    for fam in reg.collect():
        series = {}
        for values, inst in fam.children():
            series[values] = inst.count if fam.kind == "histogram" \
                else inst.value
        out[fam.name] = (fam.kind, fam.labelnames, series)
    return out


TIMED = {"serve_solve_ewma_seconds"}    # a gauge of clock readings


class TestServiceStreamParity:
    @pytest.mark.parametrize("adaptive", [True, False])
    @pytest.mark.parametrize("seed", [0, 1])
    def test_same_stream_same_metrics(self, seed, adaptive):
        kw = dict(max_batch=4, cache_capacity=32, max_top_k=4,
                  invalidation_radius=1, refresh_batch=2, adaptive=adaptive)
        jg, tg = jgen.tri_mesh(7, 8), generators.tri_mesh(7, 8)
        jreg = JRegistry()
        jreg.register("g", jg)
        treg = GraphRegistry(device="cpu")
        treg.register("g", tg)
        jsvc = JService(jreg, clock=FakeClock(), **kw)
        tsvc = PageRankService(treg, clock=FakeClock(), **kw)
        ops = _stream(tg, seed, 60)
        _run_stream(jsvc, JQuery, ops)
        _run_stream(tsvc, PPRQuery, ops)
        assert tsvc.stats == jsvc.stats
        fj = _families(jsvc.metrics.registry)
        ft = _families(tsvc.metrics.registry)
        assert sorted(ft) == sorted(fj)
        for name in fj:
            kind, labels, series = fj[name]
            assert ft[name][:2] == (kind, labels), name
            assert sorted(ft[name][2]) == sorted(series), name
            if kind == "histogram" or name not in TIMED:
                assert ft[name][2] == series, name
        tj = list(jsvc.metrics.convergence.ticks)
        tt = list(tsvc.metrics.convergence.ticks)
        assert len(tt) == len(tj) > 0
        for a, b in zip(tt, tj):
            assert (a.tick, a.graph, a.engine, a.bucket, a.columns,
                    a.rounds_used, a.rounds_bound) == \
                (b.tick, b.graph, b.engine, b.bucket, b.columns,
                 b.rounds_used, b.rounds_bound)
            np.testing.assert_allclose(a.residual, b.residual, rtol=1e-4,
                                       atol=1e-9)
            assert a.converged_frac == b.converged_frac
        uj = [(u.graph, u.kind, u.edges_changed, u.cache_dropped,
               u.cache_retained) for u in jsvc.metrics.convergence.updates]
        ut = [(u.graph, u.kind, u.edges_changed, u.cache_dropped,
               u.cache_retained) for u in tsvc.metrics.convergence.updates]
        assert ut == uj

    def test_query_trace_span_names_match(self):
        jreg = JRegistry()
        jreg.register("g", jgen.tri_mesh(9, 11))
        jsvc = JService(jreg, max_batch=8, cache_capacity=64, max_top_k=8)
        tsvc = make_service(generators.tri_mesh(9, 11))
        for svc, cls in ((jsvc, JQuery), (tsvc, PPRQuery)):
            svc.submit(cls(qid=0, graph="g", seeds=(3, 7)))
            svc.run_until_drained()
            svc.submit(cls(qid=1, graph="g", seeds=(3, 7)))   # cache hit
        for name in ("query",):
            a = [t.span_names() for t in tsvc.metrics.tracer.finished]
            b = [t.span_names() for t in jsvc.metrics.tracer.finished]
            assert a == b, name
            ka = [[s.kind for s in t.spans]
                  for t in tsvc.metrics.tracer.finished]
            kb = [[s.kind for s in t.spans]
                  for t in jsvc.metrics.tracer.finished]
            assert ka == kb


# ---------------------------------------------------------------------------
# metric primitives, traces, convergence log (mirrors of test_obs.py)
# ---------------------------------------------------------------------------

class TestMetricsPrimitives:
    def test_counter_and_gauge(self):
        reg = MetricsRegistry()
        c = reg.counter("t_total", "help")
        c.inc()
        c.inc(2.5)
        assert c.total() == 3.5
        with pytest.raises(ValueError):
            c.inc(-1)
        gge = reg.gauge("t_depth", "help")
        gge.set(5)
        gge.inc(2)
        gge.dec()
        assert gge.total() == 6.0

    def test_histogram_quantiles_within_gamma_bound(self):
        rng = np.random.default_rng(0)
        samples = rng.lognormal(mean=-6.0, sigma=2.0, size=5000)
        h = Histogram()
        for v in samples:
            h.observe(float(v))
        ordered = np.sort(samples)
        for q in (0.5, 0.9, 0.99, 0.999):
            rank = int(np.ceil(q * (len(samples) - 1) + 1))
            exact = float(ordered[rank - 1])
            assert abs(h.quantile(q) - exact) / exact < 0.0101
        assert h.count == 5000 and np.isclose(h.sum, samples.sum())

    def test_histogram_zero_bucket_empty_and_merge(self):
        h = Histogram()
        assert h.quantile(0.5) == 0.0
        h.observe(0.0)
        h.observe(-1e-9)
        assert h.count == 2 and h.quantile(0.99) <= 0.0
        with pytest.raises(ValueError):
            h.quantile(1.5)
        with pytest.raises(ValueError):
            h.merge(Histogram(gamma=1.1))

    def test_family_labels_and_registry(self):
        reg = MetricsRegistry()
        fam = reg.counter("t_served", "help", ("graph", "disposition"))
        fam.labels(graph="g", disposition="solved").inc()
        with pytest.raises(ValueError):
            fam.labels(graph="g")
        with pytest.raises(ValueError):
            fam.inc()
        assert reg.counter("t_served", "x", ("graph", "disposition")) is fam
        with pytest.raises(ValueError):
            reg.gauge("t_served", "", ("graph", "disposition"))
        reg.reset()
        assert fam.total() == 0.0

    def test_null_registry_absorbs_everything(self):
        c = NULL_REGISTRY.counter("t_n", "", ("graph",))
        c.labels(graph="g").inc()
        h = NULL_REGISTRY.histogram("t_nh", "")
        h.observe(1.0)
        assert c.total() == 0.0 and h.quantile(0.99) == 0.0
        assert h.merged().count == 0 and c.children() == ()


class TestTrace:
    def test_span_lifecycle_kinds_and_record(self):
        tr = Trace("query", qid=1)
        tr.mark("submit")
        tr.begin("queue")
        assert tr.end("queue") >= 0.0
        tr.record("solve_device", tr.created, 0.25, kind="device")
        assert tr.span_names() == ["submit", "queue", "solve_device"]
        assert tr.duration("solve_device") == pytest.approx(0.25)
        assert {s.name: s.kind for s in tr.spans}["solve_device"] == "device"
        assert tr.end("never_begun") == 0.0
        assert all(s["duration_s"] >= 0.0 for s in tr.as_dict()["spans"])

    def test_tracer_bounded_and_null(self):
        tracer = Tracer(keep=4)
        for i in range(10):
            tr = tracer.start("query", qid=i)
            tracer.finish(tr)
        assert len(tracer.finished) == 4
        assert tracer.last().meta["qid"] == 9
        off = Tracer(enabled=False)
        tr = off.start("query")
        assert tr is NULL_TRACE
        tr.begin("queue")
        tr.record("solve_device", 0.0, 1.0, kind="device")
        off.finish(tr)
        assert NULL_TRACE.spans == [] and len(off.finished) == 0

    def test_profiled_noop_without_logdir(self, tmp_path):
        with profiled(None):
            pass
        assert list(tmp_path.iterdir()) == []

    def test_profiled_writes_a_chrome_trace(self, tmp_path):
        import torch
        logdir = tmp_path / "prof"
        with profiled(str(logdir)):
            torch.ones(64).cumsum(0)
        files = list(logdir.glob("trace_*.json"))
        assert len(files) == 1
        trace = json.loads(files[0].read_text())
        assert trace["traceEvents"]

    def test_profiled_propagates_errors_of_the_region(self, tmp_path):
        with pytest.raises(KeyError):
            with profiled(str(tmp_path)):
                raise KeyError("inside")


def _tick(i, used, bound, **kw):
    defaults = dict(tick=i, graph="g", engine="CooEngine", bucket=8,
                    columns=4, rounds_used=used, rounds_bound=bound,
                    residual=1e-5, converged_frac=1.0, tol=1e-4, c=0.85)
    defaults.update(kw)
    return TickTelemetry(**defaults)


class TestConvergenceLog:
    def test_totals_survive_ring_eviction(self):
        log = ConvergenceLog(keep=4)
        for i in range(20):
            log.record_tick(_tick(i, used=6, bound=12))
        s = log.summary()
        assert len(log.ticks) == 4 and s["ticks_recorded"] == 20
        assert s["rounds_saved_ratio"] == pytest.approx(0.5)

    def test_bound_violation_and_retention(self):
        log = ConvergenceLog()
        log.record_tick(_tick(0, used=13, bound=12))
        assert log.bound_violations == 1
        log.record_update(UpdateTelemetry(
            graph="g", kind="incremental", edges_changed=4, cache_dropped=1,
            cache_retained=3, duration_s=0.01))
        assert log.summary()["cache_retention"] == pytest.approx(0.75)
        snap = snapshot(MetricsRegistry(), convergence=log)
        assert any("bound_violations" in e for e in validate_snapshot(snap))


# ---------------------------------------------------------------------------
# exposition
# ---------------------------------------------------------------------------

class TestExposition:
    def test_prometheus_and_snapshot(self):
        reg = _drive_registry(tmetrics, 3)
        text = to_prometheus(reg)
        assert "# TYPE t_latency_seconds histogram" in text
        cums = [int(line.rsplit(" ", 1)[1]) for line in text.splitlines()
                if line.startswith('t_latency_seconds_bucket{graph="kmer"')]
        assert cums == sorted(cums)
        snap = snapshot(reg)
        assert snap["schema"] == SNAPSHOT_SCHEMA
        json.dumps(snap)

    def test_http_endpoint_serves_both_formats(self):
        server = MetricsServer(_drive_registry(tmetrics, 4), port=0).start()
        try:
            base = f"http://127.0.0.1:{server.port}"
            text = urllib.request.urlopen(f"{base}/metrics",
                                          timeout=10).read().decode()
            assert "# TYPE t_served_total counter" in text
            snap = json.loads(urllib.request.urlopen(
                f"{base}/metrics.json", timeout=10).read())
            assert validate_snapshot(snap) == []
        finally:
            server.stop()

    @pytest.mark.parametrize("valid", [True, False])
    def test_validate_cli(self, tmp_path, valid):
        snap = snapshot(_drive_registry(tmetrics, 0))
        if not valid:
            snap["schema"] = "bogus"
        path = tmp_path / "snap.json"
        path.write_text(json.dumps(snap))
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.obs.export", "--validate",
             str(path)], cwd=REPO, env={"PYTHONPATH": str(REPO / "src"),
                                        "PATH": "/usr/bin:/bin"},
            capture_output=True, text=True, timeout=120)
        assert out.returncode == (0 if valid else 1), out.stderr
        if valid:
            assert "snapshot OK" in out.stdout


# ---------------------------------------------------------------------------
# serve-path wiring on the port
# ---------------------------------------------------------------------------

class TestServeInstrumentation:
    def test_single_query_traced_end_to_end(self):
        svc = make_service(generators.tri_mesh(9, 11))
        svc.submit(PPRQuery(qid=0, graph="g", seeds=(3, 7)))
        svc.run_until_drained()
        tr = svc.metrics.tracer.last("query")
        names = tr.span_names()
        for name in ("submit", "queue", "batch_form", "solve_dispatch",
                     "solve_device", "materialize"):
            assert name in names, name
        kinds = {s.name: s.kind for s in tr.spans}
        assert kinds["solve_device"] == "device"
        assert all(s.closed or s.name == "submit" for s in tr.spans)
        snap = svc.snapshot()
        assert any({"solve_device", "materialize"} <=
                   {sp["name"] for sp in t["spans"]} for t in snap["traces"])

    def test_latency_and_stage_histograms_populated(self):
        svc = make_service(generators.tri_mesh(9, 11))
        for i in range(4):
            svc.submit(PPRQuery(qid=i, graph="g", seeds=(i,)))
        svc.run_until_drained()
        lat = svc.metrics.latency.labels(graph="g", disposition="solved")
        assert lat.count == 4 and lat.quantile(0.99) > 0.0
        for stage in ("batch_form", "solve_dispatch", "solve_device",
                      "materialize"):
            assert svc.metrics.stage.labels(stage=stage).count == 1
        assert svc.metrics.stage.labels(stage="queue").count == 4

    def test_rounds_bound_and_residual_telemetry_adaptive(self):
        svc = make_service(generators.tri_mesh(9, 11), adaptive=True)
        for i in range(6):
            svc.submit(PPRQuery(qid=i, graph="g", seeds=(i, i + 11),
                                tol=1e-3))
        svc.run_until_drained()
        st = svc.stats
        assert st["rounds_used"] <= st["rounds_bound"]
        log = svc.metrics.convergence
        assert log.bound_violations == 0 and len(log.ticks) == 1
        t = log.ticks[0]
        assert t.within_bound and 0.0 <= t.converged_frac <= 1.0
        assert np.isfinite(t.residual) and t.residual > 0.0
        assert validate_snapshot(svc.snapshot()) == []

    def test_detail_false_keeps_counters_only(self):
        svc = make_service(generators.tri_mesh(9, 11),
                           metrics=ServeMetrics(detail=False))
        svc.submit(PPRQuery(qid=0, graph="g", seeds=(2,)))
        svc.run_until_drained()
        assert svc.stats["solved_queries"] == 1
        assert svc.metrics.latency.labels(
            graph="g", disposition="solved").count == 0
        assert len(svc.metrics.tracer.finished) == 0

    def test_registry_gauges_and_update_timings(self):
        g = generators.tri_mesh(9, 11)
        svc = make_service(g, invalidation_radius=2)
        reg = svc.metrics.registry
        assert reg.get("graph_epoch").labels(graph="g").value == 0
        assert reg.get("graph_edges").labels(graph="g").value == g.m // 2
        svc.registry.register("h", generators.tri_mesh(5, 6))
        assert reg.get("registry_build_seconds").labels(graph="h").count == 1
        svc.update_graph("g", insert=[(0, g.n - 1)])
        assert reg.get("graph_epoch").labels(graph="g").value == 1
        upd = reg.get("registry_update_seconds")
        assert sum(inst.count for _, inst in upd.children()) == 1

    def test_config_metrics_detail_takes_effect(self):
        from dataclasses import replace
        from repro_torch.configs import pagerank_serve as cfgmod
        for detail in (True, False):
            svc = cfgmod.make_service(replace(cfgmod.smoke_config(),
                                              metrics_detail=detail),
                                      device="cpu")
            assert svc.metrics.detail is detail
            assert svc.metrics.tracer.enabled is detail


class TestOneFencePerTick:
    """The tick path reads nothing back from the card except through the
    one event `_harvest` synchronizes on: no `.item()`, `.cpu()`,
    `.tolist()` or `torch.cuda.synchronize` in the functions a tick runs,
    and one `.synchronize()` call, in `_harvest`."""

    FUNCS = ("tick", "_form_and_dispatch", "_harvest", "_solve_topk",
             "_solve_topk_adaptive", "_start_copy_to_host",
             "_to_device_async")

    def _calls(self, fn):
        tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
        return [n.func.attr for n in ast.walk(tree)
                if isinstance(n, ast.Call) and
                isinstance(n.func, ast.Attribute)]

    @pytest.mark.parametrize("name", FUNCS)
    def test_no_host_reads(self, name):
        fn = getattr(tsvc_mod.PageRankService, name, None) or \
            getattr(tsvc_mod, name)
        calls = self._calls(fn)
        for bad in ("item", "cpu", "tolist"):
            assert bad not in calls, (name, bad)
        assert calls.count("synchronize") == (1 if name == "_harvest"
                                              else 0)


class TestExactlyOnceAccounting:
    def test_cache_hit_counted_once_not_twice(self):
        svc = make_service(generators.tri_mesh(9, 11), max_batch=1)
        svc.submit(PPRQuery(qid=0, graph="g", seeds=(5, 9)))
        svc.submit(PPRQuery(qid=1, graph="g", seeds=(5, 9)))
        results = svc.run_until_drained()
        assert results[1].cached
        assert svc.submit(PPRQuery(qid=2, graph="g", seeds=(5, 9))) is not None
        st = svc.stats
        assert (st["queries"], st["cache_hits"], st["solved_queries"]) == \
            (3, 2, 1)
        cs = svc.cache.stats()
        assert cs["hits"] + cs["misses"] == st["queries"]


class TestDrainOverrun:
    def test_overrun_drop_counts_and_warns(self):
        svc = make_service(generators.tri_mesh(9, 11), max_batch=1)
        for i in range(3):
            svc.submit(PPRQuery(qid=i, graph="g", seeds=(i,)))
        with pytest.warns(RuntimeWarning, match="dropped 2"):
            results = svc.run_until_drained(max_ticks=1, on_overrun="drop")
        assert len(results) == 1
        st = svc.stats
        assert st["dropped_queries"] == 2
        assert svc.metrics.latency.labels(
            graph="g", disposition="dropped").count == 2
        assert svc.pending() == 0


def _run_interleaving(ops, seed, async_dispatch):
    g = generators.tri_mesh(6, 7)
    svc = make_service(g, max_batch=2, cache_capacity=32,
                       invalidation_radius=2, refresh_batch=2, adaptive=True,
                       async_dispatch=async_dispatch)
    rng = np.random.default_rng(seed)
    qid = 0

    def check():
        st = svc.stats
        disposed = (st["cache_hits"] + st["solved_queries"]
                    + st["dropped_queries"])
        assert st["queries"] == disposed + svc.pending()
        assert st["rounds_used"] <= st["rounds_bound"]

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for op in ops:
            if op == 0:
                svc.submit(PPRQuery(qid=qid, graph="g",
                                    seeds=(int(rng.integers(0, 6)),),
                                    tol=1e-3))
                qid += 1
            elif op == 1:
                u, v = int(rng.integers(0, g.n)), int(rng.integers(0, g.n))
                if u != v:
                    svc.update_graph("g", insert=[(u, v)])
            elif op == 2:
                svc.tick()
            elif op == 3:
                svc.refresh_tick()
            else:
                svc.run_until_drained(max_ticks=1, on_overrun="drop")
            check()
        svc.run_until_drained(max_ticks=100, on_overrun="drop")
    check()
    assert svc.pending() == 0
    assert svc.metrics.convergence.bound_violations == 0


class TestDispositionConservation:
    @pytest.mark.parametrize("async_dispatch", [False, True])
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_seeded_interleavings(self, seed, async_dispatch):
        rng = np.random.default_rng(100 + seed)
        _run_interleaving(rng.integers(0, 5, size=25).tolist(), seed,
                          async_dispatch)
