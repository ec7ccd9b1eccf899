"""The port's measured engine selection (`repro_torch.core.autotune`) against
the reference's (`repro.core.autotune`).

Fingerprints, shortlists, `pick_winner` and the `WorkloadKey` fields (all
but the backend tag, which is the port's own so keys never collide) must
be equal. With the per-candidate timings injected, both tuners must pick
the same winner and write the same store entry, apart from the
environment stamp. The rest mirrors `tests/test_autotune.py` on the port,
plus the port's one deliberate divergence: only infeasibility (device
memory, the int32 capacity check) disqualifies a candidate, and a kernel
error propagates where the reference falls back to the heuristic.
"""
import json
import subprocess
import sys
from dataclasses import asdict, replace
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import autotune as jtune
from repro.core import engine as jeng
from repro.graph import generators as jgen

from repro_torch.core import autotune as ttune
from repro_torch.core import engine as teng
from repro_torch.core.autotune import (TUNE_FORMAT_VERSION, Autotuner,
                                       FillProbeCache, TuningStore,
                                       WorkloadKey, default_tune_path,
                                       graph_fingerprint,
                                       pick_winner)
from repro_torch.graph import generators
from repro_torch.graph.ops import CapacityError
from repro_torch.serve import GraphRegistry, PageRankService

REPO = Path(__file__).resolve().parent.parent

GRAPHS = {
    "small": lambda gen: gen.tri_mesh(10, 10),
    "mesh": lambda gen: gen.tri_mesh(30, 40),
    "skewed": lambda gen: gen.powerlaw_ba(1500, 6, seed=0),
    "caveman": lambda gen: gen.caveman(30, 64, seed=0),
    "kmer": lambda gen: gen.kmer_chains(3000, seed=1),
}


def _pair(name):
    return GRAPHS[name](jgen), GRAPHS[name](generators)


def small_graph():
    # n=100 < MIN_CANDIDATE_N and < 2*block: the shortlist is just COO
    return generators.tri_mesh(10, 10)


def skewed_graph():
    return generators.powerlaw_ba(1500, 6, seed=0)


class TestParityWithReference:
    @pytest.mark.parametrize("name", sorted(GRAPHS))
    def test_fingerprint_equal(self, name):
        gj, gt = _pair(name)
        assert graph_fingerprint(gt) == jtune.graph_fingerprint(gj)

    @pytest.mark.parametrize("batch", [None, 1, 8, 48, 128])
    @pytest.mark.parametrize("name", sorted(GRAPHS))
    def test_workload_key_fields_equal_but_backend(self, name, batch):
        gj, gt = _pair(name)
        kj = jtune.WorkloadKey.from_graph(gj, batch=batch, backend="cpu",
                                          device_count=1)
        kt = WorkloadKey.from_graph(gt, batch=batch, device="cpu")
        assert asdict(replace(kt, backend="cpu")) == asdict(kj)
        assert kt.backend == "torch-cpu"
        assert WorkloadKey.from_graph(gt, batch=batch).backend == \
            "torch-cuda"
        assert kt.as_str() != kj.as_str()
        assert kt.as_str().replace("torch-cpu", "cpu") == kj.as_str()

    @pytest.mark.parametrize("name", sorted(GRAPHS))
    def test_shortlist_equal(self, name):
        gj, gt = _pair(name)
        heur = teng.heuristic_mode(gt, 8, device="cpu")
        assert heur == jeng.heuristic_mode(gj, 8)
        rj = jtune.Autotuner.__new__(jtune.Autotuner)
        rj.store = jtune.FillProbeCache()
        kj = jtune.WorkloadKey.from_graph(gj, 8, backend="cpu",
                                          device_count=1)
        rt = Autotuner.__new__(Autotuner)
        rt.store = FillProbeCache()
        assert rt._shortlist(gt, heur, 128, device="cpu") == \
            rj._shortlist(gj, kj, heur, n_dev=1, block=128)

    @pytest.mark.parametrize("n_dev", [2, 4, 8])
    @pytest.mark.parametrize("name", sorted(GRAPHS))
    def test_sharded_shortlist_equal(self, name, n_dev):
        """At >= 2 ranks the sharded modes join as in the reference."""
        gj, gt = _pair(name)
        heur = jeng.heuristic_mode(gj, 8)
        rj = jtune.Autotuner.__new__(jtune.Autotuner)
        rj.store = jtune.FillProbeCache()
        kj = jtune.WorkloadKey.from_graph(gj, 8, backend="cpu",
                                          device_count=n_dev)
        rt = Autotuner.__new__(Autotuner)
        rt.store = FillProbeCache()
        assert rt._shortlist(gt, heur, 128, device="cpu", n_dev=n_dev) == \
            rj._shortlist(gj, kj, heur, n_dev=n_dev, block=128)

    @pytest.mark.parametrize("measured,heuristic,jitter", [
        ({"coo": 2.0, "hub_tail": 1.0}, "coo", 0.10),
        ({"coo": 1.05, "hub_tail": 1.0}, "coo", 0.10),
        ({"coo": 1.05, "hub_tail": 1.0}, "coo", 0.01),
        ({}, "fused", 0.10),
        ({"fused": 1.0, "hub_tail": 1.0}, "sharded_1d", 0.0),
        ({"coo": 3.0, "hub_tail": 2.9, "fused": 2.5}, "coo", 0.10),
        ({"coo": 1.0, "fused": 1.0}, "fused", 0.0),
    ])
    def test_pick_winner_equal(self, measured, heuristic, jitter):
        assert pick_winner(dict(measured), heuristic, jitter) == \
            jtune.pick_winner(dict(measured), heuristic, jitter)

    @pytest.mark.parametrize("name", ["mesh", "skewed", "caveman", "kmer"])
    def test_injected_timings_same_winner_and_entry(self, name, tmp_path,
                                                    monkeypatch):
        """Fake per-round times keyed by engine class: both tuners measure
        the same candidates, pick the same winner, store the same entry."""
        fake = {"CooEngine": 3e-3, "HubTailEngine": 2e-3,
                "FusedBlockEllEngine": 2.5e-3}
        monkeypatch.setattr(jtune, "_time_round",
                            lambda eng, *a, **k: fake[type(eng).__name__])
        monkeypatch.setattr(ttune, "_time_round",
                            lambda eng, *a, **k: fake[type(eng).__name__])
        gj, gt = _pair(name)
        tj = jtune.Autotuner(jtune.TuningStore(tmp_path / "j.json"),
                             budget_s=1e9)
        tt = Autotuner(TuningStore(tmp_path / "t.json"), budget_s=1e9)
        dj = tj.tune(gj, 8, graph_name=name)
        dt = tt.tune(gt, 8, graph_name=name, device="cpu")
        assert (dt.mode, dt.source, dt.heuristic, dt.us_per_iter) == \
            (dj.mode, dj.source, dj.heuristic, dj.us_per_iter)
        ej, et = tj.store.get(dj.key), tt.store.get(dt.key)
        stamp = {"backend", "jax", "torch", "device_name"}
        assert {k: v for k, v in et.items() if k not in stamp} == \
            {k: v for k, v in ej.items() if k not in stamp}
        assert et["backend"] == "torch-cpu" and \
            et["torch"] == torch.__version__ and et["device_name"] == "cpu"
        assert type(dt.engine).__name__ == type(dj.engine).__name__


class TestTuningStore:
    def test_round_trip(self, tmp_path):
        store = TuningStore(tmp_path / "t.json")
        store.put("k1", {"engine": "coo", "us_per_iter": 12.5})
        g = small_graph()
        store.put_fill(g, 128, 0.25)
        store2 = TuningStore(tmp_path / "t.json")
        assert store2.get("k1") == {"engine": "coo", "us_per_iter": 12.5}
        assert store2.get_fill(g, 128) == 0.25
        assert store2.get_fill(g, 64) is None
        assert store2.load_error is None

    def test_file_layout_is_the_reference_s(self, tmp_path):
        g = small_graph()
        TuningStore(tmp_path / "t.json").put_fill(g, 128, 0.5)
        ref = jtune.TuningStore(tmp_path / "t.json")
        assert ref.get_fill(jgen.tri_mesh(10, 10), 128) == 0.5

    def test_truncated_file_falls_back_and_regenerates(self, tmp_path):
        path = tmp_path / "t.json"
        TuningStore(path).put("k1", {"engine": "fused"})
        raw = path.read_text()
        path.write_text(raw[: len(raw) // 2])
        store = TuningStore(path)
        assert store.get("k1") is None and store.load_error == "corrupt"
        store.put("k2", {"engine": "coo"})
        assert json.loads(path.read_text())["version"] == \
            TUNE_FORMAT_VERSION
        assert TuningStore(path).get("k2") == {"engine": "coo"}

    def test_version_bump_orphans_entries(self, tmp_path):
        path = tmp_path / "t.json"
        path.write_text(json.dumps(
            {"version": TUNE_FORMAT_VERSION + 1,
             "entries": {"k1": {"engine": "coo"}}, "fill_probes": {}}))
        store = TuningStore(path)
        assert store.get("k1") is None and store.load_error == "version"

    def test_default_path_is_the_port_s_own(self, tmp_path, monkeypatch):
        assert TuningStore(tmp_path).path == tmp_path / "tuning.json"
        monkeypatch.delenv("REPRO_TORCH_TUNE_CACHE", raising=False)
        monkeypatch.delenv("REPRO_TUNE_CACHE", raising=False)
        assert default_tune_path() != jtune.default_tune_path()
        monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "jax"))
        monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "port"))
        assert default_tune_path() == tmp_path / "port" / "tuning.json"


class TestFillProbeCache:
    def test_fingerprint_tracks_content(self):
        assert graph_fingerprint(small_graph()) == \
            graph_fingerprint(generators.tri_mesh(10, 10))
        assert graph_fingerprint(small_graph()) != \
            graph_fingerprint(generators.tri_mesh(10, 11))

    def test_auto_mode_probes_once_per_shape(self, monkeypatch):
        g = generators.caveman(30, 64, seed=0)
        calls = []
        real = teng.block_fill_rate

        def counting(g_, block=128, **kw):
            calls.append(block)
            return real(g_, block=block, **kw)

        monkeypatch.setattr(teng, "block_fill_rate", counting)
        cache = FillProbeCache()
        m1 = teng.heuristic_mode(g, probe_cache=cache, device="cpu")
        m2 = teng.heuristic_mode(g, probe_cache=cache, device="cpu")
        assert m1 == m2 and len(calls) == 1

    def test_census_cap_by_device(self):
        assert ttune.max_tile_bytes("cpu") == jtune.Autotuner.MAX_TILE_BYTES


class TestAutotuner:
    def test_measured_entry_records_environment(self, tmp_path):
        tuner = Autotuner(TuningStore(tmp_path / "t.json"))
        dec = tuner.tune(small_graph(), 8, graph_name="mesh", device="cpu")
        assert dec.source == "measured"
        assert dec.us_per_iter is not None and dec.us_per_iter > 0
        entry = tuner.store.get(dec.key)
        assert entry["engine"] == dec.mode
        assert (entry["backend"], entry["device_count"]) == ("torch-cpu", 1)
        assert entry["torch"] == torch.__version__
        assert entry["heuristic"] == dec.heuristic
        assert "jax" not in entry

    def test_warm_store_performs_zero_measurements(self, tmp_path):
        path = tmp_path / "t.json"
        Autotuner(TuningStore(path)).tune(small_graph(), 8, device="cpu")
        tuner = Autotuner(TuningStore(path))
        dec = tuner.tune(small_graph(), 8, device="cpu")
        assert dec.source == "store_hit" and tuner.measured_count() == 0
        assert tuner.decision_counts == {"store_hit": 1}

    def test_a_reference_entry_is_never_a_store_hit(self, tmp_path):
        """The reference's winner, written into the port's store file under
        the reference's key, is not served to the port."""
        path = tmp_path / "t.json"
        jtune.Autotuner(jtune.TuningStore(path)).tune(jgen.tri_mesh(10, 10),
                                                      8)
        tuner = Autotuner(TuningStore(path))
        assert tuner.tune(small_graph(), 8, device="cpu").source == \
            "measured"

    def test_require_cached_miss_falls_back_to_heuristic(self, tmp_path):
        tuner = Autotuner(TuningStore(tmp_path / "absent.json"),
                          require_cached=True)
        g = skewed_graph()
        dec = tuner.tune(g, 8, device="cpu")
        assert dec.source == "fallback_heuristic"
        assert dec.mode == teng.heuristic_mode(g, 8, device="cpu")
        assert tuner.measured_count() == 0

    def test_injected_oom_falls_back_to_heuristic(self, tmp_path,
                                                  monkeypatch):
        def oom(*a, **k):
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")

        monkeypatch.setattr(ttune, "_time_round", oom)
        tuner = Autotuner(TuningStore(tmp_path / "t.json"), budget_s=1e9)
        g = skewed_graph()
        dec = tuner.tune(g, 8, device="cpu")
        assert dec.source == "fallback_heuristic"
        assert dec.mode == teng.heuristic_mode(g, 8, device="cpu")
        assert tuner.store.get(dec.key) is None

    def test_one_infeasible_candidate_is_skipped(self, tmp_path,
                                                 monkeypatch):
        real = ttune.select_engine

        def capacity(g, *a, mode="auto", **k):
            if mode == "hub_tail":
                raise CapacityError("hub/tail: nnz exceeds int32 range")
            return real(g, *a, mode=mode, **k)

        monkeypatch.setattr(ttune, "select_engine", capacity)
        tuner = Autotuner(TuningStore(tmp_path / "t.json"), budget_s=1e9)
        dec = tuner.tune(skewed_graph(), 8, device="cpu")
        entry = tuner.store.get(dec.key)
        assert entry["skipped"] == ["hub_tail"]
        assert "coo" in entry["candidates"] and dec.mode != "hub_tail"

    def test_kernel_error_propagates_where_the_reference_falls_back(
            self, tmp_path, monkeypatch):
        """The divergence: a failed kernel build or launch is not
        infeasibility. The reference disqualifies the candidate (and falls
        back on a failed pass); the port raises."""
        def launch_failure(*a, **k):
            raise RuntimeError("bsr_spmm: kernel launch failed with CUDA "
                               "error 719")

        monkeypatch.setattr(ttune, "_time_round", launch_failure)
        monkeypatch.setattr(jtune, "_time_round", launch_failure)
        tuner = Autotuner(TuningStore(tmp_path / "t.json"))
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            tuner.tune(skewed_graph(), 8, device="cpu")
        assert tuner.store.get(WorkloadKey.from_graph(
            skewed_graph(), 8, device="cpu").as_str()) is None
        ref = jtune.Autotuner(jtune.TuningStore(tmp_path / "j.json"))
        assert ref.tune(jgen.powerlaw_ba(1500, 6, seed=0), 8).source == \
            "fallback_heuristic"

    def test_kernel_build_error_propagates_through_select_engine(
            self, tmp_path, monkeypatch):
        def build_failure(*a, **k):
            raise RuntimeError("kernel build failed:\n--- bsr_spmm")

        monkeypatch.setattr(ttune, "_time_round", build_failure)
        tuner = Autotuner(TuningStore(tmp_path / "t.json"))
        with pytest.raises(RuntimeError, match="kernel build failed"):
            teng.select_engine(generators.caveman(30, 64, seed=0), 8,
                               mode="tuned", tuner=tuner, device="cpu")


class TestSelectEngineTuned:
    @pytest.mark.parametrize("name", ["small", "skewed", "caveman"])
    def test_tuned_builds_the_winner(self, name, tmp_path):
        _, g = _pair(name)
        tuner = Autotuner(TuningStore(tmp_path / "t.json"), budget_s=1e9)
        eng = teng.select_engine(g, 8, mode="tuned", tuner=tuner,
                                 device="cpu")
        entry = tuner.store.get(WorkloadKey.from_graph(
            g, 8, device="cpu").as_str())
        assert eng.name == teng.select_engine(
            g, 8, mode=entry["engine"], device="cpu").name
        # a store hit builds the stored winner afresh
        again = teng.select_engine(g, 8, mode="tuned", tuner=tuner,
                                   device="cpu")
        assert again.name == eng.name and again is not eng
        assert tuner.decision_counts == {"measured": 1, "store_hit": 1}

    def test_default_tuner_uses_the_env_store(self, tmp_path, monkeypatch):
        monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path))
        monkeypatch.setattr(ttune, "_DEFAULT_TUNER", None)
        teng.select_engine(small_graph(), 8, mode="tuned", device="cpu")
        assert (tmp_path / "tuning.json").exists()
        assert ttune.default_tuner().measured_count() == 1


class TestRegistryTunedMode:
    def test_register_records_tuned_mode(self, tmp_path):
        reg = GraphRegistry(device="cpu", engine="tuned",
                            tune_cache=tmp_path / "t.json")
        rg = reg.register("g", small_graph())
        assert rg.tuned_mode == "coo" and rg.tune_us_per_iter > 0
        assert reg.tuner.decision_counts == {"measured": 1}

    def test_warm_store_registry_start_zero_tuning_solves(self, tmp_path):
        path = tmp_path / "t.json"
        GraphRegistry(device="cpu", engine="tuned",
                      tune_cache=path).register("g", skewed_graph())
        reg = GraphRegistry(device="cpu", engine="tuned", tune_cache=path)
        reg.register("g", skewed_graph())
        assert reg.tuner.measured_count() == 0
        assert reg.tuner.decision_counts == {"store_hit": 1}

    def test_rebuild_sticks_in_bucket_and_retunes_across(self, tmp_path):
        reg = GraphRegistry(device="cpu", engine="tuned",
                            update_mode="rebuild",
                            tune_cache=tmp_path / "t.json")
        g = generators.tri_mesh(10, 10)
        reg.register("g", g)
        reg.apply_updates("g", insert=[(0, 99)])     # m stays in bucket
        assert reg.tuner.decision_counts == {"measured": 1, "sticky": 1}
        # enough edges to leave the log2 edge bucket: a fresh decision
        rg = reg.get("g")
        bucket = rg.m_bucket
        edges = [(u, v) for u in range(0, 40) for v in range(60, 100)
                 if (u + v) % 3 == 0]
        reg.apply_updates("g", insert=edges)
        assert rg.m_bucket != bucket
        assert reg.tuner.decision_counts["measured"] == 2

    def test_incremental_update_keeps_the_tuned_engine(self, tmp_path):
        """A sticky tuned graph takes the in-place patch path: the COO
        winner shares the registry's device graph, patched in place."""
        reg = GraphRegistry(device="cpu", engine="tuned",
                            tune_cache=tmp_path / "t.json")
        rg = reg.register("g", small_graph())
        eng, src = rg.engine, rg.dg.src
        reg.apply_updates("g", insert=[(0, 99)])
        assert rg.last_update_incremental
        assert rg.engine is eng and rg.dg.src is src
        assert reg.tuner.decision_counts == {"measured": 1}

    def test_auto_mode_uses_process_probe_cache(self):
        reg = GraphRegistry(device="cpu")
        assert reg._probe_cache is ttune.process_probe_cache()
        assert reg.tuner is None

    def test_tuner_metrics_bound_through_the_service(self, tmp_path):
        reg = GraphRegistry(device="cpu", engine="tuned",
                            tune_cache=tmp_path / "t.json")
        svc = PageRankService(reg, max_batch=8)
        reg.register("g", small_graph())
        fam = svc.metrics.registry.get("autotune_decisions_total")
        assert fam.labels(graph="g", source="measured").value == 1
        assert svc.metrics.registry.get("autotune_us_per_iter").labels(
            graph="g", engine="coo").value > 0


class TestServiceTuned:
    def test_tuned_service_seeds_estimator(self, tmp_path):
        reg = GraphRegistry(device="cpu", engine="tuned",
                            tune_cache=tmp_path / "t.json")
        reg.register("g", small_graph())
        svc = PageRankService(reg, max_batch=8, cache_capacity=16,
                              max_top_k=4)
        assert svc.estimator.estimate("g", 8) > 0.0

    def test_engine_swap_resets_estimator(self, monkeypatch):
        reg = GraphRegistry(device="cpu")
        reg.register("g", skewed_graph())
        svc = PageRankService(reg, max_batch=8, cache_capacity=16,
                              max_top_k=4)
        svc.estimator.observe("g", 8, 123.0)
        real_apply = type(reg).apply_updates

        def swapping(self_reg, name, insert=(), delete=()):
            out = real_apply(self_reg, name, insert=insert, delete=delete)
            out.engine = teng.select_engine(out.host, mode="hub_tail",
                                            device="cpu")
            return out

        monkeypatch.setattr(type(reg), "apply_updates", swapping)
        svc.update_graph("g", insert=[(0, 7)])
        assert ("g", 8) not in svc.estimator.snapshot()
        assert svc.metrics.engine_swaps.labels(graph="g").value == 1

    def test_make_service_tuned_on_cpu(self, tmp_path):
        from repro_torch.configs import pagerank_serve as cfgmod
        cfg = replace(cfgmod.smoke_config(), engine="tuned",
                      tune_cache=str(tmp_path / "t.json"))
        svc = cfgmod.make_service(cfg, device="cpu")
        assert svc.registry.tuner is not None
        r = svc.query("mesh", (0, 3), top_k=4)
        assert np.all(np.isfinite(r.scores))
        cfg2 = replace(cfg, tune_require_cached=True, tune_budget_s=0.5)
        svc2 = cfgmod.make_service(cfg2, device="cpu")
        assert svc2.registry.tuner.require_cached
        assert svc2.registry.tuner.budget_s == 0.5
        assert svc2.registry.tuner.decision_counts == {"store_hit": 1}

    def test_launcher_tuned_writes_a_valid_snapshot(self, tmp_path):
        snap = tmp_path / "snap.json"
        env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
               "HOME": str(tmp_path)}
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
             "pagerank-serve", "--smoke", "--requests", "64", "--updates",
             "4", "--engine", "tuned", "--metrics-json", str(snap),
             "--tune-cache", str(tmp_path / "tune.json"), "--device",
             "cpu"], cwd=REPO, env=env, capture_output=True, text=True,
            timeout=300)
        assert out.returncode == 0, out.stdout + out.stderr
        assert "metrics snapshot ->" in out.stdout
        assert "served   :" in out.stdout      # render_summary printed
        val = subprocess.run(
            [sys.executable, "-m", "repro_torch.obs.export", "--validate",
             str(snap)], cwd=REPO, env=env, capture_output=True, text=True,
            timeout=120)
        assert val.returncode == 0, val.stderr
        data = json.loads(snap.read_text())
        assert data["meta"]["tune_decisions"] == {"measured": 1}
        assert data["convergence"]["summary"]["bound_violations"] == 0
