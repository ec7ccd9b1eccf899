"""The port's dry-run tooling on the CPU: `launch/analysis.py`'s counters,
`launch/dryrun.py` (the production mesh on a fake world at smoke size, its
collective bytes against a closed form, the card mesh, the fit check,
errors),
`launch/roofline.py` against the JAX package's report, `launch/mesh.py`
(its rates, the production mesh's refusal, the elastic mesh's shape at
world sizes 1, 2, 4 and 8 over gloo, tests/torch_mesh_worker.py, held to
the reference's on 8 fake XLA devices) and the training launcher's mesh
line.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from repro_torch.configs import registry
from repro_torch.configs.base import DryRunPlan, meta
from repro_torch.configs.registry import all_cells
from repro_torch.core import distributed as cdist
from repro_torch.kernels import cost as kernel_cost
from repro_torch.kernels.embedding_bag import ops as eb_ops
from repro_torch.launch import analysis, dryrun, mesh as launch_mesh
from repro_torch.launch import roofline as port_roofline

HERE = Path(__file__).resolve().parent
SRC = HERE.parent / "src"
TIMEOUT = 300.0

REF_RECORD = {
    "arch": "x", "shape": "y", "multi_pod": False, "status": "ok",
    "kind": "train", "chips": 256,
    "memory": {"peak_per_device": 1 << 30, "argument_bytes": 0,
               "output_bytes": 0, "temp_bytes": 0, "alias_bytes": 0},
    "cost": {"flops": 1e12, "bytes_accessed": 1e9},
    "collectives": {k: 0 for k in analysis.COLLECTIVES},
    "roofline": {"chips": 256, "hlo_flops": 1e12, "hlo_bytes": 1e9,
                 "coll_bytes": 0.0, "compute_s": 5e-3,
                 "memory_s": 1e-3, "collective_s": 0.0,
                 "dominant": "compute", "model_flops": 1e12,
                 "useful_flops_ratio": 1.0},
    "note": ""}


def _matmul_plan(m: int, k: int, n: int) -> DryRunPlan:
    def make_args(seed=0, device=None):
        gen = torch.Generator().manual_seed(seed)
        return (torch.randn(m, k, generator=gen).to(device),
                torch.randn(k, n, generator=gen).to(device))
    return DryRunPlan(step=torch.matmul,
                      abstract_args=(meta((m, k), torch.float32),
                                     meta((k, n), torch.float32)),
                      in_specs=(None, None), model_flops=2.0 * m * k * n,
                      static={"make_args": make_args,
                              "compute_dtype": "float32"})


# ----------------------------------------------------------------- counters --

class TestCounters:
    @pytest.mark.parametrize("m,k,n", [(64, 32, 16), (7, 129, 33)])
    def test_matmul_plan_counts_exactly(self, m, k, n):
        """2 m n k FLOPs and (mk + kn + mn) x 4 bytes."""
        rec = dryrun.run_plan(_matmul_plan(m, k, n), {"arch": "mm"},
                              device="cpu", verbose=False, timed=1)
        assert rec["status"] == "ok"
        assert rec["cost"]["flops"] == 2 * m * n * k
        assert rec["cost"]["bytes_accessed"] == (m * k + k * n + m * n) * 4
        assert rec["memory"]["peak_per_device"] is None
        assert rec["roofline"]["compute_s"] == pytest.approx(
            2 * m * n * k / launch_mesh.PEAK_FLOPS_F32)

    def test_elementwise_reduction_gather_scatter(self):
        x = torch.randn(100, 8)
        ids = torch.randint(0, 100, (30,))
        _, c, _, _ = analysis.count_step(lambda a: (a * 2.0).sum(), x)
        # mul: 800 flops, read 3200 + write 3200 bytes; sum: 800 flops,
        # read 3200 + write 4
        assert c == {"flops": 1600.0, "bytes accessed": 3200 * 3 + 4.0}
        _, c, _, _ = analysis.count_step(lambda a, i: a[i], x, ids)
        assert c == {"flops": 0.0, "bytes accessed": 30 * 8 + 2 * 30 * 32.0}
        g, src = torch.zeros(100, 8), torch.randn(30, 8)
        _, c, _, _ = analysis.count_step(
            lambda a, i, s: a.index_add_(0, i, s), g, ids, src)
        assert c == {"flops": 240.0,
                     "bytes accessed": 30 * 8 + 30 * 32 + 2 * 30 * 32.0}

    def test_matrix_vector_products_count_two_per_multiply_add(self):
        """mv and dot, which torch's formulas leave out (DLRM's
        retrieval scores the bank with one mv), inside inference mode
        too."""
        a, v = torch.randn(300, 64), torch.randn(64)
        for fn in (lambda m, x: m @ x,
                   torch.inference_mode()(lambda m, x: m @ x)):
            _, c, _, _ = analysis.count_step(fn, a, v)
            assert c["flops"] == 2 * 300 * 64
        _, c, _, _ = analysis.count_step(lambda x: x @ x, v)
        assert c["flops"] == 2 * 64

    def test_composites_under_inference_mode_are_counted(self):
        """Under inference_mode a composite (matmul) reaches the counter
        whole; its decomposition is what gets counted."""
        a, b = torch.randn(4, 8, 16), torch.randn(4, 16, 2)
        _, c, _, _ = analysis.count_step(
            torch.inference_mode()(torch.matmul), a, b)
        assert c["flops"] == 2 * 4 * 8 * 16 * 2

    def test_views_and_allocations_count_nothing(self):
        x = torch.randn(16, 4)
        _, c, _, _ = analysis.count_step(
            lambda a: (a.t(), a.reshape(64), a[2:], torch.empty(1000)), x)
        assert c == {"flops": 0.0, "bytes accessed": 0.0}

    def test_broadcast_input_counts_once(self):
        x = torch.randn(1, 256)
        y = torch.randn(64, 256)
        _, c, _, _ = analysis.count_step(lambda a, b: a.expand(64, 256) + b,
                                         x, y)
        assert c["bytes accessed"] == (256 + 2 * 64 * 256) * 4

    def test_backward_is_counted(self):
        w = torch.randn(32, 16, requires_grad=True)
        x = torch.randn(8, 32)
        _, c, _, _ = analysis.count_step(
            lambda a, b: torch.autograd.grad((b @ a).sum(), a), w, x)
        # forward mm + the weight gradient's mm
        assert c["flops"] >= 2 * (2 * 8 * 32 * 16)

    def test_kernel_reports_are_added_and_their_ops_not_counted(self):
        """A kernel's report (here a stand-in) adds its own FLOPs and
        bytes; the torch ops its cost function runs are not the step's."""
        def step(a):
            kernel_cost.report("fake", lambda: (int(torch.ones(5).sum()),
                                                1000))
            return a
        _, c, _, k = analysis.count_step(step, torch.zeros(3))
        assert c == {"flops": 5.0, "bytes accessed": 1000.0}
        assert k == {"fake": {"launches": 1, "flops": 5, "bytes": 1000}}
        assert not kernel_cost.active()

    def test_embedding_bag_reports_the_bytes_of_its_bound(self):
        """The lookup's and the backward's (flops, bytes): distinct rows
        read (written) once, ids and the output (grad_out) once."""
        ids = torch.tensor([[0], [3], [3], [7]], dtype=torch.int32)
        out = torch.zeros(4, 16)
        assert eb_ops._lookup_cost(ids, out) == \
            (2 * 4 * 16, 4 * 3 * 16 + 4 * (4 * 16 + 4))
        assert eb_ops._backward_cost(ids, 16) == \
            (2 * 4 * 16, 4 * 4 * 16 + 4 * 4 + 4 * 3 * 16)

    def test_collectives_map_onto_the_reference_kinds(self):
        counts = {"moe/dispatch/all_to_all/model": {"calls": 3, "bytes": 30},
                  "train/grad_mean/all_reduce/world": {"calls": 2,
                                                       "bytes": 8},
                  "sharded-1d/apply/all_gather/world": {"calls": 1,
                                                        "bytes": 5}}
        got = analysis.collective_bytes(counts)
        assert got["all-to-all"] == 30 and got["n_all-to-all"] == 3
        assert got["all-reduce"] == 8 and got["n_all-reduce"] == 2
        assert got["all-gather"] == 5 and got["n_all-gather"] == 1
        assert got["reduce-scatter"] == got["collective-permute"] == 0
        assert set(got) == set(REF_RECORD["collectives"]) | {
            f"n_{k}" for k in analysis.COLLECTIVES}

    @pytest.mark.parametrize("dtype,peak", [
        ("bfloat16", launch_mesh.PEAK_FLOPS_BF16),
        ("float32", launch_mesh.PEAK_FLOPS_F32)])
    def test_roofline_terms_use_the_cards_rates(self, dtype, peak):
        coll = {k: 0 for k in analysis.COLLECTIVES}
        coll["all-gather"] = 450e6
        r = analysis.roofline_terms({"flops": 1e12, "bytes accessed": 3.35e9},
                                    coll, 1, 5e11, dtype)
        assert r.compute_s == pytest.approx(1e12 / peak)
        assert r.memory_s == pytest.approx(1e-3)
        assert r.collective_s == pytest.approx(1e-3)
        assert r.useful_flops_ratio == pytest.approx(0.5)


# ------------------------------------------------------------------ dry-run --

class TestDryRun:
    def test_pna_molecule_on_the_card_mesh_on_cpu(self):
        rec = dryrun.run_cell("pna", "molecule", mesh="card", device="cpu",
                              verbose=False, timed=1)
        assert rec["status"] == "ok" and rec["mesh"] == "card"
        assert rec["chips"] == 1 and rec["device"] == "cpu"
        ratio = rec["cost"]["flops"] / rec["roofline"]["model_flops"]
        assert 0.5 <= ratio <= 2.0, ratio
        assert rec["cost"]["bytes_accessed"] > 0
        assert rec["memory"]["peak_per_device"] is None
        assert rec["memory"]["temp_bytes"] is None
        assert rec["memory"]["alias_bytes"] > 0        # donated (0, 1)
        assert rec["step_ms"]["median"] > 0
        assert rec["launches"]["embedding_bag"] == 0
        for key in ("memory", "cost", "collectives", "roofline", "note"):
            assert key in rec

    def test_cpaa_step_merges_its_shards_once(self):
        """cpaa's one-rank step merges the stacked shards on its first
        call with a set of edge tensors and reuses the merged copy while
        the same tensors come back, so the counted and timed steps do not
        pay the merge; other tensors are merged anew."""
        from repro_torch.configs import pagerank_cpaa as cpaa
        part = cpaa._AbstractPart1D(n=12, n_orig=12, n_dev=4,
                                    rows_per_dev=3, edges_per_dev=2)
        merges = []

        def merge(*edges):
            merges.append(1)
            return cpaa._merge_1d(part, *edges)

        step = cpaa._merged_once(lambda p, *e: (p, *e), merge)
        src = torch.arange(8, dtype=torch.int32).reshape(4, 2)
        dst = torch.tensor([[0, 2], [1, 1], [2, 0], [0, 0]],
                           dtype=torch.int32)
        w = torch.ones(4, 2)
        first = step(None, src, dst, w)
        assert step(None, src, dst, w)[2] is first[2]
        assert len(merges) == 1
        assert first[2].tolist() == [0, 2, 4, 4, 8, 6, 9, 9]
        step(None, src, dst.clone(), w)
        assert len(merges) == 2

    def test_production_mesh_records_a_skip_naming_the_world(
            self, monkeypatch):
        """Once a skip for want of ranks, now the production record: at
        smoke size (danube's smoke config, small shapes), rank 0 of the
        (16, 16) mesh on a fake world of 256 ranks runs train_4k counted
        on meta tensors, with the reference's record keys, argument bytes
        equal to `per_device_bytes` and the fit on the card."""
        _smoke_production(monkeypatch)
        rec = dryrun.run_cell("h2o-danube-1.8b", "train_4k",
                              mesh="production", verbose=False)
        assert rec["status"] == "ok" and rec["chips"] == 256
        plan = registry.get("h2o-danube-1.8b").build("train_4k", False)
        mem = rec["memory"]
        assert mem["argument_bytes"] == dryrun.per_device_bytes(plan, False)
        assert 0 < mem["argument_bytes"] < dryrun._nbytes(
            plan.abstract_args) / 10
        assert mem["alias_bytes"] > 0 and mem["temp_bytes"] > 0
        assert mem["peak_per_device"] == mem["argument_bytes"] + \
            mem["temp_bytes"]
        assert mem["fits"] == {"arguments": True, "outputs": True,
                               "peak": True}
        assert mem["device_bytes"] == launch_mesh.CARD_BYTES
        assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes_accessed"] > 0
        assert set(analysis.COLLECTIVES) <= set(rec["collectives"])
        assert rec["collectives"]["all-gather"] > 0 and \
            rec["collectives"]["reduce-scatter"] > 0
        assert set(rec["collectives_by_axis"]) == {"data", "model"}
        assert rec["roofline"]["chips"] == 256
        assert rec["cost_from"] == "counted step"
        assert mem["peak_estimated"] is False
        assert cdist.world_size() == 1          # the fake world is gone

    @pytest.mark.parametrize("arch,from_probes", [
        ("h2o-danube-1.8b", True), ("granite-moe-3b-a800m", True),
        ("qwen3-moe-235b-a22b", False)])
    def test_a_cost_model_of_microbatches_takes_the_probes_where_they_hold(
            self, monkeypatch, arch, from_probes):
        """train_4k at smoke size with 64 rows, 4 a batch rank of the
        (16, 16) mesh: danube and granite name 2 microbatches, so their
        counts come from the reference's model over the probes (L, M) =
        (1, 1), (2, 1), (1, 2), whose FLOPs, bytes and collective bytes lie
        within 1% of a count of the whole step, their collective counts
        equal, and the peak (linear in L) within 2% and marked estimated;
        qwen3 names 16 microbatches, more than a rank's rows, so its step
        is counted whole, as the sharded step runs one microbatch a
        row."""
        _smoke_production(monkeypatch)
        from repro_torch.configs import lm_common
        monkeypatch.setitem(lm_common.LM_SHAPES, "train_4k",
                            dict(kind="train", seq=16, global_batch=64))
        rec = dryrun.run_cell(arch, "train_4k", mesh="production",
                              verbose=False)
        plan = registry.get(arch).build("train_4k", False)
        assert rec["memory"]["argument_bytes"] == \
            dryrun.per_device_bytes(plan, False)
        assert rec["memory"]["peak_estimated"] is from_probes
        if not from_probes:
            assert rec["cost_from"] == "counted step"
            return
        assert rec["cost_from"]["probes"]["M"] == 2
        whole = dryrun._count_production(plan, False, 0)
        assert rec["cost"]["flops"] == pytest.approx(
            whole["cost"]["flops"], rel=1e-2)
        assert rec["cost"]["bytes_accessed"] == pytest.approx(
            whole["cost"]["bytes accessed"], rel=1e-2)
        for k, v in whole["coll"].items():
            if k.startswith("n_"):
                assert rec["collectives"][k] == v, k
            else:
                assert rec["collectives"][k] == pytest.approx(
                    v, rel=1e-2), k
        assert rec["memory"]["temp_bytes"] == pytest.approx(whole["peak"],
                                                            rel=2e-2)

    def test_card_skips_only_what_does_not_fit(self, monkeypatch):
        """A device of 10^9 bytes: a cell whose arguments need more is
        skipped, the reason naming both byte counts; one that fits is
        not."""
        monkeypatch.setattr(dryrun, "device_bytes", lambda dev: 10**9)
        rec, plan = dryrun.plan_cell("deepseek-7b", "train_4k", mesh="card",
                                     device="cpu")
        assert rec["status"] == "skipped"
        need = rec["memory"]["argument_bytes"] + \
            rec["memory"]["stated_output_bytes"] + \
            rec["memory"]["stated_temp_bytes"]
        # the f32 gradient of the f32 parameters
        assert rec["memory"]["stated_temp_bytes"] == \
            dryrun._nbytes(plan.abstract_args[0])
        assert f"{need:,}" in rec["reason"] and "1,000,000,000" in \
            rec["reason"]
        rec, plan = dryrun.plan_cell("pna", "molecule", mesh="card",
                                     device="cpu")
        assert rec["status"] == "fits" and plan is not None

    def test_an_error_is_recorded_as_an_error_and_fails_the_run(
            self, tmp_path, monkeypatch):
        def boom(*a, **k):
            raise torch.OutOfMemoryError("CUDA out of memory (simulated)")
        monkeypatch.setattr(dryrun, "run_plan", boom)
        out = tmp_path / "d.jsonl"
        rc = dryrun.main(["--mesh", "card", "--arch", "pna", "--shape",
                          "molecule", "--device", "cpu", "--out", str(out)])
        rec = json.loads(out.read_text())
        assert rc == 1 and rec["status"] == "error"
        assert "out of memory" in rec["error"]

    def test_main_production_all_and_skip_done(self, tmp_path,
                                               monkeypatch):
        """Every cell on the production mesh at smoke size: all run
        (argument bytes equal to `per_device_bytes`) but the long_500k
        cells of full-attention archs, which keep their own skip; every
        GNN and cpaa record counts collective bytes, its GNN trips over
        the flat axes ("data+model"); a rerun with --skip-done adds
        nothing."""
        _smoke_production(monkeypatch)
        out = tmp_path / "d.jsonl"
        assert dryrun.main(["--all", "--out", str(out)]) == 0
        recs = [json.loads(line) for line in out.read_text().splitlines()]
        assert len(recs) == len(all_cells()) == 47
        ok = [r for r in recs if r["status"] == "ok"]
        skips = [r for r in recs if r["status"] == "skipped"]
        assert len(ok) + len(skips) == 47
        assert {r["arch"] for r in ok} == {
            "h2o-danube-1.8b", "deepseek-7b", "granite-moe-3b-a800m",
            "qwen2.5-32b", "qwen3-moe-235b-a22b", "dlrm-rm2",
            "meshgraphnet", "pna", "dimenet", "graphcast", "cpaa-pagerank"}
        assert len(ok) == 43
        for r in ok:
            plan = registry.get(r["arch"]).build(r["shape"], False)
            assert r["memory"]["argument_bytes"] == \
                dryrun.per_device_bytes(plan, False), (r["arch"], r["shape"])
            assert r["chips"] == 256 and r["roofline"]["chips"] == 256
            if registry.get(r["arch"]).FAMILY in ("gnn", "pagerank"):
                moved = sum(r["collectives"][k]
                            for k in analysis.COLLECTIVES)
                assert moved > 0, (r["arch"], r["shape"])
            if registry.get(r["arch"]).FAMILY == "gnn":
                assert r["collectives_by_axis"]["data+model"], r["shape"]
        assert len(skips) == 4
        assert all(r["shape"] == "long_500k" and "full-attention" in
                   r["reason"] for r in skips)
        assert dryrun.main(["--all", "--out", str(out), "--skip-done"]) == 0
        assert len(out.read_text().splitlines()) == 47

    def test_collective_bytes_per_layer_match_the_closed_form(self):
        """danube-smoke's `forward` as rank 0 of a (2, 4) mesh on a fake
        world of 8 ranks: the counted collectives are, per layer, the
        FSDP all-gathers over "data" of its seven weights (each whole
        along d_model, its own "model" piece of the other dimension), the
        all-gathers of k and v over "model" (4 heads tile 4 ranks, so q
        and the attention output stay local) and the two all-reduces of
        the row-parallel products; and once, the embedding's all-reduce
        and the logits' all-gather over "model"."""
        from repro_torch.configs import h2o_danube_1_8b as dan
        from repro_torch.distributed import sharding as sh
        from repro_torch.models import transformer as tf
        cfg = dan.smoke_config()
        d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
        h, hkv, vp, n_l = cfg.n_heads, cfg.n_kv_heads, cfg.vocab_padded, \
            cfg.n_layers
        dp, tp, b, s = 2, 4, 2, 16           # rank 0's rows of a batch of 4
        f32 = 4
        params = tf.init_params(torch.Generator().manual_seed(0), cfg)
        with cdist.fake_world(dp * tp):
            mesh = cdist.init_mesh((dp, tp), ("data", "model"), "cpu")
            with sh.use_mesh(mesh, sharded=True):
                local = sh.shard_tree(params, sh.lm_param_specs(cfg, False),
                                      mesh)
                cdist.reset_collective_counts()
                tf.forward(local, torch.zeros((b, s), dtype=torch.int32),
                           cfg)
                got = cdist.collective_counts()
        fsdp = (d * h * hd // tp + 2 * d * hkv * hd // tp
                + h * hd // tp * d + 3 * d * f // tp) * f32
        act = b * s * d * f32
        want = {
            "fsdp/weight/all_gather/data": {"calls": 7 * n_l,
                                            "bytes": fsdp * n_l},
            "tp/kv/all_gather/model": {"calls": 2 * n_l,
                                       "bytes": 2 * b * s * hkv * hd * f32
                                       * n_l},
            "tp/leave/all_reduce/model": {"calls": 2 * n_l + 1,
                                          "bytes": act * (2 * n_l + 1)},
            "tp/logits/all_gather/model": {"calls": 1,
                                           "bytes": b * s * vp * f32},
        }
        assert got == want

    @pytest.mark.parametrize("shape", [(1, 3), (2, 4), (2, 2, 2)],
                             ids=["1x3", "2x4", "2x2x2"])
    def test_gnn_collective_bytes_per_layer_match_the_closed_form(
            self, shape):
        """meshgraphnet-smoke's forward as rank 0 on a fake world, its 512
        nodes and 2,048 edges sharded over every axis: per layer, one
        all-gather of the whole h and one reduce-scatter of the whole
        aggregate over the flat axes, n_pad x d x 4 bytes each (n_pad the
        ranks x ceil(n / ranks): 513 on the uneven (1, 3)), and nothing
        else (the encoders, the decoder and the loss are local)."""
        from repro_torch.configs import meshgraphnet as mgn_cfg
        from repro_torch.distributed import sharding as sh
        from repro_torch.models.gnn import meshgraphnet as mgn
        from repro_torch.models.gnn.common import GraphLayout
        cfg = mgn_cfg.smoke_config()
        names = ("pod", "data", "model")[-len(shape):]
        ranks = 1
        for s in shape:
            ranks *= s
        n = 512
        batch = mgn_cfg.make_batch(cfg, dict(n=n, e=2048, d_feat=12),
                                   device="cpu")
        params = mgn.init_params(torch.Generator().manual_seed(0), cfg)
        specs = sh.gnn_batch_specs(batch, "pod" in names)
        layout = GraphLayout.of(batch, specs)
        assert layout.sharded == set(batch)
        with cdist.fake_world(ranks):
            mesh = cdist.init_mesh(shape, names, "cpu")
            with sh.use_mesh(mesh, sharded=True), torch.no_grad():
                local = sh.shard_tree(batch, specs, mesh)
                cdist.reset_collective_counts()
                mgn.forward(params, local, cfg, layout)
                got = cdist.collective_counts()
        n_l = cfg.n_layers
        layer = ranks * -(-n // ranks) * cfg.d_hidden * 4
        axis = "+".join(names)
        assert got == {
            f"gnn/gather/all_gather/{axis}": {"calls": n_l,
                                              "bytes": n_l * layer},
            f"gnn/scatter/reduce_scatter/{axis}": {"calls": n_l,
                                                   "bytes": n_l * layer}}

    @pytest.mark.parametrize("multi_pod", [False, True])
    @pytest.mark.parametrize("shape", ["pr_mesh_67m", "pr_mesh_67m_b128",
                                       "pr_mesh_67m_2d",
                                       "pr_mesh_67m_2d_b128"])
    def test_cpaa_collective_bytes_per_apply_match_the_closed_form(
            self, shape, multi_pod):
        """cpaa's production step as rank 0 of the fake world, on meta
        tensors: per apply (one a round), the 1D partition all-gathers the
        whole x, n x 4 x B bytes over the world; the 2D partition
        reduce-scatters rows_per_chunk x 4 x B bytes over its column group
        and all-gathers cols_per_chunk x 4 x B bytes over its row group
        (grid (32, 16) on two pods); once, the normalization all-reduces
        the B column sums; nothing else, and pi stays in p's layout."""
        from repro_torch.configs import pagerank_cpaa as cpaa
        from repro_torch.core import engine
        from repro_torch.distributed import sharding as sh
        plan = cpaa.build(shape, multi_pod)
        info = cpaa.SHAPES[shape]
        b = info["batch"] or 1
        mesh = launch_mesh.make_production_mesh(multi_pod=multi_pod,
                                                device="cpu", fake=True)
        try:
            with sh.use_mesh(mesh, sharded=True):
                args = plan.local_args(mesh)
                step = plan.static["step_builder"](mesh)
                cdist.reset_collective_counts()
                engine.reset_apply_counts()
                pi = step(*args)
                got = cdist.collective_counts()
                applies = engine.apply_counts()
        finally:
            cdist.destroy_world()
        assert pi.shape == args[0].shape and pi.device.type == "meta"
        n = plan.abstract_args[0].shape[0]
        if info["partition"] == "1d":
            r = applies["sharded_1d"]
            want = {"sharded_1d/apply/all_gather/world": {
                        "calls": r, "bytes": r * n * 4 * b},
                    "sharded_1d/reduce/all_reduce/world": {
                        "calls": 1, "bytes": 4 * b}}
        else:
            rows, cols = (32, 16) if multi_pod else (16, 16)
            r = applies["sharded_2d"]
            want = {"sharded_2d/apply/reduce_scatter/col": {
                        "calls": r, "bytes": r * n // rows * 4 * b},
                    "sharded_2d/apply/all_gather/row": {
                        "calls": r, "bytes": r * n // cols * 4 * b},
                    "sharded_2d/reduce/all_reduce/col": {
                        "calls": 1, "bytes": 4 * b}}
        assert r == plan.cost_model["L"] == 12
        assert got == want

    @pytest.mark.parametrize("multi_pod", [False, True])
    @pytest.mark.parametrize("shape", ["pr_mesh_67m", "pr_mesh_67m_2d",
                                       "pr_mesh_67m_2d_b128"])
    def test_a_cpaa_record_is_a_whole_count_of_the_solve(self, shape,
                                                         multi_pod):
        """cpaa's rounds keep the same vectors live whatever their count,
        so a peak linear in L over the probes of 1 and 2 rounds (the
        second holds one vector more) is wrong for it: its record counts
        the whole solve, and its peak temp, FLOPs, bytes and collectives
        are a whole count's, not estimated, with a peak below the fit's."""
        rec = dryrun.run_cell("cpaa-pagerank", shape, multi_pod,
                              "production", verbose=False)
        plan = registry.get("cpaa-pagerank").build(shape, multi_pod)
        whole = dryrun._count_production(plan, multi_pod, 0)
        assert plan.cost_model["L"] == 12
        assert rec["cost_from"] == "counted step"
        mem = rec["memory"]
        assert mem["peak_estimated"] is False
        assert mem["temp_bytes"] == whole["peak"] > 0
        assert mem["argument_bytes"] == dryrun.per_device_bytes(plan,
                                                                multi_pod)
        assert rec["cost"] == {"flops": whole["cost"]["flops"],
                               "bytes_accessed":
                               whole["cost"]["bytes accessed"]}
        assert rec["collectives"] == whole["coll"]
        fit, _ = dryrun._probe_counts(plan, multi_pod, 0)
        assert whole["peak"] < fit["peak"]

    def test_main_card_cli(self, tmp_path):
        out = tmp_path / "d.jsonl"
        rc = dryrun.main(["--mesh", "card", "--arch", "pna", "--shape",
                          "molecule", "--device", "cpu", "--out", str(out)])
        assert rc == 0
        assert json.loads(out.read_text())["status"] == "ok"

    def test_card_without_a_gpu_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            dryrun.run_cell("pna", "molecule", mesh="card", verbose=False)


def _smoke_production(monkeypatch) -> None:
    """Every LM, DLRM-RM2 and GNN config module's full_config its smoke
    config, and the shapes small (a few rows per batch rank; GNN node and
    edge counts and the cpaa vertex counts still tiling 512), so the
    production mesh's counted meta steps take seconds."""
    from repro_torch.configs import dlrm_rm2, gnn_common, lm_common, \
        pagerank_cpaa
    for arch in ("h2o-danube-1.8b", "deepseek-7b", "granite-moe-3b-a800m",
                 "qwen2.5-32b", "qwen3-moe-235b-a22b", "dlrm-rm2"):
        mod = registry.get(arch)
        monkeypatch.setattr(mod, "full_config", mod.smoke_config)
    for arch in ("meshgraphnet", "pna", "dimenet", "graphcast"):
        mod = registry.get(arch)
        monkeypatch.setattr(mod, "full_config",
                            lambda d_in=None, mod=mod: mod.smoke_config())
    for shape, (n, e) in (("full_graph_sm", (512, 2048)),
                          ("minibatch_lg", (1024, 4096)),
                          ("ogb_products", (1536, 6144)),
                          ("molecule", (768, 2048))):
        monkeypatch.setitem(gnn_common.GNN_SHAPES, shape,
                            dict(n=n, e=e, d_feat=12, note="smoke"))
    for shape, info in pagerank_cpaa.SHAPES.items():
        monkeypatch.setitem(pagerank_cpaa.SHAPES, shape,
                            {**info, "n": 1 << 16})
    monkeypatch.setitem(lm_common.LM_SHAPES, "train_4k",
                        dict(kind="train", seq=16, global_batch=32))
    monkeypatch.setitem(lm_common.LM_SHAPES, "prefill_32k",
                        dict(kind="prefill", seq=32, global_batch=16))
    monkeypatch.setitem(lm_common.LM_SHAPES, "decode_32k",
                        dict(kind="decode", seq=64, global_batch=16))
    monkeypatch.setitem(lm_common.LM_SHAPES, "long_500k",
                        dict(kind="decode", seq=128, global_batch=1))
    for shape, info in (("train_batch", dict(kind="train", batch=64)),
                        ("serve_p99", dict(kind="serve", batch=32)),
                        ("serve_bulk", dict(kind="serve", batch=64)),
                        ("retrieval_cand", dict(kind="retrieval", batch=1,
                                                n_candidates=1024))):
        monkeypatch.setitem(dlrm_rm2.SHAPES, shape, info)


# ----------------------------------------------------------------- roofline --

def _table_rows(text: str) -> list:
    return [[c.strip() for c in line.strip("|").split("|")]
            for line in text.splitlines() if line.startswith("| x |")]


class TestRoofline:
    def test_reference_record_renders_as_the_reference(self, tmp_path):
        """The record of tests/test_launch_cli.py::test_roofline_cli
        through both mains: the same rows in the reference's columns (the
        advice text is the card's)."""
        from repro.launch import roofline as ref_roofline
        src = tmp_path / "dry.jsonl"
        src.write_text(json.dumps(REF_RECORD) + "\n")
        ref_out, port_out = tmp_path / "ref.md", tmp_path / "port.md"
        ref_roofline.main(["--in", str(src), "--out", str(ref_out)])
        port_roofline.main(["--in", str(src), "--out", str(port_out)])
        ref_rows = _table_rows(ref_out.read_text())
        port_rows = _table_rows(port_out.read_text())
        assert len(ref_rows) == len(port_rows) == 2
        assert port_rows[0] == ref_rows[0]                  # dry-run row
        assert port_rows[1][:8] == ref_rows[1][:8]          # roofline row
        assert "x | y" in port_out.read_text()

    def test_card_records_add_the_measured_step(self, tmp_path):
        rec = dryrun.run_plan(_matmul_plan(64, 64, 64),
                              {"arch": "x", "shape": "y", "multi_pod": False,
                               "mesh": "card", "kind": "train", "note": ""},
                              device="cpu", verbose=False, timed=1)
        src = tmp_path / "dry.jsonl"
        src.write_text(json.dumps(rec) + "\n")
        out = tmp_path / "r.md"
        port_roofline.main(["--in", str(src), "--out", str(out)])
        text = out.read_text()
        assert "one card, (1, 1) mesh" in text
        assert "step (measured) | bound / step" in text
        rows = _table_rows(text)
        assert rows[0][3] == "n/a"          # no peak on a CPU
        assert len(rows[1]) == 11

    def test_advice_keeps_the_reference_branches(self):
        base = {"dominant": "memory"}
        assert "KV cache" in port_roofline.advice("a", "decode_32k", base)
        assert "bf16" in port_roofline.advice("a", "train_4k", base)
        assert "NVLink" in port_roofline.advice(
            "cpaa-pagerank", "s", {"dominant": "collective"})
        assert "NCCL" in port_roofline.advice(
            "a", "s", {"dominant": "collective"})
        assert "tensor-core" in port_roofline.advice(
            "a", "s", {"dominant": "compute"})


# --------------------------------------------------------------------- mesh --

def test_rates_are_the_h100s():
    assert launch_mesh.PEAK_FLOPS_BF16 == 989.4e12
    assert launch_mesh.PEAK_FLOPS_F32 == 66.9e12
    assert launch_mesh.HBM_BW == 3.35e12
    assert launch_mesh.NVLINK_BW == 450e9
    assert not hasattr(launch_mesh, "ICI_BW")


def test_production_mesh_raises_at_world_size_one():
    for mp, need in ((False, 256), (True, 512)):
        with pytest.raises(RuntimeError) as err:
            launch_mesh.make_production_mesh(multi_pod=mp, device="cpu")
        assert f"world of {need} ranks" in str(err.value)
        assert "this world has 1" in str(err.value)


def _free_ports(count: int) -> list[int]:
    import socket
    socks = [socket.socket() for _ in range(count)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _env(**extra) -> dict:
    return dict(os.environ, OMP_NUM_THREADS="1",
                PYTHONPATH=os.pathsep.join(
                    [str(SRC), str(HERE), os.environ.get("PYTHONPATH", "")]),
                **extra)


@pytest.fixture(scope="module")
def elastic(tmp_path_factory):
    """{world size: [every rank's result]} for 2, 4 and 8 (gloo groups,
    started together), and the reference's shapes on 8 fake devices."""
    tmp = tmp_path_factory.mktemp("mesh")
    code = ("from repro.launch.mesh import make_elastic_mesh; import json; "
            "print(json.dumps({n: list(make_elastic_mesh(n).devices.shape) "
            "for n in (1, 2, 4, 8)}))")
    ref = subprocess.Popen(
        [sys.executable, "-c", code], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=8",
                 JAX_PLATFORMS="cpu"))
    groups = {}
    for ws, port in zip((2, 4, 8), _free_ports(3)):
        out = tmp / f"world{ws}"
        out.mkdir()
        groups[ws] = (out, [subprocess.Popen(
            [sys.executable, str(HERE / "torch_mesh_worker.py"), str(out)],
            env=_env(RANK=str(r), WORLD_SIZE=str(ws), LOCAL_RANK=str(r),
                     MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(ws)])
    t0 = time.perf_counter()
    res = {}
    try:
        for ws, (out, procs) in groups.items():
            for r, p in enumerate(procs):
                left = max(1.0, TIMEOUT - (time.perf_counter() - t0))
                _, err = p.communicate(timeout=left)
                assert p.returncode == 0, f"world {ws} rank {r}: {err}"
            res[ws] = [json.loads((out / f"rank{r}.json").read_text())
                       for r in range(ws)]
        sout, serr = ref.communicate(timeout=TIMEOUT)
        assert ref.returncode == 0, serr
        res["ref"] = {int(k): v for k, v in json.loads(sout).items()}
    finally:
        for p in [ref] + [p for _, ps in groups.values() for p in ps]:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return res


@pytest.mark.parametrize("world", [1, 2, 4, 8])
def test_elastic_mesh_has_the_reference_shape(elastic, world):
    want = elastic["ref"][world]
    if world == 1:
        from repro_torch.core import distributed as dist_mod
        dist_mod.init_process_group("cpu")
        mesh = launch_mesh.make_elastic_mesh(device="cpu")
        got = [{"shape": list(mesh.shape),
                "names": list(mesh.mesh_dim_names), "world": 1}]
    else:
        got = elastic[world]
        for r in got:
            assert r["world"] == world
            assert f"this world has {world}" in r["refusal"]
    for r in got:
        assert r["shape"] == want and r["names"] == ["data", "model"]


def test_elastic_mesh_rejects_a_count_other_than_the_world():
    with pytest.raises(ValueError, match="world of 1"):
        launch_mesh.make_elastic_mesh(4, device="cpu")


def test_train_launcher_prints_the_elastic_mesh(capsys):
    from repro_torch.launch import train as launch_train
    out = launch_train.main(["--arch", "h2o-danube-1.8b", "--smoke",
                             "--steps", "1", "--global-batch", "2",
                             "--seq-len", "8", "--device", "cpu"])
    assert "mesh: (1, 1) over 1 device(s)" in capsys.readouterr().out
    assert out["mesh"] == (1, 1)
