"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Every test here is marked `gpu` and skips without a CUDA device (a CUDA
kernel has no CPU mode). This file imports neither jax nor the JAX
package, so it also runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.graph import generators
from repro_torch.graph.structure import build_block_ell
from repro_torch.kernels.adamw import ops as adamw_ops
from repro_torch.kernels.adamw.ops import adamw_step, sum_squares
from repro_torch.kernels.adamw.ref import adamw_step_ref
from repro_torch.kernels.bsr_spmm import ops as bsr_ops
from repro_torch.kernels.bsr_spmm.ops import bsr_spmm
from repro_torch.kernels.bsr_spmm.ref import bsr_spmm_ref
from repro_torch.kernels.cheb_step.ops import cheb_step
from repro_torch.kernels.cheb_step.ref import cheb_step_ref
from repro_torch.kernels.embedding_bag import ops as eb_ops
from repro_torch.kernels.embedding_bag.ops import embedding_bag
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref


# One seeded train_batch-shaped case of the whole-table backward: DLRM-RM2's
# 1,703,936 entries (65,536 samples x 26 bags of one row) of power-law ids
# over 2^22 rows, D = 64. tests/fixtures/eb_backward_whole_table.json holds
# it and the digest of the kernel's output from the source before the window
# backward's redesign (probes/eb_window_backward_probe.py wrote it).
WHOLE_TABLE_CASE = {"seed": 0, "entries": 65_536 * 26, "rows": 1 << 22,
                    "dim": 64, "power": 3}


def whole_table_case(device):
    """(spec, ids [n, 1] int32, grad_out [n, D] f32) of WHOLE_TABLE_CASE,
    made with numpy, on `device`."""
    spec = dict(WHOLE_TABLE_CASE)
    rng = np.random.default_rng(spec["seed"])
    ids = (spec["rows"] * rng.random((spec["entries"], 1))
           ** spec["power"]).astype(np.int32)
    g = rng.standard_normal((spec["entries"], spec["dim"]), dtype=np.float32)
    return (spec, torch.from_numpy(ids).to(device),
            torch.from_numpy(g).to(device))


def touched_digest(grad: torch.Tensor, ids: torch.Tensor) -> str:
    """sha256 of the bytes of the rows of grad that ids touch, in row
    order."""
    rows = torch.unique(ids.reshape(-1)).long()
    return hashlib.sha256(grad[rows].cpu().numpy().tobytes()).hexdigest()


@pytest.fixture
def cuda():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in f32
    return torch.device("cuda")


def tpr_file() -> str:
    from repro_torch.core import pagerank
    return pagerank.__file__


def _tiles(block: int, seed: int):
    g = generators.erdos_renyi(max(3 * block, 200), 5.0, seed=seed)
    return build_block_ell(g, block=block)


@pytest.mark.gpu
class TestKernelsOnCard:
    """CUDA kernels vs their plain versions (rtol/atol 1e-5 for the
    block product, whose sums run in different orders; bitwise for the
    elementwise update, which rounds exactly as the plain version)."""

    @pytest.mark.parametrize("bt", [1, 3, 4, 8, 12, 16, 32, 64, 100, 128,
                                    200])
    def test_bsr_spmm_kernel_vs_plain(self, cuda, bt):
        """Both variants (FFMA at BT = 1, 3xTF32 wgmma from 2 on, column
        tiles of 64 and 128, ragged columns, two column tiles at 200)."""
        be = _tiles(128, seed=bt)
        bc = torch.from_numpy(be.block_cols).to(cuda)
        v = torch.from_numpy(be.values).to(cuda)
        x = torch.from_numpy(np.random.default_rng(bt).standard_normal(
            (be.n, bt)).astype(np.float32)).to(cuda)
        before = bsr_ops.launches_by_variant()
        y = bsr_spmm(bc, v, x)
        torch.cuda.synchronize()
        after = bsr_ops.launches_by_variant()
        moved = {k: after[k] - before[k] for k in after}
        assert moved == {k: int(k == bsr_ops.variant(bt)) for k in after}
        torch.testing.assert_close(y, bsr_spmm_ref(bc, v, x), rtol=1e-5,
                                   atol=1e-5)

    @pytest.mark.parametrize("bt, offset", [(13, 0), (16, 1)])
    def test_bsr_spmm_x_rows_tma_cannot_take(self, cuda, bt, offset):
        """x whose rows TMA cannot load (BT % 4 != 0, or a view one float
        into its storage) reaches the wgmma variant through a zero-padded,
        aligned copy; y keeps x's width."""
        be = _tiles(128, seed=30 + bt)
        rng = np.random.default_rng(bt)
        flat = torch.from_numpy(rng.standard_normal(
            be.n * bt + offset).astype(np.float32)).to(cuda)
        x = flat[offset:].view(be.n, bt)
        bc = torch.from_numpy(be.block_cols).to(cuda)
        v = torch.from_numpy(be.values).to(cuda)
        before = bsr_ops.launches_by_variant()["wgmma_3xtf32"]
        y = bsr_spmm(bc, v, x)
        torch.cuda.synchronize()
        assert bsr_ops.launches_by_variant()["wgmma_3xtf32"] == before + 1
        assert y.shape == x.shape and y.is_contiguous()
        torch.testing.assert_close(y, bsr_spmm_ref(bc, v, x), rtol=1e-5,
                                   atol=1e-5)

    @pytest.mark.parametrize("kind", bsr_ops.VARIANTS)
    @pytest.mark.parametrize("bt", [1, 2, 3, 4, 8])
    def test_bsr_spmm_both_variants_at_narrow_widths(self, cuda, kind, bt):
        """Either variant forced at the widths where the dispatch could cut
        (the wgmma variant through a zero-padded x below BT = 4)."""
        be = _tiles(128, seed=40 + bt)
        bc = torch.from_numpy(be.block_cols).to(cuda)
        v = torch.from_numpy(be.values).to(cuda)
        x = torch.from_numpy(np.random.default_rng(bt).standard_normal(
            (be.n, bt)).astype(np.float32)).to(cuda)
        y = bsr_ops.bsr_spmm_as(bc, v, x, kind)
        torch.cuda.synchronize()
        torch.testing.assert_close(y, bsr_spmm_ref(bc, v, x), rtol=1e-5,
                                   atol=1e-5)

    @pytest.mark.parametrize("kind", bsr_ops.VARIANTS)
    def test_bsr_spmm_large_dynamic_range_dense_tiles(self, cuda, kind):
        """Random tiles of about 50 nonzeros per row (96 row blocks, S = 8,
        5% fill, values up to 1/8) times x of magnitude 1e-6..1e2 with
        random signs: row sums cancel, so every product's rounding shows.
        Each variant is held to the plain version."""
        gen = torch.Generator(device=cuda).manual_seed(0)
        n_rb, slots = 96, 8
        bc = torch.randint(0, n_rb, (n_rb, slots), device=cuda,
                           dtype=torch.int32, generator=gen)
        mask = torch.rand(n_rb, slots, 128, 128, device=cuda,
                          generator=gen) < 0.05
        v = torch.rand(n_rb, slots, 128, 128, device=cuda,
                       generator=gen) * mask / 8.0
        mag = 10.0 ** (torch.rand(n_rb * 128, 16, device=cuda,
                                  generator=gen) * 8 - 6)
        x = (mag * (torch.randint(0, 2, mag.shape, device=cuda,
                                  generator=gen) * 2 - 1)).float()
        y = bsr_ops.bsr_spmm_as(bc, v, x, kind)
        torch.cuda.synchronize()
        torch.testing.assert_close(y, bsr_spmm_ref(bc, v, x), rtol=1e-5,
                                   atol=1e-5)

    def test_bsr_spmm_large_dynamic_range(self, cuda):
        """x spans 1e-6 to 1e2 in magnitude within each column, random
        signs: the 3xTF32 split keeps 1e-5 where a single TF32 pass would
        lose the small entries' share and the large ones' low bits."""
        be = _tiles(128, seed=21)
        rng = np.random.default_rng(21)
        mag = 10.0 ** rng.uniform(-6.0, 2.0, (be.n, 16))
        x = torch.from_numpy((mag * rng.choice([-1.0, 1.0], mag.shape))
                             .astype(np.float32)).to(cuda)
        bc = torch.from_numpy(be.block_cols).to(cuda)
        v = torch.from_numpy(be.values).to(cuda)
        before = bsr_ops.launches_by_variant()["wgmma_3xtf32"]
        y = bsr_spmm(bc, v, x)
        torch.cuda.synchronize()
        assert bsr_ops.launches_by_variant()["wgmma_3xtf32"] == before + 1
        torch.testing.assert_close(y, bsr_spmm_ref(bc, v, x), rtol=1e-5,
                                   atol=1e-5)

    @pytest.mark.parametrize("n", [1, 64, 1003, 10_001])
    @pytest.mark.parametrize("ndim", [1, 2])
    def test_cheb_step_kernel_vs_plain(self, cuda, n, ndim):
        shape = (n,) if ndim == 1 else (n, 5)
        rng = np.random.default_rng(n)
        y, t, acc = (torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(cuda) for _ in range(3))
        ck = torch.tensor(0.37, device=cuda)
        tk, ak = cheb_step(y, t, acc, ck)
        torch.cuda.synchronize()
        tr, ar = cheb_step_ref(y, t, acc, ck)
        assert torch.equal(tk, tr) and torch.equal(ak, ar)

    @pytest.mark.parametrize("dim", [8, 13, 64, 128])
    @pytest.mark.parametrize("bag", [1, 4, 26])
    def test_embedding_bag_kernel_vs_plain(self, cuda, dim, bag):
        rng = np.random.default_rng(dim * 100 + bag)
        table = torch.from_numpy(rng.standard_normal((1000, dim)).astype(
            np.float32)).to(cuda)
        ids = torch.from_numpy(rng.integers(0, 1000, (333, bag)).astype(
            np.int32)).to(cuda)
        w = torch.from_numpy(rng.random((333, bag)).astype(np.float32)).to(
            cuda)
        before = eb_ops.launches()
        out = embedding_bag(ids, table, w)
        unit = embedding_bag(ids, table)
        torch.cuda.synchronize()
        assert eb_ops.launches() == before + 2
        torch.testing.assert_close(out, embedding_bag_ref(ids, table, w),
                                   rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(unit, embedding_bag_ref(ids, table),
                                   rtol=1e-5, atol=1e-5)
        if bag == 1:     # a unit-weight single-row bag is an exact copy
            assert torch.equal(unit, table[ids[:, 0].long()])

    def test_embedding_bag_unaligned_view(self, cuda):
        """A table view that is not 16-byte aligned takes the scalar path."""
        base = torch.randn(101 * 64 + 1, device=cuda)
        table = base[1:].view(101, 64)
        ids = torch.randint(0, 101, (50, 3), device=cuda, dtype=torch.int32)
        out = embedding_bag(ids, table)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, embedding_bag_ref(ids, table),
                                   rtol=1e-5, atol=1e-5)

    def test_bsr_spmm_rejects_other_blocks_on_card(self, cuda):
        be = _tiles(32, seed=11)
        with pytest.raises(ValueError):
            bsr_spmm(torch.from_numpy(be.block_cols).to(cuda),
                     torch.from_numpy(be.values).to(cuda),
                     torch.zeros(be.n, 2, device=cuda))


@pytest.mark.gpu
class TestPathOnCard:
    """The solver and the service through the kernels on the card."""

    def test_fused_solve_matches_plain_solve(self, cuda):
        from repro_torch.core.engine import FusedBlockEllEngine
        from repro_torch.core.pagerank import cpaa_adaptive
        g = generators.tri_mesh(60, 70)
        eng = FusedBlockEllEngine.from_graph(g, device=cuda)
        p = torch.zeros(g.n, 16, device=cuda)
        p[torch.arange(16, device=cuda) * 97, torch.arange(16, device=cuda)] = 1
        bsr_ops.reset_launches()
        rk = cpaa_adaptive(eng, tol=1e-4, p=p)
        assert bsr_ops.launches() > 0
        rp = cpaa_adaptive(eng.with_kernels(False), tol=1e-4, p=p)
        assert np.array_equal(rk.column_rounds, rp.column_rounds)
        assert float((rk.pi - rp.pi).abs().sum(0).max()) <= 1e-5

    def test_service_on_cuda(self, cuda):
        from dataclasses import replace
        from repro_torch.configs import pagerank_serve as cfgs
        cfg = replace(cfgs.smoke_config(), engine="fused")
        svc = cfgs.make_service(cfg)
        assert svc.registry.device.type == "cuda"
        r = svc.query("mesh", (3, 40), top_k=8)
        assert r.indices.shape == (8,) and np.all(np.diff(r.scores) <= 0)


@pytest.mark.gpu
class TestServeTierOnCard:
    """The hub/tail engine, the in-place update patch and async dispatch
    on the card, each against the same work on the CPU or through COO."""

    def test_hub_tail_matches_coo_on_card(self, cuda):
        """f32 hub/tail vs COO on seeded columns (L1 1e-5); bf16 inv_deg
        vs COO on the uniform personalization the reference's bf16 bound
        is stated for (1e-3), and on the seeded columns vs the same bf16
        engine on the CPU (1e-5: the packing is the same, the sums are
        not)."""
        from repro_torch.core.engine import CooEngine, HubTailEngine
        from repro_torch.core.pagerank import cpaa
        from repro_torch.graph.datasets import chung_lu
        from repro_torch.graph.ops import device_graph
        g = chung_lu(20_000, avg_deg=16.0, seed=1)
        p = torch.zeros(g.n, 8)
        p[torch.arange(8) * 2011, torch.arange(8)] = 1
        ref = cpaa(CooEngine(device_graph(g, device=cuda)), tol=1e-6,
                   p=p.to(cuda)).pi
        eng = HubTailEngine.from_graph(g, device=cuda)
        assert eng.n_hubs > 0 and eng.device.type == "cuda"
        pi = cpaa(eng, tol=1e-6, p=p.to(cuda)).pi
        assert float((pi - ref).abs().sum(0).max()) <= 1e-5
        bf = HubTailEngine.from_graph(g, weight_dtype="bfloat16", device=cuda)
        bf_cpu = HubTailEngine.from_graph(g, weight_dtype="bfloat16",
                                          device="cpu")
        assert torch.equal(bf.inv_deg.cpu(), bf_cpu.inv_deg)
        pi_b = cpaa(bf, tol=1e-6, p=p.to(cuda)).pi.cpu()
        pi_bc = cpaa(bf_cpu, tol=1e-6, p=p).pi
        assert float((pi_b - pi_bc).abs().sum(0).max()) <= 1e-5
        u = torch.full((g.n,), 1.0 / g.n, device=cuda)
        ref_u = cpaa(CooEngine(device_graph(g, device=cuda)), tol=1e-6,
                     p=u).pi
        assert float((cpaa(bf, tol=1e-6, p=u).pi - ref_u).abs().sum()) \
            <= 1e-3

    @pytest.mark.parametrize("weight_dtype", [None, "bfloat16"])
    @pytest.mark.parametrize("batch", [3, 40])
    def test_patch_round_trip_on_card(self, cuda, batch, weight_dtype):
        """Both patch strategies write into the same CUDA tensors; the
        patched weights equal the mirror's cast, and insert-then-delete
        restores every tensor bitwise."""
        from repro_torch.graph.ops import EdgeSlots, patch_device_graph
        from repro_torch.graph.structure import edge_delta
        g = generators.tri_mesh(9, 11)
        es = EdgeSlots.from_graph(g, 1024)
        dg = es.to_device(weight_dtype=weight_dtype, device=cuda)
        fields = ("src", "dst", "w", "inv_deg")
        held = {k: getattr(dg, k) for k in fields}
        orig = {k: v.clone() for k, v in held.items()}
        ins = [i * g.n + i + 13 for i in range(batch)]
        patch_device_graph(dg, es.apply_delta(
            edge_delta(g.n, es.ekeys, ins, ())))
        wdtype = torch.float32 if weight_dtype is None else torch.bfloat16
        assert torch.equal(dg.w.cpu(), torch.from_numpy(es.w64).to(wdtype))
        assert torch.equal(dg.src.cpu(), torch.from_numpy(es.src))
        patch_device_graph(dg, es.apply_delta(
            edge_delta(g.n, es.ekeys, (), ins)))
        for k in fields:
            assert getattr(dg, k) is held[k], k
            assert torch.equal(getattr(dg, k), orig[k]), k

    def test_async_tick_fenced_by_its_event(self, cuda):
        from repro_torch.serve import GraphRegistry, PageRankService, \
            PPRQuery
        g = generators.tri_mesh(40, 50)
        answers = []
        for async_dispatch in (False, True):
            reg = GraphRegistry(engine="fused", device=cuda)
            reg.register("g", g)
            svc = PageRankService(reg, max_batch=4, cache_capacity=0,
                                  adaptive=False,
                                  async_dispatch=async_dispatch)
            for i in range(8):
                svc.submit(PPRQuery(qid=i, graph="g", seeds=(7 * i + 1,)))
            svc.tick(force=True)
            if async_dispatch:
                rec = svc._inflight[0]
                assert isinstance(rec.event, torch.cuda.Event)
                assert rec.idx.is_pinned() and svc.pending() == 8
            answers.append(svc.run_until_drained())
        sync, awaited = answers
        assert sorted(sync) == sorted(awaited) == list(range(8))
        for qid in sync:
            assert np.array_equal(awaited[qid].indices, sync[qid].indices)
            np.testing.assert_allclose(awaited[qid].scores, sync[qid].scores,
                                       rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
class TestDlrmOnCard:
    """DLRM serve_step on the card (through the embedding_bag kernel) vs
    the same parameters and batch on the CPU (plain version): rtol 1e-5 /
    atol 1e-6 on the probabilities, cuBLAS and the CPU sum in other
    orders."""

    def test_serve_step_card_vs_cpu(self, cuda):
        import dataclasses
        from repro_torch.configs import dlrm_rm2
        from repro_torch.models.recsys import dlrm
        cfg = dataclasses.replace(dlrm_rm2.smoke_config(), bag_size=3)
        params = dlrm.init_params(cfg, seed=0)
        batch = dlrm_rm2.make_batch(cfg, 64, seed=1, with_labels=False)
        eb_ops.reset_launches()
        on_card = dlrm.serve_step(params, batch, cfg)
        torch.cuda.synchronize()
        assert eb_ops.launches() == 1
        to_cpu = {k: v.cpu() for k, v in batch.items()}
        cpu_params = {"table": params["table"].cpu(),
                      "bot": [{k: v.cpu() for k, v in p.items()}
                              for p in params["bot"]],
                      "top": [{k: v.cpu() for k, v in p.items()}
                              for p in params["top"]]}
        on_cpu = dlrm.serve_step(cpu_params, to_cpu, cfg)
        torch.testing.assert_close(on_card.cpu(), on_cpu, rtol=1e-5,
                                   atol=1e-6)
        scores, idx = dlrm.retrieval_step(
            params, {"dense": batch["dense"][:1],
                     "candidates": torch.randn(5000, cfg.embed_dim,
                                               device=cuda)}, cfg, top_k=50)
        assert idx.dtype == torch.int32 and bool((scores[:-1] >= scores[1:])
                                                  .all())


@pytest.mark.gpu
class TestSlice5OnCard:
    """Measured selection, the traced tick and the paper's baseline on the
    card."""

    def test_tuned_selection_times_the_fused_kernels(self, cuda, tmp_path):
        from repro_torch.core.autotune import Autotuner, TuningStore
        from repro_torch.core.engine import select_engine
        from repro_torch.kernels.cheb_step import ops as cheb_ops
        g = generators.tri_mesh(60, 70)
        tuner = Autotuner(TuningStore(tmp_path / "t.json"), budget_s=60.0)
        bsr_ops.reset_launches()
        cheb_ops.reset_launches()
        eng = select_engine(g, 128, mode="tuned", tuner=tuner)
        entry = next(iter(tuner.store.entries().values()))
        assert entry["backend"] == "torch-cuda"
        assert entry["device_name"] == torch.cuda.get_device_name(0)
        assert "fused" in entry["candidates"] and "coo" in entry["candidates"]
        assert bsr_ops.launches_by_variant()["wgmma_3xtf32"] > 0
        assert cheb_ops.launches() > 0
        assert eng.device.type == "cuda"
        warm = Autotuner(TuningStore(tmp_path / "t.json"))
        select_engine(g, 128, mode="tuned", tuner=warm)
        assert warm.measured_count() == 0

    def test_traced_tick_device_span(self, cuda, tmp_path):
        from repro_torch.obs.export import validate_snapshot
        from repro_torch.obs.trace import profiled
        from repro_torch.serve import GraphRegistry, PageRankService, \
            PPRQuery
        reg = GraphRegistry(engine="fused", device=cuda)
        reg.register("g", generators.tri_mesh(60, 70))
        svc = PageRankService(reg, max_batch=8, adaptive=True)
        for i in range(8):
            svc.submit(PPRQuery(qid=i, graph="g", seeds=(11 * i + 3,)))
        with profiled(str(tmp_path)):
            svc.tick(force=True)
        text = next(tmp_path.glob("trace_*.json")).read_text()
        assert "bsr_spmm" in text and "cheb_step" in text
        spans = [s for t in svc.metrics.tracer.finished for s in t.spans
                 if s.name == "solve_device"]
        assert len(spans) == 8
        assert all(s.kind == "device" and s.duration > 0 for s in spans)
        tick = svc.metrics.convergence.ticks[-1]
        assert tick.rounds_used <= tick.rounds_bound
        assert np.isfinite(tick.residual)
        assert validate_snapshot(svc.snapshot()) == []

    def test_power_on_fused_matches_plain(self, cuda):
        from repro_torch.core.engine import FusedBlockEllEngine
        from repro_torch.core.pagerank import power
        g = generators.tri_mesh(60, 70)
        eng = FusedBlockEllEngine.from_graph(g, device=cuda)
        bsr_ops.reset_launches()
        rk = power(eng, tol=1e-5)
        assert bsr_ops.launches_by_variant()["ffma"] >= rk.iterations
        rp = power(eng.with_kernels(False), tol=1e-5)
        assert rk.iterations == rp.iterations
        assert float((rk.pi - rp.pi).abs().sum()) <= 1e-5


@pytest.mark.gpu
class TestShardedOnCard:
    """The sharded engines at NCCL world size 1 (a single-rank group on an
    in-process store) against COO on the card; no gloo on cuda."""

    @pytest.mark.parametrize("mode", ["sharded_1d", "sharded_2d"])
    @pytest.mark.parametrize("b", [None, 16])
    def test_sharded_matches_coo_on_card(self, cuda, mode, b):
        import torch.distributed as dist
        from repro_torch.core.engine import (collective_counts,
                                             reset_collective_counts,
                                             select_engine)
        from repro_torch.core.pagerank import cpaa, cpaa_adaptive
        g = generators.tri_mesh(60, 70)
        eng = select_engine(g, mode=mode, device=cuda)
        assert "nccl" in str(dist.get_backend())
        assert eng.device.type == "cuda"
        coo = select_engine(g, mode="coo", device=cuda)
        p = None if b is None else torch.from_numpy(
            np.random.default_rng(b).random((g.n, b)).astype(np.float32)
        ).to(cuda)
        reset_collective_counts()
        pi = cpaa(eng, 0.85, 1e-8, p=p).pi
        assert any(k.startswith(mode + "/apply/") for k in
                   collective_counts())
        ref = cpaa(coo, 0.85, 1e-8, p=p).pi
        assert float((pi - ref).abs().sum(dim=0).max()) <= 1e-5
        ra = cpaa_adaptive(eng, 0.85, 1e-6, p=p)
        rc = cpaa_adaptive(coo, 0.85, 1e-6, p=p)
        assert ra.iterations == rc.iterations
        assert float((ra.pi - rc.pi).abs().sum(dim=0).max()) <= 1e-5

    def test_bf16_wire_on_card(self, cuda):
        from repro_torch.core.engine import Sharded2DEngine, select_engine
        from repro_torch.core.pagerank import cpaa
        g = generators.tri_mesh(60, 70)
        eng = Sharded2DEngine.from_graph(g, grid=(1, 1), device=cuda,
                                         comm_dtype=torch.bfloat16)
        pi = cpaa(eng, 0.85, 1e-6).pi.double().cpu().numpy()
        ref = cpaa(select_engine(g, mode="coo", device=cuda), 0.85,
                   1e-6).pi.double().cpu().numpy()
        assert np.max(np.abs(pi - ref) / ref) < 2e-2
        top = set(np.argsort(-ref)[: g.n // 10].tolist())
        assert len(top & set(np.argsort(-pi)[: g.n // 10].tolist())) \
            >= 0.95 * len(top)


@pytest.mark.gpu
class TestGnnOnCard:
    """The GNN zoo's train step on the card against the same step on the
    CPU (rtol 1e-4 on the loss and grad norm: f32 on both, TF32 off, the
    card's index_add_ adds in no fixed order), and the checkpoint replay
    bit for bit with deterministic algorithms on."""

    @pytest.mark.parametrize("arch", ["meshgraphnet", "pna", "dimenet",
                                      "graphcast"])
    def test_smoke_step_card_vs_cpu(self, cuda, arch):
        import importlib
        from functools import partial

        from torch.utils import _pytree as pytree

        from repro_torch.configs import gnn_common as gc
        from repro_torch.train.optimizer import AdamWConfig, adamw_init
        from repro_torch.train.train_loop import make_train_step
        cfg_mod = importlib.import_module(f"repro_torch.configs.{arch}")
        model = importlib.import_module(f"repro_torch.models.gnn.{arch}")
        cfg = cfg_mod.smoke_config()
        gen = torch.Generator().manual_seed(0)
        if arch == "graphcast":
            params = cfg_mod._init(gen, cfg, 12)
            batch = cfg_mod.make_batch(cfg, gc.gnn_smoke_dims(), d_in=12,
                                       device="cpu")
        else:
            params = model.init_params(gen, cfg)
            batch = cfg_mod.make_batch(cfg, gc.gnn_smoke_dims(),
                                       device="cpu")
        opt_cfg = AdamWConfig(lr=1e-3)
        step = make_train_step(partial(model.loss_fn, cfg=cfg), opt_cfg,
                               donate=False)
        out = {}
        for dev in ("cpu", cuda):
            p = pytree.tree_map(lambda t: t.detach().to(dev), params)
            b = {k: v.to(dev) for k, v in batch.items()}
            _, _, m = step(p, adamw_init(p, opt_cfg), b)
            out[str(dev)] = {k: float(v) for k, v in m.items()}
        for k in ("loss", "grad_norm"):
            assert out["cuda"][k] == pytest.approx(out["cpu"][k], rel=1e-4)

    def test_checkpoint_replay_bit_exact(self, cuda, tmp_path):
        from functools import partial

        from repro_torch.graph import generators
        from repro_torch.launch import train_gnn
        from repro_torch.models.gnn import pna
        from repro_torch.train.data import GraphBatchPipeline
        from repro_torch.train.optimizer import AdamWConfig, adamw_init
        from repro_torch.train.train_loop import make_train_step
        g = generators.powerlaw_ba(2_000, 4, seed=0)
        pr, feats, targets, delta = train_gnn.pagerank_task(g, cuda)
        cfg = pna.PNAConfig(name="t", n_layers=3, d_hidden=32,
                            d_in=feats.shape[1], d_out=targets.shape[1],
                            delta=delta)
        params = pna.init_params(torch.Generator(device=cuda).manual_seed(0),
                                 cfg)
        opt_cfg = AdamWConfig(lr=2e-3, weight_decay=0.01)
        step = make_train_step(partial(pna.loss_fn, cfg=cfg), opt_cfg,
                               donate=False)
        pipe = GraphBatchPipeline(g, feats, targets, 64, (8, 5), seed=1,
                                  ppr_weights=pr, device=cuda)
        torch.use_deterministic_algorithms(True)
        try:
            out = train_gnn.fit(step, params, adamw_init(params, opt_cfg),
                                pipe, 6, tmp_path, async_save=True)
            rp, rm, _ = train_gnn.replay(
                step, tmp_path, {"params": out["params"],
                                 "opt": out["opt"]}, pipe)
        finally:
            torch.use_deterministic_algorithms(False)
        assert np.isfinite(out["losses"]).all()
        assert train_gnn.tree_max_gap(out["reference"][0], rp) == 0.0
        assert torch.equal(out["reference"][1]["loss"], rm["loss"])


@pytest.mark.gpu
class TestLmOnCard:
    """The LM serve path on the card at danube's smoke widths: the f32
    engine (TF32 off) against naive greedy decoding by full forwards, and
    the KV cache written in place."""

    def _lm(self, cuda):
        from repro_torch.configs import h2o_danube_1_8b
        from repro_torch.models import transformer as tf
        cfg = h2o_danube_1_8b.smoke_config()
        params = tf.init_params(torch.Generator(device=cuda).manual_seed(0),
                                cfg)
        return cfg, params

    def test_engine_matches_naive_greedy_f32(self, cuda):
        from repro_torch.models import transformer as tf
        from repro_torch.serve.engine import Request, ServeEngine
        cfg, params = self._lm(cuda)
        prompt = np.array([3, 7, 1, 9, 4], np.int32)
        req = Request(rid=0, prompt=prompt, max_new_tokens=6)
        ServeEngine(params, cfg, max_batch=4, max_len=32,
                    device=cuda).run_until_drained([req])
        assert req.done and len(req.out_tokens) >= 6
        toks, ref = list(prompt), []
        for _ in range(len(req.out_tokens)):
            logits, _ = tf.forward(params, torch.tensor([toks], device=cuda),
                                   cfg)
            ref.append(int(logits[0, -1].argmax()))
            toks.append(ref[-1])
        assert req.out_tokens == ref

    def test_kv_cache_updated_in_place(self, cuda):
        from repro_torch.serve.engine import Request, ServeEngine
        cfg, params = self._lm(cuda)
        eng = ServeEngine(params, cfg, max_batch=2, max_len=32, device=cuda)
        ptrs = [t.data_ptr() for t in eng.kv]
        reqs = [Request(rid=i, prompt=np.arange(3 + i, dtype=np.int32),
                        max_new_tokens=5) for i in range(3)]
        pending = list(reqs)
        while pending or eng.active():
            while pending and eng.submit(pending[0]):
                pending.pop(0)
            eng.tick()
            assert [t.data_ptr() for t in eng.kv] == ptrs
        assert all(r.done for r in reqs)
        assert eng.stats["ticks"] > 0


@pytest.mark.gpu
class TestTrainingOnCard:
    """Training on the card: the embedding_bag backward kernel against its
    plain version (max |err| <= 1e-5 of the sum of |terms| per element,
    against a float64 `index_add_`: f32 sums of up to thousands of terms
    in another order) and bitwise from run to run (sorted segments, no
    atomics); one DLRM step at smoke size through both kernels against
    the same step on the CPU; one LM step in bf16 through the
    differentiable f32-output GEMM."""

    @staticmethod
    def _hold_backward(ids, g, rows, w=None):
        """The backward kernel on (ids, g, w) into [rows, D], launched
        twice: one count per launch, bitwise equal, within 1e-5 of the sum
        of |terms| per element of a float64 `index_add_` and of the plain
        f32 version, zero on every row no id reads."""
        from repro_torch.kernels.embedding_bag.ops import \
            embedding_bag_backward
        from repro_torch.kernels.embedding_bag.ref import \
            embedding_bag_backward_ref
        before = eb_ops.backward_launches()
        got = embedding_bag_backward(ids, g, rows, w)
        again = embedding_bag_backward(ids, g, rows, w)
        torch.cuda.synchronize()
        assert eb_ops.backward_launches() == before + 2
        assert torch.equal(got, again)
        w64 = None if w is None else w.double()
        want = embedding_bag_backward_ref(ids, g.double(), rows, w64)
        mag = embedding_bag_backward_ref(
            ids, g.double().abs(), rows, None if w is None else w64.abs())
        err = (got.double() - want).abs()
        assert bool((err <= 1e-5 * mag + 1e-30).all()), float(
            (err / mag.clamp(min=1e-30)).max())
        plain = embedding_bag_backward_ref(ids, g, rows, w)
        assert bool(((got - plain).abs().double() <= 1e-5 * mag
                     + 1e-30).all())
        read = torch.zeros(rows, dtype=torch.bool, device=ids.device)
        read[ids.reshape(-1).long()] = True
        assert not got[~read].any()        # rows no id reads stay zero

    @staticmethod
    def _case(cuda, ids: np.ndarray, dim: int, weighted: bool, rng):
        g = torch.from_numpy(rng.standard_normal(
            (ids.shape[0], dim)).astype(np.float32)).to(cuda)
        w = torch.from_numpy(rng.standard_normal(ids.shape).astype(
            np.float32)).to(cuda) if weighted else None
        return torch.from_numpy(ids.astype(np.int32)).to(cuda), g, w

    @pytest.mark.parametrize("n_bags,bag,dim,vocab", [
        (1, 1, 64, 10), (333, 1, 64, 5), (333, 3, 13, 1000),
        (5000, 2, 100, 7), (70_000, 1, 64, 3), (1234, 26, 8, 50_000)])
    @pytest.mark.parametrize("weighted", [False, True])
    def test_embedding_bag_backward_vs_plain(self, cuda, n_bags, bag, dim,
                                             vocab, weighted):
        rng = np.random.default_rng(n_bags + bag + dim)
        # power-law ids: a few hot rows take most of the adds
        ids = (vocab * rng.random((n_bags, bag)) ** 3).astype(np.int32)
        ids, g, w = self._case(cuda, ids, dim, weighted, rng)
        self._hold_backward(ids, g, vocab + 3, w)

    @pytest.mark.parametrize("weighted", [False, True])
    def test_backward_one_segment_over_a_thousand_chunks(self, cuda,
                                                         weighted):
        """One id for all 300,000 entries: a single segment across 1,172
        chunks, the join's longest search and deepest sum."""
        assert eb_ops.backward_plan(300_000)[1] > 1000
        ids, g, w = self._case(cuda, np.zeros((300_000, 1)), 64, weighted,
                               np.random.default_rng(1))
        self._hold_backward(ids, g, 5, w)

    @pytest.mark.parametrize("bag", [1, 2])
    def test_backward_segments_around_the_tile(self, cuda, bag):
        """Segments of tile - 1, tile, tile + 1 and 2 tile entries (and
        single ones) in one input, so chunk boundaries (one per tile here)
        fall at, one before and one after a segment's ends; the entries
        shuffled across bags."""
        t = eb_ops.TILE
        lens = [t - 1, t, t + 1, 2 * t, 1, t - 1, t + 1, 2 * t, t, 1]
        rng = np.random.default_rng(bag)
        flat = rng.permutation(np.repeat(np.arange(len(lens)), lens))
        ids, g, w = self._case(cuda, flat.reshape(-1, bag), 64, True, rng)
        self._hold_backward(ids, g, len(lens) + 2, w)

    def test_backward_all_ids_distinct(self, cuda):
        rng = np.random.default_rng(3)
        ids, g, w = self._case(cuda, rng.permutation(100_000)[:, None], 64,
                               False, rng)
        self._hold_backward(ids, g, 100_000)

    @pytest.mark.parametrize("dim", [1, 3, 65, 130, 256])
    @pytest.mark.parametrize("weighted", [False, True])
    def test_backward_widths(self, cuda, dim, weighted):
        """Odd widths take one float per lane, even ones two; 65, 130 and
        256 take several column sweeps."""
        rng = np.random.default_rng(dim)
        ids = (500 * rng.random((20_000, 2)) ** 3).astype(np.int32)
        ids, g, w = self._case(cuda, ids, dim, weighted, rng)
        self._hold_backward(ids, g, 503, w)

    @pytest.mark.parametrize("weighted", [False, True])
    def test_backward_fewer_entries_than_a_tile(self, cuda, weighted):
        rng = np.random.default_rng(7)
        ids = (40 * rng.random((50, 2)) ** 2).astype(np.int32)
        assert ids.size < eb_ops.TILE
        ids, g, w = self._case(cuda, ids, 64, weighted, rng)
        self._hold_backward(ids, g, 43, w)

    def test_backward_plan_is_one_wave(self, cuda):
        """An H100 holds ops.CHUNKS warps of the pieces pass at once (4
        blocks of 8 per SM), so the plan's chunks run in one wave."""
        from repro_torch.kernels import _build
        lib = _build.library("embedding_bag_backward")
        assert lib.embedding_bag_backward_blocks_per_sm() * 8 * 132 >= \
            eb_ops.CHUNKS

    def test_embedding_bag_autograd_launches_both_kernels(self, cuda):
        table = torch.randn(50, 16, device=cuda, requires_grad=True)
        ids = torch.randint(0, 50, (40, 2), device=cuda, dtype=torch.int32)
        eb_ops.reset_launches()
        embedding_bag(ids, table).square().sum().backward()
        torch.cuda.synchronize()
        assert eb_ops.launches() == 1 and eb_ops.backward_launches() == 1
        t2 = table.detach().clone().requires_grad_(True)
        embedding_bag_ref(ids.long(), t2).square().sum().backward()
        torch.testing.assert_close(table.grad, t2.grad, rtol=1e-5,
                                   atol=1e-6)

    def test_dlrm_step_card_vs_cpu(self, cuda):
        from functools import partial
        from torch.utils import _pytree as pytree
        from repro_torch.configs import dlrm_rm2
        from repro_torch.models.recsys import dlrm
        from repro_torch.train.optimizer import AdamWConfig, adamw_init
        from repro_torch.train.train_loop import make_train_step
        cfg = dlrm_rm2.smoke_config()
        params = dlrm.init_params(cfg, seed=0)
        batch = dlrm_rm2.make_batch(cfg, 64, seed=1)
        cpu_params = pytree.tree_map(lambda t: t.cpu(), params)
        cpu_batch = {k: v.cpu() for k, v in batch.items()}
        opt_cfg = AdamWConfig(lr=1e-3)
        step = make_train_step(partial(dlrm.loss_fn, cfg=cfg), opt_cfg)
        eb_ops.reset_launches()
        p, _, m = step(params, adamw_init(params, opt_cfg), batch)
        torch.cuda.synchronize()
        assert eb_ops.launches() == 1 and eb_ops.backward_launches() == 1
        cp, _, cm = step(cpu_params, adamw_init(cpu_params, opt_cfg),
                         cpu_batch)
        for k in ("loss", "grad_norm"):
            torch.testing.assert_close(m[k].cpu(), cm[k], rtol=1e-5,
                                       atol=1e-7)
        # a step-1 update is ~lr * sign(g): a gradient at noise level may
        # take the other sign on the other device
        for a, b in zip(pytree.tree_leaves(p), pytree.tree_leaves(cp)):
            assert float((a.cpu() - b).abs().max()) <= 2.0001 * opt_cfg.lr
        # the gradients themselves, GNN suite's bounds
        grads = []
        for prm, bt in ((dlrm.init_params(cfg, seed=0), batch),
                        (pytree.tree_map(lambda t: t.cpu(),
                                         dlrm.init_params(cfg, seed=0)),
                         cpu_batch)):
            leaves = [t.requires_grad_(True)
                      for t in pytree.tree_leaves(prm)]
            grads.append(torch.autograd.grad(
                dlrm.loss_fn(prm, bt, cfg), leaves))
        for a, b in zip(*grads):
            torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-6)

    def test_lm_bf16_step_runs_and_f32_matches_cpu(self, cuda):
        import dataclasses
        from functools import partial
        from torch.utils import _pytree as pytree
        from repro_torch.configs import granite_moe_3b
        from repro_torch.models import transformer as tf
        from repro_torch.train.data import TokenPipelineConfig, token_batch
        from repro_torch.train.optimizer import AdamWConfig, adamw_init
        from repro_torch.train.train_loop import make_train_step
        cfg = granite_moe_3b.smoke_config()
        params = tf.init_params(torch.Generator(device=cuda).manual_seed(0),
                                cfg)
        batch = token_batch(TokenPipelineConfig(cfg.vocab, 16, 4), 0, cuda)
        opt_cfg = AdamWConfig(lr=1e-3)
        loss = {}
        for dt in ("float32", "bfloat16"):
            c = dataclasses.replace(cfg, compute_dtype=dt)
            p = pytree.tree_map(lambda t: t.clone(), params)
            _, _, m = make_train_step(partial(tf.loss_fn, cfg=c), opt_cfg,
                                      num_microbatches=2)(
                p, adamw_init(p, opt_cfg), batch)
            loss[dt] = float(m["loss"])
            assert np.isfinite(loss[dt]) and np.isfinite(float(
                m["grad_norm"]))
        cpu = pytree.tree_map(lambda t: t.cpu(), params)
        _, _, cm = make_train_step(partial(tf.loss_fn, cfg=cfg), opt_cfg,
                                   num_microbatches=2)(
            cpu, adamw_init(cpu, opt_cfg),
            {k: v.cpu() for k, v in batch.items()})
        assert abs(loss["float32"] - float(cm["loss"])) <= 1e-5 * abs(
            float(cm["loss"]))
        assert abs(loss["bfloat16"] - loss["float32"]) <= 5e-2 * abs(
            loss["float32"])


ADAMW_HYPER = dict(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
ADAMW_COMBOS = {
    "f32": (torch.float32, torch.float32, torch.float32),
    "f32_bf16": (torch.float32, torch.float32, torch.bfloat16),
    "f64_g32": (torch.float64, torch.float32, torch.float32),
    "f64": (torch.float64, torch.float64, torch.float32),
    "f64_bf16": (torch.float64, torch.float64, torch.bfloat16)}


@pytest.mark.gpu
class TestAdamWOnCard:
    """The AdamW update kernel bitwise its plain version on the card (the
    same eager ops on CUDA tensors) for every dtype combination it takes,
    in place and out of place, at odd lengths and on views one element
    off the 16-byte boundary; the sum-of-squares kernel within 1e-6 of a
    float64 sum and bitwise from call to call."""

    @staticmethod
    def _leaf(cuda, n: int, combo: str, offset: int, seed: int):
        pd, gd, md = ADAMW_COMBOS[combo]
        rng = np.random.default_rng(seed)

        def make(dtype, scale, positive=False):
            x = rng.standard_normal(n + offset) * scale
            x = np.abs(x) if positive else x
            return torch.from_numpy(x).to(dtype).to(cuda)[offset:]
        return (make(pd, 1.0), make(gd, 3.0), make(md, 0.1),
                make(md, 0.01, positive=True))

    @staticmethod
    def _scalars(cuda, scale_dtype=torch.float32):
        stepf = torch.tensor(3.0, device=cuda)
        return (torch.tensor(0.37, dtype=scale_dtype, device=cuda),
                1.0 - torch.pow(torch.tensor(0.9, device=cuda), stepf),
                1.0 - torch.pow(torch.tensor(0.95, device=cuda), stepf))

    @pytest.mark.parametrize("combo", list(ADAMW_COMBOS))
    @pytest.mark.parametrize("n,offset", [(1, 0), (3, 0), (1001, 0),
                                          (4096, 0), (4099, 1),
                                          (1 << 20, 1), (1 << 20, 0)])
    @pytest.mark.parametrize("in_place", [False, True])
    def test_adamw_step_bitwise_vs_plain(self, cuda, combo, n, offset,
                                         in_place):
        p, g, m, v = self._leaf(cuda, n, combo, offset, seed=n + offset)
        scale, bc1, bc2 = self._scalars(
            cuda, torch.float64 if combo == "f64" else torch.float32)
        want = adamw_step_ref(p, g, m, v, scale, bc1, bc2, **ADAMW_HYPER)
        before = adamw_ops.step_launches()
        got = adamw_step(p, g, m, v, scale, bc1, bc2, in_place=in_place,
                         **ADAMW_HYPER)
        torch.cuda.synchronize()
        assert adamw_ops.step_launches() == before + 1
        assert (got[0] is p) == in_place
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)

    def test_adamw_step_unsupported_dtype_raises(self, cuda):
        p, g, m, v = self._leaf(cuda, 8, "f32", 0, seed=1)
        scale, bc1, bc2 = self._scalars(cuda)
        with pytest.raises(TypeError):
            adamw_step(p.half(), g.half(), m, v, scale, bc1, bc2,
                       **ADAMW_HYPER)
        with pytest.raises(TypeError):
            adamw_step(p, g, m, v.bfloat16(), scale, bc1, bc2,
                       **ADAMW_HYPER)

    def test_non_contiguous_gradient_copied_and_counted(self, cuda):
        p, g, m, v = self._leaf(cuda, 64, "f32", 0, seed=2)
        scale, bc1, bc2 = self._scalars(cuda)
        gt = g.reshape(8, 8).t().contiguous().t()
        adamw_ops.reset_launches()
        got = adamw_step(p.reshape(8, 8), gt, m.reshape(8, 8),
                         v.reshape(8, 8), scale, bc1, bc2, **ADAMW_HYPER)
        want = adamw_step_ref(p.reshape(8, 8), gt, m.reshape(8, 8),
                              v.reshape(8, 8), scale, bc1, bc2,
                              **ADAMW_HYPER)
        assert adamw_ops.contiguous_copies() == 1
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        with pytest.raises(ValueError):
            adamw_step(p.reshape(8, 8).t(), gt, m.reshape(8, 8),
                       v.reshape(8, 8), scale, bc1, bc2, **ADAMW_HYPER)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    @pytest.mark.parametrize("n,offset", [(1, 0), (7, 1), (16_385, 0),
                                          (3_000_001, 1),
                                          (40_000_000, 0)])
    def test_sum_squares_vs_float64_and_deterministic(self, cuda, dtype, n,
                                                      offset):
        gen = torch.Generator(device=cuda).manual_seed(n)
        x = torch.randn(n + offset, device=cuda, generator=gen,
                        dtype=dtype)[offset:]
        before = adamw_ops.norm_launches()
        a, b = sum_squares(x), sum_squares(x)
        torch.cuda.synchronize()
        assert adamw_ops.norm_launches() == before + 2
        assert a.dtype == dtype and a.shape == ()
        assert torch.equal(a, b)
        want = float(x.double().square().sum())
        assert abs(float(a) - want) <= 1e-6 * want

    def test_adamw_update_launches_once_per_leaf(self, cuda):
        from repro_torch.train.optimizer import (AdamWConfig, adamw_init,
                                                 adamw_update)
        params = {"w": torch.randn(33, 7, device=cuda),
                  "b": [torch.randn(5, device=cuda),
                        torch.randn(2, 3, 4, device=cuda)]}
        cfg = AdamWConfig()
        state = adamw_init(params, cfg)
        grads = {"w": torch.randn(33, 7, device=cuda),
                 "b": [torch.randn(5, device=cuda),
                       torch.randn(2, 3, 4, device=cuda)]}
        adamw_ops.reset_launches()
        new, _, m = adamw_update(grads, state, params, cfg)
        torch.cuda.synchronize()
        assert adamw_ops.step_launches() == adamw_ops.norm_launches() == 3
        assert adamw_ops.contiguous_copies() == 0
        want = float(torch.sqrt(sum(g.double().square().sum() for g in
                                    [grads["w"], *grads["b"]])))
        assert abs(float(m["grad_norm"]) - want) <= 1e-6 * want


@pytest.mark.gpu
class TestMoeA2AOnCard:
    """The all-to-all MoE at NCCL world size 1 on a (1, 1) ("data",
    "model") mesh, at smoke granite's widths: against the dense path at
    capacity factor 8 (nothing drops; loss rtol 1e-5, gradients rtol 1e-4
    / atol 1e-6), and a second call bitwise equal."""

    def _run(self, cuda, monkeypatch):
        import dataclasses
        import torch.distributed as dist
        from torch.utils import _pytree as pytree
        from repro_torch.configs import granite_moe_3b
        from repro_torch.core.distributed import (collective_counts,
                                                  init_mesh,
                                                  reset_collective_counts)
        from repro_torch.distributed import use_mesh
        from repro_torch.models import transformer as tf
        monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        cfg = granite_moe_3b.smoke_config()
        moe = dataclasses.replace(cfg.moe, capacity_factor=8.0)
        cfgs = {"dense": dataclasses.replace(cfg, moe=moe),
                "a2a": dataclasses.replace(cfg, moe=dataclasses.replace(
                    moe, impl="a2a"))}
        mesh = init_mesh((1, 1), ("data", "model"), cuda)
        assert "nccl" in str(dist.get_backend(mesh.get_group("model")))
        gen = torch.Generator(device=cuda).manual_seed(0)
        params = tf.init_params(gen, cfg)
        tokens = torch.randint(0, cfg.vocab, (2, 33), generator=gen,
                               device=cuda)
        leaves, spec = pytree.tree_flatten(params)

        def run(kind):
            xs = [p.detach().requires_grad_(True) for p in leaves]
            reset_collective_counts()
            with use_mesh(mesh if kind == "a2a" else None):
                loss = tf.loss_fn(pytree.tree_unflatten(xs, spec),
                                  {"tokens": tokens}, cfgs[kind])
                grads = torch.autograd.grad(loss, xs)
            trips = collective_counts()
            return loss.detach(), grads, trips
        return run, cfg.n_layers

    def test_a2a_matches_dense_on_card(self, cuda, monkeypatch):
        run, n_layers = self._run(cuda, monkeypatch)
        la, ga, trips = run("a2a")
        ld, gd, none = run("dense")
        assert none == {}
        assert trips["moe/dispatch/all_to_all/model"]["calls"] \
            == 2 * 3 * n_layers
        assert trips["moe/return_grad/all_to_all/model"]["calls"] == n_layers
        torch.testing.assert_close(la, ld, rtol=1e-5, atol=1e-6)
        for a, b in zip(ga, gd):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)

    def test_a2a_second_call_bitwise(self, cuda, monkeypatch):
        run, _ = self._run(cuda, monkeypatch)
        torch.use_deterministic_algorithms(True)
        try:
            l1, g1, _ = run("a2a")
            l2, g2, _ = run("a2a")
        finally:
            torch.use_deterministic_algorithms(False)
        assert torch.equal(l1, l2)
        assert all(torch.equal(a, b) for a, b in zip(g1, g2))


@pytest.mark.gpu
class TestDryRunOnCard:
    """launch/dryrun.py's card mesh on the card (full width)."""

    def test_dlrm_serve_p99_runs_through_embedding_bag(self, cuda):
        from repro_torch.launch import dryrun
        rec = dryrun.run_cell("dlrm-rm2", "serve_p99", mesh="card",
                              verbose=False)
        assert rec["status"] == "ok" and rec["mesh"] == "card"
        assert rec["launches"]["embedding_bag"] > 0
        assert rec["kernels"]["embedding_bag"]["bytes"] > 0
        assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes_accessed"] > 0
        assert rec["memory"]["peak_per_device"] >= \
            rec["memory"]["argument_bytes"]
        step_s = rec["step_ms"]["median"] * 1e-3
        rf = rec["roofline"]
        assert max(rf["compute_s"], rf["memory_s"], rf["collective_s"]) \
            <= 1.05 * step_s
        assert "," in rec["device"]          # nvidia-smi's name, limit

    def test_matmul_plan_counts_exactly_on_card(self, cuda):
        from repro_torch.configs.base import DryRunPlan, meta
        from repro_torch.launch import dryrun
        m, k, n = 512, 256, 128

        def make_args(seed=0, device=None):
            gen = torch.Generator(device=device).manual_seed(seed)
            return (torch.randn(m, k, generator=gen, device=device),
                    torch.randn(k, n, generator=gen, device=device))
        plan = DryRunPlan(step=torch.matmul,
                          abstract_args=(meta((m, k), torch.float32),
                                         meta((k, n), torch.float32)),
                          in_specs=(None, None),
                          static={"make_args": make_args,
                                  "compute_dtype": "float32"})
        rec = dryrun.run_plan(plan, {"arch": "mm"}, verbose=False)
        assert rec["cost"]["flops"] == 2 * m * n * k
        assert rec["cost"]["bytes_accessed"] == (m * k + k * n + m * n) * 4


@pytest.mark.gpu
class TestAnalysisOnCard:
    """The runtime tier on the card: the compile log of a CUDA graph
    capture and of an nvcc build, RetraceGate quiet over replayed ticks and
    tripping on a fresh engine's capture, the sync debug mode reporting a
    deliberate `.item()`, and the NaN mode's device-side flags."""

    def _engine(self, cuda, max_batch):
        from repro_torch.configs import h2o_danube_1_8b
        from repro_torch.models import transformer as tf
        from repro_torch.serve.engine import Request, ServeEngine
        cfg = h2o_danube_1_8b.smoke_config()
        params = tf.init_params(torch.Generator(device=cuda).manual_seed(0),
                                cfg)
        eng = ServeEngine(params, cfg, max_batch=max_batch, max_len=32,
                          device=cuda)
        for i in range(max_batch):
            assert eng.submit(Request(rid=i, prompt=np.arange(
                3 + i, dtype=np.int32), max_new_tokens=8))
        return cfg, eng

    def test_capture_logged_once(self, cuda):
        from repro_torch.compile_log import compile_log
        cfg, eng = self._engine(cuda, 4)
        mark = len(compile_log())
        for _ in range(4):
            eng.tick()
        assert compile_log()[mark:] == [
            (f"ServeEngine._decode_core {cfg.name}",
             "[4, 1] torch.int64; [4] torch.int32")]

    def test_gate_quiet_on_replays_and_trips_on_a_fresh_capture(self, cuda):
        from repro_torch.analysis.retrace import RetraceError, RetraceGate
        _, eng = self._engine(cuda, 4)
        eng.tick()                                  # captures
        with RetraceGate() as gate:
            for _ in range(3):
                eng.tick()
        assert gate.events == []
        _, fresh = self._engine(cuda, 3)
        with pytest.raises(RetraceError) as ei:
            with RetraceGate():
                fresh.tick()
        msg = str(ei.value)
        assert "ServeEngine._decode_core" in msg and "NEW signature" in msg

    def test_nvcc_build_logged(self, cuda, tmp_path, monkeypatch):
        from repro_torch.analysis.retrace import RetraceError, RetraceGate
        from repro_torch.kernels import _build
        monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
        monkeypatch.delitem(_build._LIBS, "cheb_step", raising=False)
        with pytest.raises(RetraceError, match="cheb_step: build"):
            with RetraceGate():
                _build.build_all(["cheb_step"])
        assert list(tmp_path.glob("cheb_step-*.so"))

    def test_sync_debug_mode_reports_item(self, cuda):
        import warnings
        from repro_torch.analysis import sanitize
        x = torch.ones(8, device=cuda)

        def syncs(seen):
            return [w for w in seen if "called a synchronizing CUDA "
                    "operation" in str(w.message)]
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            with sanitize.applied({"sync_debug_mode": "warn"}):
                y = x * 2                           # no sync
                quiet = len(syncs(seen))
                y.sum().item()                      # a sync
        assert quiet == 0 and len(syncs(seen)) == 1
        assert torch.cuda.get_sync_debug_mode() == 0

    @pytest.mark.parametrize("adaptive", [False, True])
    def test_warm_tick_synchronizes_only_where_marked(self, cuda, adaptive):
        """A warm tick (sync dispatch) synchronizes at `_harvest`'s event
        (explicit, not reported) and, adaptive, at the loop's per-chunk
        read (the line TL001's marker covers); nothing else."""
        import warnings
        from repro_torch.analysis import sanitize
        from repro_torch.serve import (GraphRegistry, PageRankService,
                                       PPRQuery)
        reg = GraphRegistry(device=cuda)
        reg.register("g", generators.tri_mesh(40, 50))
        svc = PageRankService(reg, max_batch=8, adaptive=adaptive)
        svc.query("g", seeds=(0,), top_k=5)
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            with sanitize.applied({"sync_debug_mode": "warn"}):
                for i in range(3):
                    svc.submit(PPRQuery(qid=i, graph="g", seeds=(i + 1,),
                                        top_k=5))
                out = svc.run_until_drained()
        assert len(out) == 3
        sites = {(w.filename.rsplit("/", 1)[-1], w.lineno) for w in seen
                 if "called a synchronizing CUDA operation" in
                 str(w.message)}
        if not adaptive:
            assert sites == set()
        else:
            src = open(tpr_file()).read().splitlines()
            assert sites and all(
                f == "pagerank.py" and "bool(active.any())" in src[n - 1]
                for f, n in sites), sites

    def test_nan_mode_flags_on_the_card(self, cuda):
        from repro_torch.analysis import sanitize
        with sanitize.applied({"debug_nans": True}) as ctx:
            y = torch.ones(4, device=cuda) / 2
        assert len(ctx.nan_mode.names) >= 1 and float(y.sum()) == 2.0
        with pytest.raises(FloatingPointError, match="aten.div"):
            with sanitize.applied({"debug_nans": True}):
                torch.zeros(4, device=cuda) / torch.zeros(4, device=cuda)


@pytest.mark.gpu
class TestWindowKernelsOnCard:
    """The window variants of the embedding_bag kernels (one rank's row
    shard of the table): the lookup bitwise against its plain version at
    bag size 1 (and within 1e-5 at larger bags), the backward within 1e-5
    of the sum of |terms| of a float64 plain window version and bitwise
    from run to run, an id outside the window adding nothing and writing
    nothing; the backward's index preparation (compaction and radix sort)
    bitwise against its plain version, and no host read on its path; the
    whole-table entry points are the window [0, V), and the whole-table
    backward keeps its bits."""

    @staticmethod
    def _case(cuda, rows: int, n_bags: int, bag: int, dim: int, seed: int):
        rng = np.random.default_rng(seed)
        table = torch.from_numpy(rng.standard_normal((rows, dim)).astype(
            np.float32)).to(cuda)
        ids = torch.from_numpy((rows * rng.random((n_bags, bag)) ** 2)
                               .astype(np.int32)).to(cuda)
        g = torch.from_numpy(rng.standard_normal((n_bags, dim)).astype(
            np.float32)).to(cuda)
        return table, ids, g

    @pytest.mark.parametrize("row_lo,n_local", [(0, 300), (300, 300),
                                                (900, 100), (0, 1000),
                                                (950, 64)])
    @pytest.mark.parametrize("bag", [1, 3])
    def test_lookup_window_vs_plain(self, cuda, row_lo, n_local, bag):
        from repro_torch.kernels.embedding_bag.ops import \
            embedding_bag_window
        from repro_torch.kernels.embedding_bag.ref import \
            embedding_bag_window_ref
        table, ids, _ = self._case(cuda, 1000, 5000, bag, 64, bag + row_lo)
        local = torch.zeros((n_local, 64), device=cuda)
        real = table[row_lo:row_lo + n_local]
        local[:real.shape[0]] = real
        before = eb_ops.window_launches()
        got = embedding_bag_window(ids, local, row_lo)
        torch.cuda.synchronize()
        assert eb_ops.window_launches() == before + 1
        want = embedding_bag_window_ref(ids, local, row_lo)
        if bag == 1:
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        outside = ((ids < row_lo) | (ids >= row_lo + n_local)).all(1)
        assert not got[outside].any()

    @pytest.mark.parametrize("row_lo,n_local", [(0, 300), (300, 300),
                                                (900, 100), (0, 1000)])
    @pytest.mark.parametrize("n_bags,bag", [(5000, 1), (70_000, 1),
                                            (3000, 4)])
    def test_backward_window_vs_plain(self, cuda, row_lo, n_local, n_bags,
                                      bag):
        from repro_torch.kernels.embedding_bag.ops import \
            embedding_bag_backward_window
        from repro_torch.kernels.embedding_bag.ref import \
            embedding_bag_backward_window_ref
        _, ids, g = self._case(cuda, 1000, n_bags, bag, 64, n_bags + row_lo)
        before = eb_ops.window_backward_launches()
        got = embedding_bag_backward_window(ids, g, row_lo, n_local)
        again = embedding_bag_backward_window(ids, g, row_lo, n_local)
        torch.cuda.synchronize()
        assert eb_ops.window_backward_launches() == before + 2
        assert torch.equal(got, again)
        want = embedding_bag_backward_window_ref(ids, g.double(), row_lo,
                                                 n_local)
        mag = embedding_bag_backward_window_ref(ids, g.double().abs(),
                                                row_lo, n_local)
        err = (got.double() - want).abs()
        assert bool((err <= 1e-5 * mag + 1e-30).all())
        read = torch.zeros(n_local, dtype=torch.bool, device=cuda)
        inside = ids[(ids >= row_lo) & (ids < row_lo + n_local)]
        read[(inside - row_lo).long()] = True
        assert not got[~read].any()

    @pytest.mark.parametrize("row_lo,n_local", [(0, 300), (300, 300),
                                                (900, 100), (0, 1000),
                                                (2000, 100), (0, 1 << 26)])
    @pytest.mark.parametrize("n_bags,bag", [(5000, 1), (70_000, 1),
                                            (3000, 4)])
    def test_window_sort_vs_plain(self, cuda, row_lo, n_local, n_bags, bag):
        """The compaction and radix sort bitwise against the plain
        preparation: windows of 1 to 4 digit passes, one no id lies in
        (n_in = 0), 3 to 35 tiles."""
        from repro_torch.kernels.embedding_bag.ops import window_sort
        from repro_torch.kernels.embedding_bag.ref import window_sort_ref
        _, ids, _ = self._case(cuda, 1000, n_bags, bag, 64, n_bags + row_lo)
        before = eb_ops.window_sort_launches()
        keys, vals, n_in = window_sort(ids, row_lo, n_local)
        torch.cuda.synchronize()
        assert eb_ops.window_sort_launches() == before + 1
        want_keys, want_vals, want_n = window_sort_ref(ids, row_lo, n_local)
        n = int(want_n)
        assert int(n_in) == n and keys.shape == vals.shape == (ids.numel(),)
        assert torch.equal(keys[:n], want_keys)
        assert torch.equal(vals[:n], want_vals)

    def test_window_sort_at_train_batch_size(self, cuda):
        """1,703,936 uniform ids over 2^25 rows, a window of 2^24 of them
        from 2^23 (3 digit passes over ~half of the ids, 832 tiles of
        look-back), bitwise against the plain preparation."""
        from repro_torch.kernels.embedding_bag.ops import window_sort
        from repro_torch.kernels.embedding_bag.ref import window_sort_ref
        rng = np.random.default_rng(17)
        ids = torch.from_numpy(rng.integers(0, 1 << 25, (65_536 * 26, 1))
                               .astype(np.int32)).to(cuda)
        keys, vals, n_in = window_sort(ids, 1 << 23, 1 << 24)
        want_keys, want_vals, want_n = window_sort_ref(ids, 1 << 23,
                                                       1 << 24)
        n = int(want_n)
        assert int(n_in) == n and 0.4 * ids.numel() < n < 0.6 * ids.numel()
        assert torch.equal(keys[:n], want_keys)
        assert torch.equal(vals[:n], want_vals)

    @pytest.mark.parametrize("dim,weighted,power", [(8, False, 1.0),
                                                    (3, True, 3.0)])
    def test_window_chunks_of_several_tiles(self, cuda, dim, weighted,
                                            power):
        """8,840,000 entries all inside [0, 1000): chunks of 2,093 entries,
        more than one block stages at once, so pieces run on from tile to
        tile (every row has ~8,840 entries); bitwise the whole-table
        kernel."""
        from repro_torch.kernels.embedding_bag.ops import (
            embedding_bag_backward, embedding_bag_backward_window)
        assert eb_ops.backward_plan(340_000 * 26)[0] > 8 * eb_ops.TILE
        rng = np.random.default_rng(dim)
        ids = (1000 * rng.random((340_000, 26)) ** power).astype(np.int32)
        ids, g, w = TestTrainingOnCard._case(cuda, ids, dim, weighted, rng)
        got = embedding_bag_backward_window(ids, g, 0, 1000, w)
        assert torch.equal(got, embedding_bag_backward(ids, g, 1000, w))

    def test_backward_window_a_warp_to_a_chunk(self, cuda):
        """300,000 ids: a plan of more than 528 chunks, so the window's
        pieces pass gives each chunk one warp (fewer, a block); held as the
        block's path is, and bitwise the whole-table kernel on [0, V)."""
        from repro_torch.kernels.embedding_bag.ops import (
            embedding_bag_backward, embedding_bag_backward_window)
        from repro_torch.kernels.embedding_bag.ref import \
            embedding_bag_backward_window_ref
        _, ids, g = self._case(cuda, 1000, 300_000, 1, 64, 21)
        assert -(-ids.numel() // eb_ops.TILE) > 132 * 4
        got = embedding_bag_backward_window(ids, g, 300, 300)
        assert torch.equal(got, embedding_bag_backward_window(ids, g, 300,
                                                              300))
        want = embedding_bag_backward_window_ref(ids, g.double(), 300, 300)
        mag = embedding_bag_backward_window_ref(ids, g.double().abs(), 300,
                                                300)
        assert bool(((got.double() - want).abs() <= 1e-5 * mag
                     + 1e-30).all())
        assert torch.equal(embedding_bag_backward_window(ids, g, 0, 1000),
                           embedding_bag_backward(ids, g, 1000))

    def test_backward_window_with_no_id_inside(self, cuda):
        from repro_torch.kernels.embedding_bag.ops import \
            embedding_bag_backward_window
        _, ids, g = self._case(cuda, 1000, 5000, 2, 64, 11)
        before = eb_ops.window_backward_launches()
        got = embedding_bag_backward_window(ids, g, 5000, 200)
        torch.cuda.synchronize()
        assert eb_ops.window_backward_launches() == before + 1
        assert got.shape == (200, 64) and not got.any()

    def test_backward_window_reads_nothing_back(self, cuda):
        """The window backward, alone and as the window lookup's autograd
        backward, under the sync debug mode "error": no host read."""
        from repro_torch.kernels.embedding_bag.ops import (
            embedding_bag_backward_window, embedding_bag_window)
        table, ids, g = self._case(cuda, 1000, 20_000, 1, 64, 13)
        local = table[300:600].clone().requires_grad_(True)
        want = embedding_bag_backward_window(ids, g, 300, 300)   # warm
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = embedding_bag_backward_window(ids, g, 300, 300)
            (embedding_bag_window(ids, local, 300) * g).sum().backward()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert torch.equal(got, want) and torch.equal(local.grad, want)

    def test_whole_table_backward_bits_unchanged(self, cuda):
        """The whole-table kernel gives the bits it gave before the window
        backward's redesign: the digest of its touched rows on
        WHOLE_TABLE_CASE, saved from the earlier source."""
        from repro_torch.kernels.embedding_bag.ops import \
            embedding_bag_backward
        fixture = json.loads((Path(__file__).parent / "fixtures" /
                              "eb_backward_whole_table.json").read_text())
        spec, ids, g = whole_table_case(cuda)
        assert {k: fixture[k] for k in spec} == spec
        got = embedding_bag_backward(ids, g, spec["rows"])
        assert touched_digest(got, ids) == fixture["sha256"]

    def test_whole_table_is_the_window_from_zero(self, cuda):
        from repro_torch.kernels.embedding_bag.ops import (
            embedding_bag_backward, embedding_bag_backward_window,
            embedding_bag_window)
        table, ids, g = self._case(cuda, 1000, 20_000, 1, 64, 5)
        assert torch.equal(embedding_bag(ids, table),
                           embedding_bag_window(ids, table, 0))
        assert torch.equal(embedding_bag(ids, table),
                           table[ids[:, 0].long()])
        assert torch.equal(embedding_bag_backward(ids, g, 1000),
                           embedding_bag_backward_window(ids, g, 0, 1000))

    def test_fake_world_runs_cuda_tensors(self, cuda):
        """One rank of the production mesh on the card: the fake backend
        takes CUDA tensors and moves nothing."""
        from repro_torch.core import distributed as cdist
        from repro_torch.launch import mesh as launch_mesh
        mesh = launch_mesh.make_production_mesh(device="cuda", fake=True,
                                                rank=255)
        try:
            assert tuple(mesh.mesh.shape) == (16, 16)
            assert tuple(mesh.get_coordinate()) == (15, 15)
            x = torch.arange(4.0, device=cuda)
            out = cdist.all_gather(x, mesh.get_group("model"))
            assert out.shape == (64,) and out.is_cuda
        finally:
            cdist.destroy_world()
