"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Every test here is marked `gpu` and skips without a CUDA device (a CUDA
kernel has no CPU mode). This file imports neither jax nor the JAX
package, so it also runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.graph import generators
from repro_torch.graph.structure import build_block_ell
from repro_torch.kernels.bsr_spmm import ops as bsr_ops
from repro_torch.kernels.bsr_spmm.ops import bsr_spmm
from repro_torch.kernels.bsr_spmm.ref import bsr_spmm_ref
from repro_torch.kernels.cheb_step.ops import cheb_step
from repro_torch.kernels.cheb_step.ref import cheb_step_ref
from repro_torch.kernels.embedding_bag import ops as eb_ops
from repro_torch.kernels.embedding_bag.ops import embedding_bag
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref


@pytest.fixture
def cuda():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in f32
    return torch.device("cuda")


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
