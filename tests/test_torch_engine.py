"""Port's graph builders and engines vs the reference (`repro`).

Host builders must be byte-identical (same BFS perm, block_cols, values,
edge weights), so the kernels see identical tiles in both packages. Engine
`apply`/`cheb_round` results on O(1) random inputs are held elementwise to
rtol/atol 1e-5, the reference's own kernel-vs-oracle bound
(tests/test_kernels.py): both sides sum in f32, in different orders.
Normalized PageRank vectors are held to L1 <= 1e-5. The reference's block
engines run their Pallas kernels in interpret mode; the port's take the
plain versions on the CPU.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import engine as jeng
from repro.graph import generators as jgen
from repro.graph import ops as jops
from repro.graph import structure as jstruct

from repro_torch import interop
from repro_torch.core import engine as teng
from repro_torch.graph import generators, ops, structure

GRAPHS = {
    "mesh": lambda gen: gen.tri_mesh(30, 40),
    "jitter_mesh": lambda gen: gen.tri_mesh(20, 25, diagonal_jitter=0.5,
                                            seed=3),
    "caveman": lambda gen: gen.caveman(40, 8),
    "kmer": lambda gen: gen.kmer_chains(3000, seed=1),
    "powerlaw": lambda gen: gen.powerlaw_ba(1500, seed=2),
}


def _pair(name):
    return GRAPHS[name](jgen), GRAPHS[name](generators)


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5,
                               atol=1e-5)


def _l1(a, b):
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).sum())


class TestHostBuilders:
    @pytest.mark.parametrize("name", sorted(GRAPHS))
    def test_generators_identical(self, name):
        gj, gt = _pair(name)
        assert gj.n == gt.n
        assert gj.src.tobytes() == gt.src.tobytes()
        assert gj.dst.tobytes() == gt.dst.tobytes()

    @pytest.mark.parametrize("name", ["mesh", "caveman", "kmer"])
    def test_reorder_bfs_identical(self, name):
        gj, gt = _pair(name)
        assert jstruct.reorder_bfs(gj).tobytes() == \
            structure.reorder_bfs(gt).tobytes()

    @pytest.mark.parametrize("name", ["mesh", "caveman", "kmer"])
    @pytest.mark.parametrize("block", [32, 128])
    def test_build_block_ell_identical(self, name, block):
        gj, gt = _pair(name)
        bj = jstruct.build_block_ell(gj, block=block)
        bt = structure.build_block_ell(gt, block=block)
        assert (bj.n, bj.n_orig, bj.block) == (bt.n, bt.n_orig, bt.block)
        assert bj.perm.tobytes() == bt.perm.tobytes()
        assert bj.block_cols.tobytes() == bt.block_cols.tobytes()
        assert bj.values.tobytes() == bt.values.tobytes()
        assert bj.fill_rate == bt.fill_rate

    @pytest.mark.parametrize("name", ["mesh", "caveman", "kmer"])
    def test_block_fill_rate_identical(self, name):
        gj, gt = _pair(name)
        fj, pj = jstruct.block_fill_rate(gj)
        ft, pt = structure.block_fill_rate(gt)
        assert fj == ft and pj.tobytes() == pt.tobytes()

    def test_paper_dataset_table(self):
        assert sorted(generators.PAPER_DATASETS) == \
            sorted(jgen.PAPER_DATASETS)
        g = generators.paper_dataset("NACA0015", 0.2)
        assert g.n == jgen.paper_dataset("NACA0015", 0.2).n

    @pytest.mark.parametrize("pad", [None, 4096])
    def test_device_graph_identical(self, pad):
        gj, gt = _pair("kmer")
        dj = jops.device_graph(gj, pad_edges_to=pad)
        dt = ops.device_graph(gt, pad_edges_to=pad, device="cpu")
        for attr in ("src", "dst", "w", "inv_deg"):
            a = np.asarray(getattr(dj, attr))
            b = getattr(dt, attr).numpy()
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), attr

    def test_bf16_weights_upcast(self):
        """Packed weights: the same bf16 roundings of the exact 1/deg as the
        reference, upcast before the multiply (f32 output), so a solve over
        them agrees with the reference's at the f32 bound (L1 <= 1e-5)."""
        from repro.core.pagerank import cpaa as j_cpaa
        from repro_torch.core.pagerank import cpaa
        gj, gt = _pair("mesh")
        dj = jops.device_graph(gj, weight_dtype=jnp.bfloat16)
        d16 = ops.device_graph(gt, device="cpu", weight_dtype="bfloat16")
        assert d16.w.dtype == torch.bfloat16
        assert np.array_equal(np.asarray(dj.w, np.float32),
                              d16.w.float().numpy())
        pi16 = cpaa(d16, tol=1e-6).pi
        assert pi16.dtype == torch.float32
        assert _l1(j_cpaa(dj, tol=1e-6).pi, pi16.numpy()) <= 1e-5

    def test_check_int32_range(self):
        with pytest.raises(ValueError, match="int32"):
            ops.check_int32_range(2 ** 31, 1)
        with pytest.raises(ValueError, match="nnz"):
            ops.check_int32_range(10, 2 ** 31)


def _ref_block_engine(g, fused, pad=False):
    cls = jeng.FusedBlockEllEngine if fused else jeng.BlockEllEngine
    return cls.from_graph(g, use_kernel=True, interpret=True,
                          pad_slots_to_pow2=pad)


class TestEngines:
    @pytest.mark.parametrize("ndim", [1, 2])
    @pytest.mark.parametrize("name", ["mesh", "kmer", "powerlaw"])
    def test_coo_apply_and_round(self, name, ndim):
        gj, gt = _pair(name)
        ej = jeng.CooEngine(jops.device_graph(gj, pad_edges_to=gj.m + 100))
        et = teng.CooEngine(ops.device_graph(gt, pad_edges_to=gt.m + 100,
                                             device="cpu"))
        rng = np.random.default_rng(ndim)
        shape = (gt.n,) if ndim == 1 else (gt.n, 5)
        x, t, acc = (rng.random(shape).astype(np.float32) for _ in range(3))
        yj = np.asarray(ej.apply(jnp.asarray(x)))
        yt = et.apply(torch.from_numpy(x))
        _close(yj, yt.numpy())
        tj, aj = ej.cheb_round(jnp.asarray(yj), jnp.asarray(t),
                               jnp.asarray(acc), jnp.float32(0.3))
        tt, at = et.cheb_round(torch.from_numpy(yj.copy()), torch.from_numpy(t),
                               torch.from_numpy(acc), torch.tensor(0.3))
        _close(tj, tt.numpy())
        _close(aj, at.numpy())

    @pytest.mark.parametrize("fused", [False, True])
    @pytest.mark.parametrize("ndim", [1, 2])
    def test_block_engines_vs_pallas(self, fused, ndim):
        gj, gt = _pair("mesh")
        ej = _ref_block_engine(gj, fused)
        et = (teng.FusedBlockEllEngine if fused else teng.BlockEllEngine
              ).from_graph(gt, device="cpu")
        assert et.name == ej.name and et.n_pad == ej.n_pad
        rng = np.random.default_rng(10 + ndim)
        shape = (gt.n,) if ndim == 1 else (gt.n, 8)
        p = rng.random(shape).astype(np.float32)
        xj, xt = ej.to_internal(jnp.asarray(p)), et.to_internal(
            torch.from_numpy(p))
        assert np.asarray(xj).tobytes() == xt.numpy().tobytes()
        yj, yt = ej.apply(xj), et.apply(xt)
        _close(yj, yt.numpy())
        t = rng.random(xt.shape).astype(np.float32)
        acc = rng.random(xt.shape).astype(np.float32)
        tj, aj = ej.cheb_round(yj, jnp.asarray(t), jnp.asarray(acc),
                               jnp.float32(0.7))
        tt, at = et.cheb_round(torch.from_numpy(np.array(yj)),
                               torch.from_numpy(t), torch.from_numpy(acc),
                               torch.tensor(0.7))
        _close(tj, tt.numpy())
        _close(aj, at.numpy())
        back_j = np.asarray(ej.from_internal(yj))
        back_t = et.from_internal(torch.from_numpy(np.array(yj))).numpy()
        assert back_j.tobytes() == back_t.tobytes()

    def test_engine_carried_across_by_interop(self):
        """The reference engine's own leaves, run through the port."""
        gj, _ = _pair("caveman")
        ej = _ref_block_engine(gj, fused=True, pad=True)
        et = interop.block_ell_engine(
            np.array(ej.block_cols), np.array(ej.values),
            np.array(ej.perm), np.array(ej.inv_perm), ej.n_orig,
            ej.block, fused=True, device="cpu")
        x = np.random.default_rng(5).random((ej.n_orig, 4)).astype(np.float32)
        yj = ej.from_internal(ej.apply(ej.to_internal(jnp.asarray(x))))
        yt = et.from_internal(et.apply(et.to_internal(torch.from_numpy(x))))
        _close(yj, yt.numpy())
        dj = jops.device_graph(gj)
        ec = interop.coo_engine(np.array(dj.src), np.array(dj.dst),
                                np.array(dj.w), np.array(dj.inv_deg),
                                dj.n, device="cpu")
        _close(jeng.CooEngine(dj).apply(jnp.asarray(x)),
               ec.apply(torch.from_numpy(x)).numpy())

    def test_pad_slots_to_pow2_matches_reference(self):
        gj, gt = _pair("jitter_mesh")
        ej = jeng.BlockEllEngine.from_graph(gj, pad_slots_to_pow2=True)
        et = teng.BlockEllEngine.from_graph(gt, pad_slots_to_pow2=True,
                                            device="cpu")
        assert tuple(et.values.shape) == tuple(ej.values.shape)
        s = et.block_cols.shape[1]
        assert s & (s - 1) == 0
        assert et.block_cols.numpy().tobytes() == \
            np.asarray(ej.block_cols).tobytes()
        assert et.values.numpy().tobytes() == np.asarray(ej.values).tobytes()

    def test_zero_mass_padding_invariant(self):
        _, gt = _pair("mesh")
        et = teng.FusedBlockEllEngine.from_graph(gt, device="cpu")
        assert et.n_pad > et.n
        x = et.to_internal(torch.rand(gt.n, 3))
        assert torch.count_nonzero(x[et.n:]) == 0
        y = et.apply(x)
        t, acc = et.cheb_round(y, x, x, torch.tensor(0.5))
        for a in (y, t, acc):
            assert torch.count_nonzero(a[et.n:]) == 0
        torch.testing.assert_close(y.sum(0), x.sum(0), rtol=1e-5, atol=1e-6)

    def test_use_kernel_false_takes_plain_versions(self):
        _, gt = _pair("mesh")
        et = teng.FusedBlockEllEngine.from_graph(gt, device="cpu")
        plain = et.with_kernels(False)
        assert plain.values is et.values and not plain.use_kernel
        x = et.to_internal(torch.rand(gt.n, 2))
        assert torch.equal(plain.apply(x), et.apply(x))

    def test_apply_counters(self):
        teng.reset_apply_counts()
        _, gt = _pair("mesh")
        et = teng.select_engine(gt, mode="fused", device="cpu")
        ec = teng.select_engine(gt, mode="coo", device="cpu")
        et.apply(et.to_internal(torch.rand(gt.n)))
        ec.apply(torch.rand(gt.n))
        ec.apply(torch.rand(gt.n))
        assert teng.apply_counts() == {"block_ell_fused": 1, "coo": 2}


class TestSelection:
    @pytest.mark.parametrize("name", ["mesh", "kmer", "caveman", "powerlaw"])
    @pytest.mark.parametrize("batch", [None, 4, 128])
    def test_auto_matches_reference_heuristic_on_cpu(self, name, batch):
        gj, gt = _pair(name)
        want = jeng.heuristic_mode(gj, batch)
        assert teng.heuristic_mode(gt, batch, device="cpu") == want
        eng = teng.select_engine(gt, batch, device="cpu")
        assert eng.name == {"coo": "coo", "fused": "block_ell_fused"}[want]

    def test_cuda_uses_the_accelerator_fill_bar(self):
        # mesh fill sits between the cpu bar (0.05) and the cuda one (0.01)
        g = generators.tri_mesh(104, 100)
        fill, _ = structure.block_fill_rate(g)
        assert 0.01 <= fill < 0.05
        assert teng.heuristic_mode(g, 128, device="cpu") == "coo"
        assert teng.heuristic_mode(g, 128, device="cuda") == "fused"

    @pytest.mark.parametrize("mode", ["sharded_1d", "sharded-2d"])
    def test_unported_modes_raise(self, mode):
        # the sharded modes are ported: on one rank (a single-rank gloo
        # group) they build and answer as the reference's COO solve does
        from repro.core.pagerank import cpaa as jcpaa
        from repro_torch.core.pagerank import cpaa as tcpaa
        gj, gt = _pair("mesh")
        eng = teng.select_engine(gt, mode=mode, device="cpu", lane=4)
        assert eng.name == mode.replace("-", "_")
        assert eng.n == gt.n and eng.device.type == "cpu"
        pi = tcpaa(eng, 0.85, 1e-8).pi.numpy()
        ref = np.asarray(jcpaa(jops.device_graph(gj), 0.85, 1e-8).pi)
        assert _l1(pi, ref) <= 1e-5

    def test_auto_hub_tail_pick_raises(self):
        # auto's hub/tail pick now builds the engine: the same split as the
        # reference's, array for array
        n = 1 << 17
        hubs = 10
        leaves = np.arange(hubs, n)
        g = structure.Graph.from_undirected_edges(n, leaves % hubs, leaves)
        gj = jstruct.Graph.from_undirected_edges(n, leaves % hubs, leaves)
        assert teng.heuristic_mode(g, device="cpu") == "hub_tail"
        eng = teng.select_engine(g, device="cpu")
        ref = jeng.select_engine(gj)
        assert isinstance(eng, teng.HubTailEngine)
        assert isinstance(ref, jeng.HubTailEngine)
        for name in ("inv_deg", "tail_src", "tail_dst", "panel_cols",
                     "panel_hub", "hub_ids"):
            np.testing.assert_array_equal(getattr(eng, name).numpy(),
                                          np.asarray(getattr(ref, name)),
                                          err_msg=name)

    def test_unknown_mode(self):
        _, gt = _pair("mesh")
        with pytest.raises(ValueError, match="not in"):
            teng.select_engine(gt, mode="dense", device="cpu")
