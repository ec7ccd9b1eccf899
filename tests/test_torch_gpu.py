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

    @pytest.mark.parametrize("bt", [1, 3, 8, 32, 100, 128])
    def test_bsr_spmm_kernel_vs_plain(self, cuda, bt):
        be = _tiles(128, seed=bt)
        bc = torch.from_numpy(be.block_cols).to(cuda)
        v = torch.from_numpy(be.values).to(cuda)
        x = torch.from_numpy(np.random.default_rng(bt).standard_normal(
            (be.n, bt)).astype(np.float32)).to(cuda)
        before = bsr_ops.launches()
        y = bsr_spmm(bc, v, x)
        torch.cuda.synchronize()
        assert bsr_ops.launches() == before + 1
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
