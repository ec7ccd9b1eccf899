"""Port's kernel modules vs the reference's Pallas kernels.

On the CPU the port's wrappers take their plain PyTorch versions (a CUDA
kernel has no interpret mode); the reference runs its Pallas kernels in
interpret mode, as tests/test_kernels.py does. The same inputs, made with
numpy from a seed, go through both. The CUDA kernels themselves are held
against the plain versions on the card by tests/test_torch_gpu.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.graph import generators as jgen
from repro.graph.structure import build_block_ell as j_build_block_ell
from repro.kernels.bsr_spmm.ops import bsr_spmm as j_bsr_spmm
from repro.kernels.cheb_step.ops import cheb_step as j_cheb_step
from repro.kernels.embedding_bag.ops import embedding_bag as j_embedding_bag

from repro_torch.graph import generators
from repro_torch.graph.ops import device_graph, spmv
from repro_torch.graph.structure import build_block_ell
from repro_torch.kernels import _build
from repro_torch.kernels.bsr_spmm import ops as bsr_ops
from repro_torch.kernels.bsr_spmm.ops import bsr_spmm
from repro_torch.kernels.cheb_step import ops as cheb_ops
from repro_torch.kernels.cheb_step.ops import cheb_step
from repro_torch.kernels.cheb_step.ref import cheb_step_ref
from repro_torch.kernels.embedding_bag import ops as eb_ops
from repro_torch.kernels.embedding_bag.ops import embedding_bag

REPO = __import__("pathlib").Path(__file__).resolve().parent.parent


def _tiles(block: int, seed: int):
    g = generators.erdos_renyi(max(3 * block, 200), 5.0, seed=seed)
    return build_block_ell(g, block=block)


class TestBsrSpmmParity:
    # 1e-5 rtol/atol, the reference's own bound for its kernel vs its oracle
    # (tests/test_kernels.py): both sides sum in f32, in different orders.
    @pytest.mark.parametrize("block", [8, 32, 128])
    @pytest.mark.parametrize("bt", [1, 8, 128])
    def test_plain_vs_pallas_interpret(self, block, bt):
        be = _tiles(block, seed=block + bt)
        x = np.random.default_rng(block * 1000 + bt).standard_normal(
            (be.n, bt)).astype(np.float32)
        y_ref = np.asarray(j_bsr_spmm(jnp.asarray(be.block_cols),
                                      jnp.asarray(be.values), jnp.asarray(x),
                                      use_kernel=True, interpret=True))
        y = bsr_spmm(torch.from_numpy(be.block_cols),
                     torch.from_numpy(be.values), torch.from_numpy(x))
        assert y.shape == (be.n, bt) and y.dtype == torch.float32
        np.testing.assert_allclose(y.numpy(), y_ref, rtol=1e-5, atol=1e-5)

    def test_vector_input_squeeze(self):
        be = build_block_ell(generators.tri_mesh(8, 9), block=16)
        x = np.random.default_rng(1).standard_normal(be.n).astype(np.float32)
        y_ref = np.asarray(j_bsr_spmm(jnp.asarray(be.block_cols),
                                      jnp.asarray(be.values), jnp.asarray(x),
                                      use_kernel=True, interpret=True))
        y = bsr_spmm(torch.from_numpy(be.block_cols),
                     torch.from_numpy(be.values), torch.from_numpy(x))
        assert y.shape == (be.n,)
        np.testing.assert_allclose(y.numpy(), y_ref, rtol=1e-5, atol=1e-5)

    def test_matches_coo_spmv(self):
        """Block product == index_add_ SpMV on the original graph (2e-4 rtol,
        the reference's bound for the same cross-check: the two formats sum
        each row in different orders)."""
        g = generators.tri_mesh(11, 12)
        be = build_block_ell(g, block=32)
        dg = device_graph(g, device="cpu")
        x = torch.from_numpy(np.random.default_rng(2).standard_normal(
            g.n).astype(np.float32))
        perm = torch.from_numpy(be.perm)
        xp = torch.zeros(be.n)
        xp[:g.n] = x[perm]
        y_blk = bsr_spmm(torch.from_numpy(be.block_cols),
                         torch.from_numpy(be.values), xp)
        y = torch.zeros(g.n)
        y[perm] = y_blk[:g.n]
        np.testing.assert_allclose(y.numpy(), spmv(dg, x).numpy(),
                                   rtol=2e-4, atol=1e-5)

    def test_casts_x_to_float32(self):
        be = _tiles(8, seed=3)
        x = np.random.default_rng(3).standard_normal((be.n, 2))
        y = bsr_spmm(torch.from_numpy(be.block_cols),
                     torch.from_numpy(be.values), torch.from_numpy(x))
        assert y.dtype == torch.float32


class TestBsrSpmmChecks:
    """The CUDA path's input checks (run on CPU tensors here: the checks
    are plain Python and raise before any launch)."""

    def _args(self):
        be = _tiles(128, seed=4)
        return (torch.from_numpy(be.block_cols), torch.from_numpy(be.values),
                torch.zeros(be.n, 4))

    def test_accepts_kernel_inputs(self):
        bsr_ops._check(*self._args())

    def test_rejects_wrong_block(self):
        be = _tiles(32, seed=5)
        with pytest.raises(ValueError, match="values must be"):
            bsr_ops._check(torch.from_numpy(be.block_cols),
                           torch.from_numpy(be.values), torch.zeros(be.n, 1))

    def test_rejects_wrong_dtypes(self):
        bc, v, x = self._args()
        with pytest.raises(TypeError, match="values"):
            bsr_ops._check(bc, v.double(), x)
        with pytest.raises(TypeError, match="block_cols"):
            bsr_ops._check(bc.long(), v, x)

    def test_rejects_bad_shapes_and_layout(self):
        bc, v, x = self._args()
        with pytest.raises(ValueError, match="x must be"):
            bsr_ops._check(bc, v, x[:-1])
        with pytest.raises(ValueError, match="contiguous"):
            bsr_ops._check(bc, v, torch.zeros(4, x.shape[0]).T)
        with pytest.raises(ValueError, match="block_cols"):
            bsr_ops._check(bc[:, :1], v, x)


class TestChebStepParity:
    # t'' = 2y - t is exact in f32 on both sides; acc' rounds one product
    # and one sum, which XLA may contract into an FMA: rtol 1e-6 (the
    # issue's bound) plus atol 1e-7 for entries where acc + ck t'' cancels.
    @pytest.mark.parametrize("n", [64, 1000, 10_001])
    @pytest.mark.parametrize("ndim", [1, 2])
    def test_plain_vs_pallas_interpret(self, n, ndim):
        shape = (n,) if ndim == 1 else (n, 4)
        rng = np.random.default_rng(n + ndim)
        y, t, acc = (rng.standard_normal(shape).astype(np.float32)
                     for _ in range(3))
        ck = np.float32(0.5567)
        tr, ar = j_cheb_step(jnp.asarray(y), jnp.asarray(t), jnp.asarray(acc),
                             ck, use_kernel=True, interpret=True)
        tk, ak = cheb_step(torch.from_numpy(y), torch.from_numpy(t),
                           torch.from_numpy(acc), torch.tensor(ck))
        np.testing.assert_allclose(tk.numpy(), np.asarray(tr), rtol=1e-6)
        np.testing.assert_allclose(ak.numpy(), np.asarray(ar), rtol=1e-6,
                                   atol=1e-7)

    def test_python_scalar_ck(self):
        rng = np.random.default_rng(7)
        y, t, acc = (torch.from_numpy(rng.standard_normal(33).astype(
            np.float32)) for _ in range(3))
        tk, ak = cheb_step(y, t, acc, -1.25)
        tr, ar = cheb_step_ref(y, t, acc, torch.tensor(-1.25))
        assert torch.equal(tk, tr) and torch.equal(ak, ar)

    def test_checks(self):
        y = torch.zeros(8)
        ck = torch.tensor(1.0)
        cheb_ops._check(y, y, y, ck)
        with pytest.raises(TypeError):
            cheb_ops._check(y.double(), y, y, ck)
        with pytest.raises(ValueError, match="t"):
            cheb_ops._check(y, torch.zeros(9), y, ck)
        with pytest.raises(ValueError, match="contiguous"):
            cheb_ops._check(torch.zeros(4, 2), torch.zeros(2, 4).T,
                            torch.zeros(4, 2), ck)
        with pytest.raises(ValueError, match="ck"):
            cheb_ops._check(y, y, y, torch.zeros(2))


class TestEmbeddingBagParity:
    # rtol/atol 1e-5, the reference's own bound for its kernel vs its oracle
    # (tests/test_kernels.py): both sides sum L products in f32, in
    # different orders.
    @pytest.mark.parametrize("dim", [8, 64, 128])
    @pytest.mark.parametrize("bag", [1, 4, 26])
    def test_plain_vs_pallas_interpret(self, dim, bag):
        v, b = 500, 16
        rng = np.random.default_rng(dim * 100 + bag)
        table = rng.standard_normal((v, dim)).astype(np.float32)
        ids = rng.integers(0, v, (b, bag)).astype(np.int32)
        w = rng.random((b, bag)).astype(np.float32)
        want = np.asarray(j_embedding_bag(jnp.asarray(ids), jnp.asarray(table),
                                          jnp.asarray(w), use_kernel=True,
                                          interpret=True))
        out = embedding_bag(torch.from_numpy(ids), torch.from_numpy(table),
                            torch.from_numpy(w))
        assert out.shape == (b, dim) and out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-5)

    def test_default_weights_sum(self):
        v, d = 50, 8
        table = np.arange(v * d, dtype=np.float32).reshape(v, d)
        ids = np.array([[1, 1, 2], [0, 3, 3]], np.int32)
        want = np.asarray(j_embedding_bag(jnp.asarray(ids), jnp.asarray(table),
                                          use_kernel=True, interpret=True))
        out = embedding_bag(torch.from_numpy(ids), torch.from_numpy(table))
        np.testing.assert_array_equal(out.numpy(), want)
        np.testing.assert_array_equal(
            out.numpy(), np.stack([2 * table[1] + table[2],
                                   table[0] + 2 * table[3]]))

    def test_duplicate_ids_accumulate(self):
        table = np.random.default_rng(0).standard_normal((20, 16)).astype(
            np.float32)
        ids = np.full((4, 7), 5, np.int32)
        want = np.asarray(j_embedding_bag(jnp.asarray(ids), jnp.asarray(table),
                                          use_kernel=True, interpret=True))
        out = embedding_bag(torch.from_numpy(ids), torch.from_numpy(table))
        np.testing.assert_allclose(out.numpy(), want, rtol=1e-5)
        np.testing.assert_allclose(out.numpy(), np.tile(7 * table[5], (4, 1)),
                                   rtol=1e-5)

    def test_casts_like_the_reference_wrapper(self):
        """int64 ids, float64 weights and a float64 table are cast to
        int32 / float32, and the output is float32, as `ops.py` does in the
        reference."""
        rng = np.random.default_rng(3)
        table = rng.standard_normal((30, 12))
        ids = rng.integers(0, 30, (5, 3))
        w = rng.random((5, 3))
        out = embedding_bag(torch.from_numpy(ids), torch.from_numpy(table),
                            torch.from_numpy(w))
        want = np.asarray(j_embedding_bag(
            jnp.asarray(ids), jnp.asarray(table.astype(np.float32)),
            jnp.asarray(w.astype(np.float32)), use_kernel=True,
            interpret=True))
        assert out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-5)


class TestEmbeddingBagChecks:
    """The CUDA path's input checks (run on CPU tensors here: the checks
    are plain Python and raise before any launch)."""

    def _args(self):
        return (torch.zeros(6, 4, dtype=torch.int32), torch.zeros(10, 64),
                torch.ones(6, 4))

    def test_accepts_kernel_inputs(self):
        ids, table, w = self._args()
        eb_ops._check(ids, table, w)
        eb_ops._check(ids, table, None)
        eb_ops._check(ids, torch.zeros(10, 13), None)   # D % 4 != 0

    def test_rejects_wrong_dtypes(self):
        ids, table, w = self._args()
        with pytest.raises(TypeError, match="table"):
            eb_ops._check(ids, table.double(), w)
        with pytest.raises(TypeError, match="ids"):
            eb_ops._check(ids.long(), table, w)
        with pytest.raises(TypeError, match="weights"):
            eb_ops._check(ids, table, w.double())

    def test_rejects_bad_shapes_and_layout(self):
        ids, table, w = self._args()
        with pytest.raises(ValueError, match="table must be"):
            eb_ops._check(ids, table[0], w)
        with pytest.raises(ValueError, match="ids must be"):
            eb_ops._check(ids[0], table, None)
        with pytest.raises(ValueError, match="weights"):
            eb_ops._check(ids, table, w[:, :3])
        with pytest.raises(ValueError, match="table must be contiguous"):
            eb_ops._check(ids, torch.zeros(64, 10).T, w)
        with pytest.raises(ValueError, match="ids must be contiguous"):
            eb_ops._check(torch.zeros(4, 6, dtype=torch.int32).T, table, None)
        with pytest.raises(ValueError, match="weights must be contiguous"):
            eb_ops._check(ids, table, torch.ones(4, 6).T)

    def test_rejects_other_devices(self):
        ids, table, _ = self._args()
        with pytest.raises(ValueError, match="embedding_bag"):
            embedding_bag(ids, table.to("meta"))


class TestBuild:
    def test_sources_cover_both_kernels(self):
        srcs = _build.sources()
        assert set(srcs) == {"bsr_spmm", "cheb_step", "embedding_bag"}
        for path in srcs.values():
            assert path.suffix == ".cu" and path.parent.name == "csrc"

    def test_targets_hopper_with_plain_c_interface(self):
        flags = " ".join(_build.NVCC_FLAGS)
        assert "arch=compute_90a,code=sm_90a" in flags
        assert "-shared" in flags and "-fPIC" in flags
        for name, path in _build.sources().items():
            assert f'extern "C" int {name}_f32(' in path.read_text()

    def test_build_dir_is_ignored_and_nothing_built_on_import(self):
        assert _build.build_dir() == REPO / "build" / "repro_torch_kernels"
        ignored = (REPO / ".gitignore").read_text().split()
        assert "build/" in ignored
        assert not _build._LIBS     # importing the wrappers builds nothing

    def test_cpu_calls_do_not_launch(self):
        bsr_ops.reset_launches()
        cheb_ops.reset_launches()
        eb_ops.reset_launches()
        be = _tiles(8, seed=9)
        bsr_spmm(torch.from_numpy(be.block_cols), torch.from_numpy(be.values),
                 torch.zeros(be.n))
        cheb_step(torch.zeros(3), torch.zeros(3), torch.zeros(3), 1.0)
        embedding_bag(torch.zeros(2, 3, dtype=torch.int32), torch.zeros(4, 8))
        assert bsr_ops.launches() == 0 and cheb_ops.launches() == 0
        assert eb_ops.launches() == 0

    def test_jax_oracle_tiles_identical(self):
        """The kernels see identical tiles whichever package built them."""
        g_ref = jgen.erdos_renyi(300, 5.0, seed=3)
        be_ref = j_build_block_ell(g_ref, block=32)
        be = build_block_ell(generators.erdos_renyi(300, 5.0, seed=3),
                             block=32)
        assert be.values.tobytes() == be_ref.values.tobytes()
