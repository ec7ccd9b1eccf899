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
from repro_torch.kernels.adamw import ops as adamw_ops
from repro_torch.kernels.adamw.ops import adamw_step, sum_squares
from repro_torch.kernels.bsr_spmm import ops as bsr_ops
from repro_torch.kernels.bsr_spmm.ops import BLOCK, bsr_spmm
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

    def test_rejects_tile_rows_past_int32(self):
        """The wgmma variant addresses values as [n_rb * S * 128, 128] rows
        with int32 TMA coordinates (meta tensors: no memory is taken)."""
        n_rb, slots = 2 ** 20, 16             # n_rb * S * 128 = 2^31
        with pytest.raises(ValueError, match="int32"):
            bsr_ops._check(
                torch.empty(n_rb, slots, dtype=torch.int32, device="meta"),
                torch.empty(n_rb, slots, BLOCK, BLOCK, device="meta"),
                torch.empty(n_rb * BLOCK, 8, device="meta"))


def _tf32_rna(a: np.ndarray) -> np.ndarray:
    """Round f32 to tf32 (10 explicit mantissa bits), to nearest with ties
    away from zero: cvt.rna.tf32.f32."""
    b = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_trunc(a: np.ndarray) -> np.ndarray:
    """Truncate f32 to tf32: what the tensor cores read of a raw f32."""
    b = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    return (b & np.uint32(0xFFFFE000)).view(np.float32)


def _bsr_3xtf32(block_cols, values, x, passes: int = 3) -> np.ndarray:
    """The tensor-core variant's arithmetic (csrc/bsr_spmm.cu, BT >= 2) in
    numpy f32: values split as hi = trunc(v), lo = rna(v - hi); x as hi =
    rna(x), lo = rna(x - hi); each slot's hi*hi added into the row block's
    sum, the small lo*hi + hi*lo terms summed apart over the row block and
    added at the end (passes=1: hi*hi alone).

    The operands are rounded exactly as on the card, but numpy sums the
    products in IEEE f32 while the tensor cores accumulate in their own
    order and truncate, which this cannot reproduce: the card checks
    (tests/test_torch_gpu.py, chip_smoke.py) decide whether the kernel
    itself holds the bound."""
    n_rb, slots, blk, _ = values.shape
    xb = x.reshape(n_rb, blk, -1)
    y = np.zeros_like(xb)
    for i in range(n_rb):
        cross = np.zeros_like(xb[i])
        for s in range(slots):
            v = values[i, s]
            xs = xb[block_cols[i, s]]
            vh = _tf32_trunc(v)
            vl = _tf32_rna(v - vh)
            xh = _tf32_rna(xs)
            xl = _tf32_rna(xs - xh)
            y[i] += vh @ xh
            if passes == 3:
                cross += vh @ xl + vl @ xh
        y[i] += cross
    return y.reshape(x.shape)


class TestBsrSpmm3xTf32:
    """Why the tensor-core variant splits each operand in three products:
    the split meets the reference's 1e-5 bound on its own tiles (block 128,
    as on the card), a single TF32 pass does not."""

    def _case(self, bt):
        be = _tiles(128, seed=128 + bt)
        x = np.random.default_rng(1000 + bt).standard_normal(
            (be.n, bt)).astype(np.float32)
        y_ref = np.asarray(j_bsr_spmm(jnp.asarray(be.block_cols),
                                      jnp.asarray(be.values), jnp.asarray(x),
                                      use_kernel=True, interpret=True))
        return be, x, y_ref

    @pytest.mark.parametrize("bt", [8, 128])
    def test_split_meets_the_reference_bound(self, bt):
        be, x, y_ref = self._case(bt)
        y = _bsr_3xtf32(be.block_cols, be.values, x)
        np.testing.assert_allclose(y, y_ref, rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("bt", [8, 128])
    def test_single_tf32_pass_misses_it(self, bt):
        be, x, y_ref = self._case(bt)
        y = _bsr_3xtf32(be.block_cols, be.values, x, passes=1)
        assert not np.allclose(y, y_ref, rtol=1e-5, atol=1e-5)
        assert np.abs(y - y_ref).max() > 1e-4

    def test_split_parts(self):
        """hi and lo are tf32 (low 13 bits clear) and hi + lo is v to
        within 2^-21 of |v|: the two roundings the kernel uses."""
        v = np.random.default_rng(5).standard_normal(10_000).astype(
            np.float32) * np.float32(1e3)
        for hi in (_tf32_trunc(v), _tf32_rna(v)):
            lo = _tf32_rna(v - hi)
            for part in (hi, lo):
                assert not (part.view(np.uint32) & np.uint32(0x1FFF)).any()
            gap = np.abs(v.astype(np.float64) - hi - lo.astype(np.float64))
            assert (gap <= np.abs(v) * 2.0 ** -21).all()


class TestBsrSpmmDispatch:
    """Which kernel variant each width of x takes (a dispatch by shape)."""

    def test_every_width_up_to_256(self):
        for bt in range(1, 257):
            want = "ffma" if bt == 1 else "wgmma_3xtf32"
            assert bsr_ops.variant(bt) == want, bt

    @pytest.mark.parametrize("bt, offset", [(8, 0), (128, 0), (13, 0),
                                            (1, 0), (16, 1)])
    def test_tma_ready_pads_what_tma_cannot_load(self, bt, offset):
        """The tensor-core variant's x: as given when its rows are a
        multiple of 4 floats at a 16-byte aligned base, else a zero-padded
        copy of width rounded up to 4 at a new base."""
        flat = torch.randn(256 * bt + offset)
        x = flat[offset:].view(256, bt)
        xk = bsr_ops._tma_ready(x)
        if bt % 4 == 0 and offset == 0:
            assert xk is x
            return
        assert xk.shape == (256, -(-bt // 4) * 4) and xk.is_contiguous()
        assert xk.data_ptr() % 16 == 0
        assert torch.equal(xk[:, :bt], x)
        assert not xk[:, bt:].any()

    def test_counters_by_variant(self):
        bsr_ops.reset_launches()
        assert bsr_ops.launches_by_variant() == dict.fromkeys(
            bsr_ops.VARIANTS, 0)
        assert bsr_ops.launches() == 0
        assert set(bsr_ops.VARIANTS) == {bsr_ops.variant(1),
                                         bsr_ops.variant(128)}


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
        assert set(srcs) == {"bsr_spmm", "cheb_step", "cheb_step_masked",
                             "cheb_residual", "embedding_bag",
                             "embedding_bag_backward", "adamw_step",
                             "sum_squares", "topk_columns", "attention_fwd",
                             "attention_bwd"}
        for path in srcs.values():
            assert path.suffix == ".cu" and path.parent.name == "csrc"

    def test_targets_hopper_with_plain_c_interface(self):
        flags = " ".join(_build.NVCC_FLAGS)
        assert "arch=compute_90a,code=sm_90a" in flags
        assert "-shared" in flags and "-fPIC" in flags
        for name, path in _build.sources().items():
            assert f'extern "C" int {name}_f32(' in path.read_text()

    def test_library_path_is_the_hashed_target(self):
        path = _build.library_path("bsr_spmm")
        assert path.parent == _build.build_dir()
        assert path.name.startswith("bsr_spmm-") and path.suffix == ".so"
        assert "bsr_spmm" not in _build._LIBS   # naming it builds nothing

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
        adamw_ops.reset_launches()
        one = torch.ones(())
        adamw_step(torch.zeros(5), torch.zeros(5), torch.zeros(5),
                   torch.zeros(5), one, one, one, lr=1e-3, b1=0.9, b2=0.95,
                   eps=1e-8, weight_decay=0.1, in_place=True)
        sum_squares(torch.zeros(5))
        assert bsr_ops.launches() == 0 and cheb_ops.launches() == 0
        assert eb_ops.launches() == 0
        assert adamw_ops.step_launches() == adamw_ops.norm_launches() == 0

    def test_jax_oracle_tiles_identical(self):
        """The kernels see identical tiles whichever package built them."""
        g_ref = jgen.erdos_renyi(300, 5.0, seed=3)
        be_ref = j_build_block_ell(g_ref, block=32)
        be = build_block_ell(generators.erdos_renyi(300, 5.0, seed=3),
                             block=32)
        assert be.values.tobytes() == be_ref.values.tobytes()
