"""The adaptive CPAA loop's two vector passes on the CPU: the masked round
(`kernels.cheb_step.ops.cheb_step_masked`) and the chunk residual
(`cheb_residual`), whose wrappers take their plain versions on CPU
tensors.

* the plain masked round against a `torch.where` transcription of the
  reference's masked round (src/repro/core/pagerank.py:224-230), bitwise,
  and against the same round in JAX through the reference's `cheb_step`;
* the loop (`cpaa_adaptive_fixed`) against the loop it replaced, which
  masked every round with five `torch.where`s (`_where_loop` below, the
  earlier body kept verbatim): pi, column rounds and residuals bitwise on
  the deterministic CPU engines, in 1-D and 2-D, at chunk 1, 3 and 8, on
  inputs whose columns freeze at different chunks;
* the plain residual against the reference's `colnorm` / residual
  arithmetic run through JAX on the same numpy inputs (rtol 1e-6: two
  float32 sums in different orders);
* the wrappers on CPU tensors launch nothing, and refuse other devices.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.cheb_step.ops import cheb_step as j_cheb_step
from repro_torch.core.engine import (BlockEllEngine, CooEngine,
                                     FusedBlockEllEngine, HubTailEngine)
from repro_torch.core.pagerank import _normalize, cpaa_adaptive_fixed
from repro_torch.graph import generators
from repro_torch.graph.ops import device_graph
from repro_torch.kernels.cheb_step import ops as cheb_ops
from repro_torch.kernels.cheb_step.ops import cheb_residual, \
    cheb_step_masked
from repro_torch.kernels.cheb_step.ref import (cheb_residual_ref,
                                               cheb_step_masked_ref,
                                               cheb_step_ref)

SHAPES = [(37,), (64, 8), (101, 3), (50, 1)]
C, TOL, MAX_ROUNDS = 0.85, 1e-5, 60


def _operands(shape, seed):
    rng = np.random.default_rng(seed)
    y, t, acc = (rng.standard_normal(shape).astype(np.float32)
                 for _ in range(3))
    cols = shape[1:]
    active = rng.random(cols) < 0.5 if cols else np.bool_(seed % 2)
    if cols and cols[0] > 1:
        active[0], active[-1] = True, False     # both states
    return y, t, acc, np.asarray(active)


def _widen(mask, ndim):
    return mask if ndim == 1 else mask[None, :]


# -------------------------------------------------------- the masked round --
class TestMaskedRound:
    @pytest.mark.parametrize("shape", SHAPES)
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_plain_is_the_reference_where_round(self, shape, seed):
        """The reference's round on the same state: the SpMM output y of
        the masked t_cur, then cheb_round on the masked t_prev, then the
        three masked carries. Active columns: t'' and acc' bitwise; frozen
        ones: t'' = 0 (the loop never reads a frozen t again) and acc
        unchanged."""
        y, t, acc, active = (torch.from_numpy(a) for a in
                             _operands(shape, seed))
        ck = torch.tensor(0.37, dtype=torch.float32)
        mask = _widen(active, y.ndim)
        t_next, acc_next = cheb_step_ref(y, torch.where(mask, t, 0.0), acc,
                                         ck)
        want_acc = torch.where(mask, acc_next, acc)
        got_t, got_acc = cheb_step_masked_ref(y.clone(), t.clone(),
                                              acc.clone(), ck, active)
        assert torch.equal(got_acc, want_acc)
        assert torch.equal(got_t, torch.where(mask, t_next, 0.0))

    @pytest.mark.parametrize("shape", SHAPES)
    def test_plain_vs_jax_masked_round(self, shape):
        y, t, acc, active = _operands(shape, 5)
        ck = np.float32(-1.25)
        mask = _widen(active, y.ndim)
        tj, aj = j_cheb_step(jnp.asarray(y), jnp.where(mask, t, 0.0),
                             jnp.asarray(acc), ck)
        want_t = np.where(mask, np.asarray(tj), 0.0)
        want_acc = np.where(mask, np.asarray(aj), acc)
        got_t, got_acc = cheb_step_masked(*(torch.from_numpy(a.copy()) for
                                            a in (y, t, acc)), float(ck),
                                          torch.from_numpy(active))
        np.testing.assert_allclose(got_t.numpy(), want_t, rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(got_acc.numpy(), want_acc, rtol=1e-6,
                                   atol=1e-6)

    def test_in_place_and_t_untouched(self):
        y, t, acc, active = (torch.from_numpy(a) for a in
                             _operands((64, 8), 3))
        t0 = t.clone()
        out_t, out_acc = cheb_step_masked(y, t, acc, 0.5, active)
        assert out_t is y and out_acc is acc
        assert torch.equal(t, t0)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    def test_both_dtypes(self, dtype):
        y, t, acc, active = _operands((64, 8), 4)
        args = [torch.from_numpy(a).to(dtype) for a in (y, t, acc)]
        got = cheb_step_masked(*(a.clone() for a in args), 0.5,
                               torch.from_numpy(active))
        want = cheb_step_masked_ref(*(a.clone() for a in args),
                                    torch.tensor(0.5, dtype=dtype),
                                    torch.from_numpy(active))
        assert all(g.dtype == dtype and torch.equal(g, w)
                   for g, w in zip(got, want))


# ----------------------------------------------------------- the residual --
def _jax_colnorm_resid(acc, snap):
    """The reference's colnorm and chunk residual
    (src/repro/core/pagerank.py:195-197, :233-234)."""
    tiny = jnp.asarray(jnp.finfo(jnp.float32).tiny, jnp.float32)
    a = jnp.asarray(acc)
    s = jnp.sum(a, axis=0)
    norm = a / jnp.where(jnp.abs(s) < tiny, tiny, s)
    return np.asarray(jnp.sum(jnp.abs(norm - jnp.asarray(snap)), axis=0)), \
        np.asarray(norm)


class TestResidual:
    @pytest.mark.parametrize("shape", SHAPES + [(1000, 16)])
    def test_plain_vs_reference_arithmetic(self, shape):
        rng = np.random.default_rng(7)
        acc = rng.random(shape).astype(np.float32)
        if len(shape) > 1 and shape[1] > 2:
            acc[:, 1] = 0.0                     # the tiny guard's column
        snap = rng.random(shape).astype(np.float32) / shape[0]
        want_r, want_norm = _jax_colnorm_resid(acc, snap)
        snap_t = torch.from_numpy(snap.copy())
        got = cheb_residual(torch.from_numpy(acc), snap_t)
        assert got.shape == shape[1:] and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want_r, rtol=1e-6)
        np.testing.assert_allclose(snap_t.numpy(), want_norm, rtol=1e-6,
                                   atol=0)

    def test_reduce_hook_sums_both(self):
        """`reduce` acts on the column sums and on the residual, as a
        sharded engine's all-reduce over two equal ranks would."""
        rng = np.random.default_rng(8)
        acc = torch.from_numpy(rng.random((40, 4)).astype(np.float32))
        snap = torch.zeros(40, 4)
        seen = []

        def twice(x):
            seen.append(x.shape)
            return 2 * x
        r = cheb_residual_ref(acc, snap, twice)
        assert seen == [(4,), (4,)]
        s = 2 * acc.sum(dim=0)
        torch.testing.assert_close(snap, acc / s, rtol=0, atol=0)
        torch.testing.assert_close(r, 2 * (acc / s).sum(dim=0), rtol=0,
                                   atol=0)


# ---------------------------------------------------------------- the loop --
def _where_loop(eng, p, c, tol, max_rounds, chunk):
    """`cpaa_adaptive_fixed` as it was before the masked-round kernel:
    five torch.where passes a round, colnorm and residual in eager ops."""
    t_prev = eng.to_internal(p)
    dtype, dev = t_prev.dtype, t_prev.device
    c = torch.full((), c, dtype=dtype, device=dev)
    tol = torch.full((), tol, dtype=dtype, device=dev)
    tiny = torch.full((), torch.finfo(dtype).tiny, dtype=dtype, device=dev)
    sq = torch.sqrt(1.0 - c * c)
    beta = (1.0 - sq) / c
    c0 = 2.0 / sq

    cols = () if t_prev.ndim == 1 else (t_prev.shape[1],)

    def colnorm(a):
        s = eng.colsum(a)
        return a / torch.where(s.abs() < tiny, tiny, s)

    acc = (0.5 * c0) * t_prev
    t_cur = eng.apply(t_prev)
    ck = c0 * beta
    acc = acc + ck * t_cur

    active = torch.ones(cols, dtype=torch.bool, device=dev)
    col_rounds = torch.ones(cols, dtype=torch.int32, device=dev)
    resid = torch.full(cols, float("inf"), dtype=dtype, device=dev)
    snap = colnorm(acc)
    zero = torch.zeros((), dtype=dtype, device=dev)
    k = 1
    while k < max_rounds and bool(active.any()):
        mask = active if t_prev.ndim == 1 else active[None, :]
        for _ in range(chunk):
            if k >= max_rounds:
                break
            ck = ck * beta
            y = eng.apply(torch.where(mask, t_cur, zero))
            t_next, acc_next = eng.cheb_round(
                y, torch.where(mask, t_prev, zero), acc, ck)
            t_prev = torch.where(mask, t_cur, t_prev)
            t_cur = torch.where(mask, t_next, t_cur)
            acc = torch.where(mask, acc_next, acc)
            k += 1
        norm = colnorm(acc)
        resid = eng.colsum((norm - snap).abs())
        col_rounds = torch.where(active, torch.full_like(col_rounds, k),
                                 col_rounds)
        active = active & (resid > tol)
        snap = norm
    return _normalize(eng.from_internal(acc)), k, col_rounds, resid


GRAPHS = {"tri_mesh": lambda: generators.tri_mesh(20, 24),
          "erdos_renyi": lambda: generators.erdos_renyi(400, 4.0, seed=2)}


def _engine(kind, g):
    if kind == "coo":
        return CooEngine(device_graph(g, device="cpu"))
    if kind == "hub_tail":
        return HubTailEngine.from_graph(g, hub_min_deg=6, device="cpu")
    if kind == "block_ell":
        return BlockEllEngine.from_graph(g, block=32, device="cpu")
    return FusedBlockEllEngine.from_graph(g, block=32, device="cpu") \
        .with_kernels(False)


def _personalization(n, batched):
    """Single seeds in even columns, dense random ones in odd columns:
    they converge at different chunks."""
    rng = np.random.default_rng(0)
    p = np.zeros((n, 8), np.float32)
    for j in range(8):
        if j % 2:
            p[:, j] = rng.random(n)
        else:
            p[rng.integers(0, n), j] = 1.0
    return torch.from_numpy(p if batched else p[:, 1].copy())


class TestLoopMatchesWhereLoop:
    @pytest.mark.parametrize("graph", list(GRAPHS))
    @pytest.mark.parametrize("kind", ["coo", "hub_tail", "block_ell",
                                      "fused_plain"])
    @pytest.mark.parametrize("batched", [False, True], ids=["1d", "2d"])
    @pytest.mark.parametrize("chunk", [1, 3, 8])
    def test_bitwise(self, graph, kind, batched, chunk):
        g = GRAPHS[graph]()
        eng = _engine(kind, g)
        p = _personalization(g.n, batched)
        p0 = p.clone()
        pi_w, k_w, cols_w, res_w = _where_loop(eng, p, C, TOL, MAX_ROUNDS,
                                               chunk)
        cheb_ops.reset_launches()
        pi, k, cols, res = cpaa_adaptive_fixed(eng, p, C, TOL, MAX_ROUNDS,
                                               chunk)
        assert torch.equal(p, p0)       # the caller's p is only read
        assert k == k_w < MAX_ROUNDS
        assert torch.equal(cols, cols_w)
        assert torch.equal(res, res_w)
        assert torch.equal(pi, pi_w)
        if batched:     # columns froze at different chunks
            assert len(set(cols.tolist())) >= 2
        assert cheb_ops.masked_launches() == cheb_ops.residual_launches() \
            == 0


# ------------------------------------------------------ routing and checks --
class TestWrappers:
    def test_cpu_calls_do_not_launch(self):
        cheb_ops.reset_launches()
        y, t, acc, active = (torch.from_numpy(a) for a in
                             _operands((64, 8), 6))
        cheb_step_masked(y, t, acc, 0.5, active)
        cheb_residual(acc, t)
        assert (cheb_ops.launches(), cheb_ops.masked_launches(),
                cheb_ops.residual_launches()) == (0, 0, 0)

    def test_engines_route_by_use_kernel(self):
        g = GRAPHS["tri_mesh"]()
        eng = FusedBlockEllEngine.from_graph(g, block=32, device="cpu")
        y, t, acc, active = (torch.from_numpy(a) for a in
                             _operands((eng.n_pad, 8), 7))
        for e in (eng, eng.with_kernels(False)):
            got = e.cheb_round_masked(y.clone(), t, acc.clone(), 0.5,
                                      active)
            want = cheb_step_masked_ref(y.clone(), t, acc.clone(),
                                        torch.tensor(0.5), active)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
            snap, snap_ref = t.clone(), t.clone()
            assert torch.equal(e.chunk_residual(acc, snap),
                               cheb_residual_ref(acc, snap_ref))
            assert torch.equal(snap, snap_ref)

    @pytest.mark.parametrize("fn", ["masked", "residual"])
    def test_rejects_other_devices(self, fn):
        x = torch.zeros(8, 4, device="meta")
        with pytest.raises(ValueError, match="cheb_"):
            if fn == "masked":
                cheb_step_masked(x, x, x, 0.5,
                                 torch.ones(4, dtype=torch.bool,
                                            device="meta"))
            else:
                cheb_residual(x, x)

    def test_checks(self):
        x = torch.zeros(8, 4)
        on = torch.ones(4, dtype=torch.bool)
        ck = torch.tensor(0.5)
        cheb_ops._check_masked(x, x, x, ck, on)
        with pytest.raises(TypeError, match="float32 or float64"):
            h = x.to(torch.bfloat16)
            cheb_ops._check_masked(h, h, h, ck, on)
        with pytest.raises(ValueError, match="active"):
            cheb_ops._check_masked(x, x, x, ck, on[:3])
        with pytest.raises(ValueError, match="active"):
            cheb_ops._check_masked(x, x, x, ck, on.float())
        with pytest.raises(ValueError, match="contiguous"):
            cheb_ops._check_masked(x, x.T.contiguous().T, x, ck, on)
        with pytest.raises(ValueError, match="ck"):
            cheb_ops._check_masked(x, x, x, ck.double(), on)
        cheb_ops._check_residual(x, x)
        with pytest.raises(ValueError, match="snap"):
            cheb_ops._check_residual(x, x[:, :3])
        with pytest.raises(ValueError, match="non-empty"):
            cheb_ops._check_residual(x[:0], x[:0])
        with pytest.raises(TypeError, match="float32 or float64"):
            cheb_ops._check_residual(x.half(), x.half())

    def test_both_sources_export_f32_and_f64(self):
        from repro_torch.kernels import _build
        srcs = _build.sources()
        text = srcs["cheb_step_masked"].read_text()
        assert 'extern "C" int cheb_step_masked_f64(' in text
        text = srcs["cheb_residual"].read_text()
        for name in ("cheb_colsum_f32", "cheb_colsum_f64",
                     "cheb_residual_f64"):
            assert f'extern "C" int {name}(' in text
        assert 'extern "C" int64_t cheb_residual_partials(' in text
