"""The AdamW kernels' wrappers and plain versions on the CPU
(`repro_torch.kernels.adamw`), held to the JAX reference's
`adamw_update` / `global_norm` and to a numpy emulation of the CUDA
kernel's op order and constants.

The kernels themselves run only on the card (`tests/test_torch_gpu.py`,
chip_smoke.py). Here: the wrapper on CPU tensors is bitwise the plain
version and launches nothing; the plain version matches the reference
(rtol 1e-6 / atol 1e-7, the suite's AdamW tolerance; the reference runs in
f32 where the port's f64 parameters update in f64); the emulation, which
rounds every operation on its own in the math type and the constants as
torch rounds a Python scalar, is bitwise the plain version. It takes the
square root as a function: torch's CPU sqrt is not correctly rounded
(1 ulp off on ~13% of f32 inputs), so the emulation is held to the plain
version with that root, and the card's kernel uses the IEEE root
(__fsqrt_rn), as torch's CUDA sqrt does.
"""
import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.train import optimizer as j_opt
from repro_torch.kernels import cost
from repro_torch.kernels.adamw import ops as adamw_ops
from repro_torch.kernels.adamw.ops import adamw_step, sum_squares
from repro_torch.kernels.adamw.ref import (_slices, adamw_step_ref,
                                           sum_squares_ref)
from repro_torch.launch import analysis
from repro_torch.train.optimizer import (AdamWConfig, adamw_init,
                                         adamw_update, global_norm)

SRC = Path(adamw_ops.__file__).resolve().parent / "csrc"
TOL = dict(rtol=1e-6, atol=1e-7)      # tests/test_torch_train.py's AdamW
HYPER = dict(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)

# (p, g, m and v) dtypes the kernel takes
COMBOS = {"f32": (torch.float32, torch.float32, torch.float32),
          "f32_bf16": (torch.float32, torch.float32, torch.bfloat16),
          "f64_g32": (torch.float64, torch.float32, torch.float32),
          "f64": (torch.float64, torch.float64, torch.float32),
          "f64_bf16": (torch.float64, torch.float64, torch.bfloat16)}

# (p, g, m, v) dtypes the kernel does not take
UNSUPPORTED = [
    (torch.bfloat16, torch.bfloat16, torch.float32, torch.float32),
    (torch.float16, torch.float16, torch.float32, torch.float32),
    (torch.float32, torch.float64, torch.float32, torch.float32),
    (torch.float32, torch.float32, torch.float32, torch.bfloat16),
    (torch.float32, torch.float32, torch.float16, torch.float16),
    (torch.float64, torch.bfloat16, torch.float32, torch.float32)]
UNSUPPORTED_IDS = ["p_bf16", "p_f16", "f32_p_f64_g", "mixed_moments",
                   "f16_moments", "bf16_g"]


def _leaf(shape, combo: str, seed: int):
    """(p, g, m, v) made with numpy, in `combo`'s dtypes; v >= 0."""
    pd, gd, md = COMBOS[combo]
    r = np.random.default_rng(seed)
    p = torch.from_numpy(r.standard_normal(shape)).to(pd)
    g = torch.from_numpy(r.standard_normal(shape) * 3).to(gd)
    m = torch.from_numpy(r.standard_normal(shape) * 0.1).to(md)
    v = torch.from_numpy(np.abs(r.standard_normal(shape)) * 0.01).to(md)
    return p, g, m, v


def _scalars(step: int = 3, scale: float = 0.37,
             scale_dtype=torch.float32):
    """(scale, bc1, bc2) as `adamw_update` makes them."""
    stepf = torch.tensor(step, dtype=torch.int32).to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(HYPER["b1"], dtype=torch.float32),
                          stepf)
    bc2 = 1.0 - torch.pow(torch.tensor(HYPER["b2"], dtype=torch.float32),
                          stepf)
    return torch.tensor(scale, dtype=scale_dtype), bc1, bc2


def _bits(t: torch.Tensor) -> np.ndarray:
    """The tensor's bytes as unsigned integers of its width."""
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.contiguous().view(ints[t.element_size()]).numpy()


# ------------------------------------------------------ numpy emulation --
def _bf16_to_f32(u16: np.ndarray) -> np.ndarray:
    return (u16.astype(np.uint32) << 16).view(np.float32)


def _f32_to_bf16(x: np.ndarray) -> np.ndarray:
    """Round to nearest even (finite inputs), as __float2bfloat16_rn."""
    u = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) >> 16
    return u.astype(np.uint16)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """f32 / f64 as they are; bf16 widened exactly to f32."""
    if t.dtype == torch.bfloat16:
        return _bf16_to_f32(_bits(t).view(np.uint16))
    return t.numpy()


def emulate(p, g, m, v, scale, bc1, bc2, sqrt=np.sqrt, lr=3e-4, b1=0.9,
            b2=0.95, eps=1e-8, weight_decay=0.1):
    """The kernel's arithmetic in numpy: (p', m', v') as numpy arrays (bf16
    moments as uint16 bits). Math in f32, or f64 for an f64 p; every
    operation rounded on its own; the constants the Python doubles (1 - b1
    and 1 - b2 in double) rounded once to the math type; scale, bc1, bc2
    converted to it; the moments stored rounded to nearest even (from f64
    via f32, as c10's BFloat16 does)."""
    t = np.float64 if p.dtype == torch.float64 else np.float32
    c = {k: t(x) for k, x in dict(lr=lr, b1=b1, omb1=1 - b1, b2=b2,
                                  omb2=1 - b2, eps=eps,
                                  wd=weight_decay).items()}
    P, G, M, V = (_to_numpy(x).astype(t) for x in (p, g, m, v))
    s = t(scale.numpy()[()])
    B1, B2 = t(bc1.numpy()[()]), t(bc2.numpy()[()])
    gs = G * s
    mn = c["b1"] * M + c["omb1"] * gs
    vn = c["b2"] * V + c["omb2"] * (gs * gs)
    delta = (mn / B1) / (sqrt(vn / B2) + c["eps"]) + c["wd"] * P
    pn = (P - c["lr"] * delta).astype(_to_numpy(p).dtype)

    def store(x, like):
        if like.dtype == torch.bfloat16:
            return _f32_to_bf16(x.astype(np.float32))
        return x.astype(np.float64 if like.dtype == torch.float64
                        else np.float32)
    return pn, store(mn, m), store(vn, v)


def _cpu_sqrt(x: np.ndarray) -> np.ndarray:
    return torch.sqrt(torch.from_numpy(x)).numpy()


class TestEmulation:
    @pytest.mark.parametrize("combo", list(COMBOS))
    @pytest.mark.parametrize("scale_dtype", [torch.float32, torch.float64])
    def test_emulation_is_bitwise_the_plain_version(self, combo,
                                                    scale_dtype):
        p, g, m, v = _leaf((1001,), combo, seed=1)
        scale, bc1, bc2 = _scalars(step=2, scale=0.37,
                                   scale_dtype=scale_dtype)
        got = adamw_step_ref(p, g, m, v, scale, bc1, bc2, **HYPER)
        want = emulate(p, g, m, v, scale, bc1, bc2, sqrt=_cpu_sqrt)
        for t, w in zip(got, want):
            np.testing.assert_array_equal(_bits(t), w.view(_bits(t).dtype))

    def test_cpu_sqrt_is_the_only_rounding_that_differs(self):
        """With the IEEE root the emulation differs from the CPU's plain
        version only where torch's CPU sqrt is off the correctly rounded
        root; m and v never involve it."""
        p, g, m, v = _leaf((4096,), "f32", seed=2)
        scale, bc1, bc2 = _scalars()
        got = adamw_step_ref(p, g, m, v, scale, bc1, bc2, **HYPER)
        ieee = emulate(p, g, m, v, scale, bc1, bc2)
        np.testing.assert_array_equal(got[1].numpy(), ieee[1])
        np.testing.assert_array_equal(got[2].numpy(), ieee[2])
        v_hat = got[2] / bc2
        off = (torch.sqrt(v_hat).numpy() != np.sqrt(v_hat.numpy()))
        differ = got[0].numpy() != ieee[0]
        assert not (differ & ~off).any()

    def test_constants_round_as_torch_rounds_a_python_scalar(self):
        """(1 - b1) is taken in double and then rounded: not 1.0f - 0.9f."""
        assert np.float32(1 - 0.9) != np.float32(1) - np.float32(0.9)
        g = torch.full((4,), 1.0)
        got = (1 - 0.9) * g
        assert float(got[0]) == float(np.float32(1 - 0.9))


# ---------------------------------------------------- wrapper vs plain --
class TestWrapperOnCpu:
    @pytest.mark.parametrize("combo", list(COMBOS))
    @pytest.mark.parametrize("in_place", [False, True])
    def test_cpu_wrapper_is_bitwise_plain_and_launches_nothing(
            self, combo, in_place):
        adamw_ops.reset_launches()
        p, g, m, v = _leaf((7, 33), combo, seed=3)
        scale, bc1, bc2 = _scalars()
        want = adamw_step_ref(p, g, m, v, scale, bc1, bc2, **HYPER)
        before = [t.clone() for t in (p, g, m, v)]
        got = adamw_step(p, g, m, v, scale, bc1, bc2, in_place=in_place,
                         **HYPER)
        for t, w in zip(got, want):
            assert t.dtype == w.dtype and torch.equal(t, w)
        if in_place:
            assert all(a is b for a, b in zip(got, (p, m, v)))
        else:
            assert all(torch.equal(a, b)
                       for a, b in zip((p, g, m, v), before))
        assert torch.equal(sum_squares(g), sum_squares_ref(g))
        assert adamw_ops.step_launches() == adamw_ops.norm_launches() == 0
        assert adamw_ops.contiguous_copies() == 0

    def test_non_contiguous_gradient_on_cpu(self):
        p, g, m, v = _leaf((6, 5), "f32", seed=4)
        gt = g.t().contiguous().t()
        assert not gt.is_contiguous()
        scale, bc1, bc2 = _scalars()
        a = adamw_step(p, gt, m, v, scale, bc1, bc2, **HYPER)
        b = adamw_step_ref(p, g, m, v, scale, bc1, bc2, **HYPER)
        assert all(torch.equal(x, y) for x, y in zip(a, b))

    def test_contiguous_copies_are_counted_only_when_made(self):
        adamw_ops.reset_launches()
        x = torch.zeros(4, 3)
        assert adamw_ops._contiguous(x) is x
        assert adamw_ops.contiguous_copies() == 0
        y = adamw_ops._contiguous(x.t())
        assert y.is_contiguous() and adamw_ops.contiguous_copies() == 1
        adamw_ops.reset_launches()

    def test_slices_give_the_whole_leaf_bits(self, monkeypatch):
        from repro_torch.kernels.adamw import ref
        p, g, m, v = _leaf((9, 4, 3), "f32_bf16", seed=5)
        scale, bc1, bc2 = _scalars()
        whole = adamw_step_ref(p, g, m, v, scale, bc1, bc2, **HYPER)
        monkeypatch.setattr(ref, "_SLICE_ELEMS", 25)
        assert len(_slices(p)) == 5
        sliced = adamw_step_ref(p, g, m, v, scale, bc1, bc2, **HYPER)
        assert all(torch.equal(a, b) for a, b in zip(whole, sliced))

    @pytest.mark.parametrize("dtypes", UNSUPPORTED,
                             ids=UNSUPPORTED_IDS)
    def test_unsupported_dtypes_raise(self, dtypes):
        """Checked where a kernel would run: on meta tensors here (the
        card's own check in tests/test_torch_gpu.py)."""
        p, g, m, v = (torch.zeros(3, dtype=d, device="meta")
                      for d in dtypes)
        scale, bc1, bc2 = (t.to("meta") for t in _scalars())
        with pytest.raises(TypeError):
            adamw_step(p, g, m, v, scale, bc1, bc2, **HYPER)

    @pytest.mark.parametrize("dtypes", UNSUPPORTED,
                             ids=UNSUPPORTED_IDS)
    def test_cpu_takes_any_dtype_through_the_plain_version(self, dtypes):
        """On the CPU every dtype goes to the plain version, as it did
        before the kernels (the reference takes bf16 and f16 leaves)."""
        p, g, m, v = (torch.from_numpy(
            np.random.default_rng(i).standard_normal(5)).abs().to(d)
            for i, d in enumerate(dtypes))
        scale, bc1, bc2 = _scalars()
        want = adamw_step_ref(p, g, m, v, scale, bc1, bc2, **HYPER)
        got = adamw_step(p, g, m, v, scale, bc1, bc2, **HYPER)
        assert all(a.dtype == b.dtype and torch.equal(a, b)
                   for a, b in zip(got, want))
        assert torch.equal(sum_squares(p), sum_squares_ref(p))

    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                       torch.int32])
    def test_unsupported_norm_dtypes_raise(self, dtype):
        with pytest.raises(TypeError):
            sum_squares(torch.zeros(3, dtype=dtype, device="meta"))

    def test_bias_corrections_must_be_f32(self):
        p, g, m, v = (t.to("meta") for t in _leaf((3,), "f32", seed=6))
        scale, bc1, bc2 = (t.to("meta") for t in _scalars())
        with pytest.raises(TypeError):
            adamw_step(p, g, m, v, scale, bc1.double(), bc2, **HYPER)

    def test_flags_match_the_source(self):
        src = (SRC / "adamw_step.cu").read_text()
        flags = dict(re.findall(r"constexpr int64_t (k\w+) = (\d+);", src))
        assert (int(flags["kMomentsBf16"]), int(flags["kScaleF64"]),
                int(flags["kGradF64"])) == (adamw_ops._MOMENTS_BF16,
                                            adamw_ops._SCALE_F64,
                                            adamw_ops._GRAD_F64)
        assert 'extern "C" int adamw_step_f64(' in src
        assert 'extern "C" int sum_squares_f64(' in \
            (SRC / "sum_squares.cu").read_text()


# ------------------------------------------------------------- meta --
class TestMeta:
    @pytest.mark.parametrize("combo", ["f32", "f32_bf16", "f64_g32"])
    @pytest.mark.parametrize("in_place", [False, True])
    def test_meta_reports_the_kernel_cost_and_returns_meta(self, combo,
                                                           in_place):
        pd, gd, md = COMBOS[combo]
        shape = (5, 7)
        p, m, v = (torch.empty(shape, dtype=d, device="meta")
                   for d in (pd, md, md))
        g = torch.empty(shape, dtype=gd, device="meta")
        scale, bc1, bc2 = (torch.empty((), device="meta") for _ in range(3))
        seen = []
        adamw_ops.reset_launches()
        with cost.collecting(lambda name, fn: seen.append((name, fn()))):
            out = adamw_step(p, g, m, v, scale, bc1, bc2, in_place=in_place,
                             **HYPER)
            norm = sum_squares(g)
        n = 35
        per = 2 * p.element_size() + g.element_size() + 4 * m.element_size()
        assert seen == [("adamw_step", (17 * n, n * per + 4 + 8)),
                        ("sum_squares", (2 * n, (n + 1) * g.element_size()))]
        assert all(t.device.type == "meta" and t.shape == shape
                   for t in out)
        assert [t.dtype for t in out] == [pd, md, md]
        assert (out[0] is p) == in_place
        assert norm.device.type == "meta" and norm.dtype == gd
        assert adamw_ops.step_launches() == adamw_ops.norm_launches() == 0

    def test_count_step_sees_one_report_per_leaf(self):
        """The dry-run's counter: AdamW on meta leaves is the kernels'
        reports, one update and one norm per leaf, and no aten op of the
        plain version's."""
        params = {"a": torch.empty(64, 8, device="meta"),
                  "b": [torch.empty(8, device="meta"),
                        torch.empty(3, 3, device="meta")]}
        cfg = AdamWConfig()
        state = adamw_init(params, cfg)
        grads = pytree.tree_map(torch.empty_like, params)
        _, c, _, kernels = analysis.count_step(
            lambda: adamw_update(grads, state, params, cfg, in_place=True))
        n = 64 * 8 + 8 + 9
        assert kernels["adamw_step"]["launches"] == 3
        assert kernels["sum_squares"]["launches"] == 3
        assert kernels["adamw_step"]["bytes"] == 7 * 4 * n + 3 * 12
        assert kernels["adamw_step"]["flops"] == 17 * n
        assert kernels["sum_squares"]["bytes"] == 4 * (n + 3)
        # what is left are the few scalar ops around the leaves
        assert c["bytes accessed"] - kernels["adamw_step"]["bytes"] - \
            kernels["sum_squares"]["bytes"] < 200


# -------------------------------------------------- vs the reference --
def _tree_np(seed: int, scale: float = 1.0) -> dict:
    r = np.random.default_rng(seed)
    shapes = {"w": (16, 8), "b": (8,), "blocks": [{"k": (3, 4, 5)},
                                                  {"k": (2, 7)}]}
    return pytree.tree_map(
        lambda s: (r.standard_normal(s) * scale).astype(np.float32), shapes,
        is_leaf=lambda x: isinstance(x, tuple))


def _by_path(tree) -> dict:
    flat, _ = pytree.tree_flatten_with_path(tree)
    return {pytree.keystr(p): v for p, v in flat}


class TestAgainstReference:
    @pytest.mark.parametrize("kind", ["f32", "bf16_moments", "f64_params"])
    @pytest.mark.parametrize("in_place", [False, True])
    def test_update_matches_jax(self, kind, in_place):
        moments = "bfloat16" if kind == "bf16_moments" else "float32"
        pdt = torch.float64 if kind == "f64_params" else torch.float32
        cfg = AdamWConfig(lr=1e-2, m_dtype=moments, v_dtype=moments,
                          grad_clip=1.0)
        j_cfg = j_opt.AdamWConfig(**dataclasses.asdict(cfg))
        p0 = _tree_np(0)
        # copies: in place, the update must not write into p0's buffers,
        # which jnp.asarray may share
        params = pytree.tree_map(
            lambda a: torch.from_numpy(a.copy()).to(pdt), p0)
        state = adamw_init(params, cfg)
        jp = jax.tree.map(jnp.asarray, p0)
        jstate = j_opt.adamw_init(jp, j_cfg)
        for step in range(3):
            g = _tree_np(10 + step, scale=3.0)
            tg = pytree.tree_map(lambda a: torch.from_numpy(a).to(pdt), g)
            params, state, m = adamw_update(tg, state, params, cfg,
                                            in_place=in_place)
            jp, jstate, jm = j_opt.adamw_update(
                jax.tree.map(jnp.asarray, g), jstate, jp, j_cfg)
            np.testing.assert_allclose(m["grad_norm"].numpy(),
                                       np.asarray(jm["grad_norm"]), **TOL)
            for tree, jtree in ((params, jp), (state["m"], jstate["m"]),
                                (state["v"], jstate["v"])):
                got, want = _by_path(tree), _by_path(jtree)
                assert sorted(got) == sorted(want)
                for k, w in want.items():
                    np.testing.assert_allclose(
                        got[k].double().numpy(),
                        np.asarray(w, np.float32).astype(np.float64),
                        err_msg=k, **TOL)
        assert all(t.dtype == pdt for t in pytree.tree_leaves(params))

    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    def test_norm_matches_jax(self, dtype):
        tree = _tree_np(3)
        got = global_norm(pytree.tree_map(
            lambda a: torch.from_numpy(a).to(dtype), tree))
        want = j_opt.global_norm(jax.tree.map(jnp.asarray, tree))
        assert got.dtype == dtype
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)

    def test_sum_squares_is_the_plain_sum(self):
        x = torch.from_numpy(np.random.default_rng(7).standard_normal(
            (33, 5)).astype(np.float32))
        assert torch.equal(sum_squares(x), x.square().sum())
        assert sum_squares(torch.zeros(0)).item() == 0.0
        f64 = np.sum(x.numpy().astype(np.float64) ** 2)
        assert abs(float(sum_squares(x)) - f64) <= 1e-6 * f64
