"""The port's LM layers, MoE and transformer against the JAX reference on
the CPU (`repro.models.{layers,moe,transformer}`).

Inputs come from numpy generators with fixed seeds; the reference's
parameters cross over through `interop.lm_params`. Tolerances:
  * float32: rtol 1e-5 / atol 1e-6 for layers and `moe_apply`, rtol 1e-5 /
    atol 1e-5 for model logits and KV caches;
  * bfloat16: inputs rounded to bf16 on both sides and compared after the
    same casts at atol 2e-2 (elementwise layers: rtol 2e-2; a bf16 value
    has a unit roundoff of 2^-8 = 3.9e-3 and the two packages may round a
    different intermediate), model logits at 5e-2 of max |logit| with
    greedy tokens equal wherever the reference's top-2 margin exceeds
    twice that.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get
from repro.configs import lm_common as ref_lm_common
from repro.models import layers as R
from repro.models import moe as RM
from repro.models import transformer as RT
from repro_torch import interop
from repro_torch.configs import lm_common
from repro_torch.models import layers as P
from repro_torch.models import moe as PM
from repro_torch.models import transformer as PT

ARCHS = {"h2o-danube-1.8b": "h2o_danube_1_8b",
         "granite-moe-3b-a800m": "granite_moe_3b",
         "deepseek-7b": "deepseek_7b",
         "qwen2.5-32b": "qwen2_5_32b",
         "qwen3-moe-235b-a22b": "qwen3_moe_235b"}
F32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=2e-2, atol=2e-2)
LOGIT_BF16 = 5e-2          # bf16 model logits, share of max |logit|


def port_mod(arch: str):
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")


def t(a, dtype=None) -> torch.Tensor:
    x = torch.from_numpy(np.array(a, dtype=np.float32 if dtype else None))
    return x.to(dtype) if dtype else x


def bf16_pair(a: np.ndarray):
    """(jax bf16 array, torch bf16 tensor) of the same rounded values."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, t(np.asarray(j.astype(jnp.float32)), torch.bfloat16)


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def assert_close(port, ref, tol):
    np.testing.assert_allclose(as_np(port), as_np(ref), **tol)


# ----------------------------------------------------------------- layers --

class TestNormsAndRope:
    def test_rms_norm_f32(self):
        rng = np.random.default_rng(0)
        x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3
        g = rng.standard_normal(64).astype(np.float32)
        assert_close(P.rms_norm(t(x), t(g)), R.rms_norm(x, g), F32)

    def test_rms_norm_bf16_rounds_before_gamma(self):
        rng = np.random.default_rng(1)
        xj, xt = bf16_pair(rng.standard_normal((4, 48)) * 3)
        gj, gt = bf16_pair(rng.standard_normal(48))
        out = P.rms_norm(xt, gt)
        assert out.dtype == torch.bfloat16
        assert_close(out, R.rms_norm(xj, gj), BF16)

    @pytest.mark.parametrize("start", [0, 100, 8_000])
    def test_apply_rope_f32(self, start):
        rng = np.random.default_rng(start)
        x = rng.standard_normal((2, 6, 3, 16)).astype(np.float32)
        pos = (start + np.arange(6)[None, :] + np.array([[0], [7]])).astype(
            np.int32)
        for theta in (1e4, 1e6):
            assert_close(P.apply_rope(t(x), t(pos), theta),
                         R.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                      theta), F32)

    def test_apply_rope_bf16(self):
        rng = np.random.default_rng(2)
        xj, xt = bf16_pair(rng.standard_normal((2, 5, 4, 16)))
        pos = np.arange(5, dtype=np.int32)[None, :]
        out = P.apply_rope(xt, t(pos), 1e4)
        assert out.dtype == torch.bfloat16
        assert_close(out, R.apply_rope(xj, jnp.asarray(pos), 1e4), BF16)

    def test_embed_init(self):
        w = P.embed_init(torch.Generator().manual_seed(0), 512, 64)
        assert w.shape == (512, 64) and w.dtype == torch.float32
        assert abs(float(w.std()) - 0.02) < 2e-3


def _qkv(rng, b, sq, sk, hkv, groups, dh=8):
    q = rng.standard_normal((b, sq, hkv * groups, dh)).astype(np.float32)
    k = rng.standard_normal((b, sk, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((b, sk, hkv, dh)).astype(np.float32)
    return q, k, v


class TestChunkedAttention:
    """Chunks of 4 (q) and 4 (k): Sq, Sk of 13 and 19 pad both; fully
    masked tiles are skipped by the port, scanned by the reference."""

    @pytest.mark.parametrize("causal", [True, False])
    @pytest.mark.parametrize("window", [None, 5])
    @pytest.mark.parametrize("sq,sk,q_offset,groups", [
        (13, 13, 0, 1), (7, 19, 12, 2), (16, 16, 0, 4), (13, 13, 0, 4),
        (5, 19, 3, 1)])
    def test_vs_reference_f32(self, causal, window, sq, sk, q_offset,
                              groups):
        rng = np.random.default_rng(sq * 31 + sk + groups)
        q, k, v = _qkv(rng, 2, sq, sk, 2, groups)
        kw = dict(causal=causal, window=window, q_chunk=4, k_chunk=4,
                  q_offset=q_offset)
        assert_close(P.chunked_attention(t(q), t(k), t(v), **kw),
                     R.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), **kw), F32)

    def test_query_without_valid_key_matches(self):
        """q_offset puts the last queries past every key's window: the
        port then scans every tile, as the reference does."""
        rng = np.random.default_rng(3)
        q, k, v = _qkv(rng, 1, 6, 8, 1, 2)
        kw = dict(causal=True, window=3, q_chunk=4, k_chunk=4, q_offset=8)
        assert_close(P.chunked_attention(t(q), t(k), t(v), **kw),
                     R.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), **kw), F32)

    @pytest.mark.parametrize("window", [None, 6])
    def test_vs_reference_bf16(self, window):
        rng = np.random.default_rng(4)
        q, k, v = _qkv(rng, 2, 21, 21, 2, 2, dh=16)
        (qj, qt), (kj, kt), (vj, vt) = (bf16_pair(a) for a in (q, k, v))
        kw = dict(causal=True, window=window, q_chunk=8, k_chunk=8)
        out = P.chunked_attention(qt, kt, vt, **kw)
        assert out.dtype == torch.bfloat16
        assert_close(out, R.chunked_attention(qj, kj, vj, **kw), BF16)


class TestDecodeAttention:
    @pytest.mark.parametrize("window", [None, 3])
    @pytest.mark.parametrize("groups", [1, 2, 4])
    def test_per_slot_lengths_f32(self, window, groups):
        rng = np.random.default_rng(groups)
        q, k, v = _qkv(rng, 4, 1, 12, 2, groups, dh=16)
        clen = np.array([1, 5, 9, 12], np.int32)
        assert_close(P.decode_attention(t(q), t(k), t(v), t(clen), window),
                     R.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), jnp.asarray(clen),
                                        window), F32)

    def test_scalar_length(self):
        rng = np.random.default_rng(5)
        q, k, v = _qkv(rng, 2, 1, 10, 2, 2)
        assert_close(P.decode_attention(t(q), t(k), t(v), 7, None),
                     R.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), 7, None), F32)

    def test_bf16(self):
        rng = np.random.default_rng(6)
        q, k, v = _qkv(rng, 3, 1, 24, 2, 4, dh=16)
        (qj, qt), (kj, kt), (vj, vt) = (bf16_pair(a) for a in (q, k, v))
        clen = np.array([3, 17, 24], np.int32)
        out = P.decode_attention(qt, kt, vt, t(clen), 8)
        assert out.dtype == torch.bfloat16
        assert_close(out, R.decode_attention(qj, kj, vj, jnp.asarray(clen),
                                             8), BF16)


# -------------------------------------------------------------------- moe --

def _moe_case(seed: int, t_tokens: int, n_experts=8, top_k=2, d=16, f=12):
    cfg_r = RM.MoEConfig(n_experts=n_experts, top_k=top_k)
    cfg_p = PM.MoEConfig(n_experts=n_experts, top_k=top_k)
    params = jax.tree.map(np.asarray, RM.moe_init(jax.random.PRNGKey(seed), d,
                                                  f, cfg_r))
    x = np.random.default_rng(seed).standard_normal(
        (t_tokens, d)).astype(np.float32)
    return cfg_r, cfg_p, params, x


def _ref_dropped(params, x, cfg, cap) -> int:
    """Assignments past capacity, from the reference's own routing."""
    probs = jax.nn.softmax(jnp.asarray(x) @ params["router"], axis=-1)
    _, eidx = jax.lax.top_k(probs, cfg.top_k)
    flat = np.asarray(eidx).reshape(-1)
    seen = np.zeros(cfg.n_experts, np.int64)
    dropped = 0
    for e in flat:
        dropped += seen[e] >= cap
        seen[e] += 1
    return int(dropped)


class TestMoE:
    def test_capacity_and_config(self):
        for n in (1, 32, 100, 4096):
            for cfg in (RM.MoEConfig(40, 8), RM.MoEConfig(8, 2, 2.0)):
                pc = PM.MoEConfig(cfg.n_experts, cfg.top_k,
                                  cfg.capacity_factor)
                assert PM.moe_capacity(pc, n) == RM.moe_capacity(cfg, n)
        assert PM.MoEConfig(8, 2).impl == "dense"
        assert PM.moe_capacity(PM.MoEConfig(40, 8), 32) == 8

    def test_no_drops_f32(self):
        cfg_r, cfg_p, params, x = _moe_case(0, 10)
        y_r, aux_r = RM.moe_apply(params, jnp.asarray(x), cfg_r)
        stats = {}
        y_p, aux_p = PM.moe_apply(interop.lm_params(params, device="cpu"),
                                  t(x), cfg_p, stats=stats)
        assert_close(y_p, y_r, F32)
        assert float(aux_p) == pytest.approx(float(aux_r), rel=1e-5)
        assert int(stats["dropped"]) == 0

    @pytest.mark.parametrize("cap", [8, 16])
    def test_capacity_drops_same_set(self, cap):
        """64 tokens x top-2 over 8 experts at capacity 8 or 16: many
        assignments drop; y equal at f32 means the same ones dropped."""
        cfg_r, cfg_p, params, x = _moe_case(1, 64)
        y_r, aux_r = RM.moe_apply(params, jnp.asarray(x), cfg_r, capacity=cap)
        stats = {}
        y_p, aux_p = PM.moe_apply(interop.lm_params(params, device="cpu"),
                                  t(x), cfg_p, capacity=cap, stats=stats)
        want = _ref_dropped(params, x, cfg_r, cap)
        assert want > 0
        assert int(stats["dropped"]) == want
        assert_close(y_p, y_r, F32)
        assert float(aux_p) == pytest.approx(float(aux_r), rel=1e-5)

    def test_router_rounded_to_bf16_by_cast(self):
        """_cast rounds the f32 router to bf16; routing then runs in f32
        over the rounded weights, on both sides."""
        cfg_r, cfg_p, params, x = _moe_case(2, 24)
        ref_cast = RT._cast({"moe": params}, jnp.bfloat16)["moe"]
        port_cast = PT.cast_params(
            {"moe": interop.lm_params(params, device="cpu")},
            torch.bfloat16)["moe"]
        assert port_cast["router"].dtype == torch.bfloat16
        np.testing.assert_array_equal(as_np(port_cast["router"]),
                                      as_np(ref_cast["router"]))
        mixed_r = dict(params, router=ref_cast["router"])
        mixed_p = dict(interop.lm_params(params, device="cpu"),
                       router=port_cast["router"])
        y_r, aux_r = RM.moe_apply(mixed_r, jnp.asarray(x), cfg_r)
        y_p, aux_p = PM.moe_apply(mixed_p, t(x), cfg_p)
        assert_close(y_p, y_r, F32)
        assert float(aux_p) == pytest.approx(float(aux_r), rel=1e-5)

    def test_bf16_rows(self):
        cfg_r, cfg_p, params, x = _moe_case(3, 20)
        ref_cast = RT._cast(params, jnp.bfloat16)
        port_cast = PT.cast_params(interop.lm_params(params, device="cpu"),
                                   torch.bfloat16)
        xj, xt = bf16_pair(x)
        y_r, _ = RM.moe_apply(ref_cast, xj, cfg_r)
        y_p, _ = PM.moe_apply(port_cast, xt, cfg_p)
        assert y_p.dtype == torch.bfloat16
        assert_close(y_p, y_r, BF16)


# ------------------------------------------------------------ transformer --

@pytest.fixture(scope="module")
def models():
    """{arch: (ref cfg, port cfg, ref params, port params)} at smoke size."""
    out = {}
    for arch in ARCHS:
        cfg = get(arch).smoke_config()
        params = jax.tree.map(np.asarray,
                              RT.init_params(jax.random.PRNGKey(0), cfg))
        out[arch] = (cfg, port_mod(arch).smoke_config(), params,
                     interop.lm_params(params, device="cpu"))
    return out


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(
        np.int32)


LOGITS = dict(rtol=1e-5, atol=1e-5)


class TestTransformer:
    @pytest.mark.parametrize("arch", list(ARCHS))
    def test_config_field_for_field(self, arch):
        for which in ("full_config", "smoke_config"):
            r = getattr(get(arch), which)()
            p = getattr(port_mod(arch), which)()
            assert dataclasses.asdict(p) == dataclasses.asdict(r)
            assert (p.head_dim, p.vocab_padded, p.n_params(),
                    p.n_active_params()) == (r.head_dim, r.vocab_padded,
                                             r.n_params(),
                                             r.n_active_params())
        assert port_mod(arch).NAME == get(arch).NAME
        assert port_mod(arch).FAMILY == "lm"

    @pytest.mark.parametrize("arch", list(ARCHS))
    def test_flop_counts(self, arch):
        r, p = get(arch).full_config(), port_mod(arch).full_config()
        assert lm_common.LM_SHAPES == ref_lm_common.LM_SHAPES
        for b, s in ((1, 4096), (32, 32768), (128, 32768), (1, 524288)):
            assert lm_common.lm_attn_flops(p, b, s) == \
                ref_lm_common.lm_attn_flops(r, b, s)
            assert lm_common.lm_decode_flops(p, b, s) == \
                ref_lm_common.lm_decode_flops(r, b, s)
            assert lm_common.lm_train_flops(p, b * s, b, s) == \
                ref_lm_common.lm_train_flops(r, b * s, b, s)

    @pytest.mark.parametrize("arch", list(ARCHS))
    def test_forward_prefill_decode_f32(self, models, arch):
        cfg, pcfg, params, pp = models[arch]
        toks = _tokens(cfg, 2, 13, 1)
        r_logits, r_aux = RT.forward(params, jnp.asarray(toks), cfg)
        p_logits, p_aux = PT.forward(pp, t(toks).long(), pcfg)
        assert p_logits.shape == (2, 13, cfg.vocab_padded)
        assert_close(p_logits, r_logits, LOGITS)
        assert float(p_aux) == pytest.approx(float(r_aux), rel=1e-5,
                                             abs=1e-6)
        r_last, (rk, rv) = RT.prefill(params, jnp.asarray(toks), cfg,
                                      pad_to=20)
        p_last, (pk, pv) = PT.prefill(pp, t(toks).long(), pcfg, pad_to=20)
        assert_close(p_last, r_last, LOGITS)
        assert_close(pk, rk, LOGITS)
        assert_close(pv, rv, LOGITS)
        nxt = np.argmax(np.asarray(r_last), -1)[:, None].astype(np.int32)
        assert (p_last.argmax(-1).numpy() == nxt[:, 0]).all()
        r_d, (rk2, rv2) = RT.decode_step(params, jnp.asarray(nxt), (rk, rv),
                                         jnp.int32(13), cfg)
        p_d, (pk2, pv2) = PT.decode_step(pp, t(nxt).long(), (pk, pv), 13,
                                         pcfg)
        assert pk2 is pk                           # written in place
        assert_close(p_d, r_d, LOGITS)
        assert_close(pk2, rk2, LOGITS)
        assert_close(pv2, rv2, LOGITS)

    def test_forward_return_kv(self, models):
        cfg, pcfg, params, pp = models["qwen2.5-32b"]
        toks = _tokens(cfg, 1, 9, 2)
        _, _, (rk, rv) = RT.forward(params, jnp.asarray(toks), cfg,
                                    return_kv=True)
        _, _, (pk, pv) = PT.forward(pp, t(toks).long(), pcfg,
                                    return_kv=True)
        assert_close(pk, rk, LOGITS)
        assert_close(pv, rv, LOGITS)

    @pytest.mark.parametrize("cache_len", [18, 19, 25])
    def test_decode_write_offset_clamps(self, models, cache_len):
        """dynamic_update_slice clamps the write to S - 1; positions and
        the valid length stay unclamped."""
        cfg, pcfg, params, pp = models["h2o-danube-1.8b"]
        toks = _tokens(cfg, 2, 13, 3)
        _, (rk, rv) = RT.prefill(params, jnp.asarray(toks), cfg, pad_to=19)
        _, (pk, pv) = PT.prefill(pp, t(toks).long(), pcfg, pad_to=19)
        tok = np.array([[5], [9]], np.int32)
        r_d, (rk2, _) = RT.decode_step(params, jnp.asarray(tok), (rk, rv),
                                       jnp.int32(cache_len), cfg)
        p_d, (pk2, _) = PT.decode_step(pp, t(tok).long(), (pk, pv),
                                       cache_len, pcfg)
        assert_close(p_d, r_d, LOGITS)
        assert_close(pk2, rk2, LOGITS)

    @pytest.mark.parametrize("arch", ["h2o-danube-1.8b",
                                      "granite-moe-3b-a800m"])
    def test_bf16_logits_and_greedy(self, models, arch):
        cfg, pcfg, params, pp = models[arch]
        cfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
        pcfg = dataclasses.replace(pcfg, compute_dtype="bfloat16")
        toks = _tokens(cfg, 3, 17, 4)
        r = np.asarray(RT.forward(params, jnp.asarray(toks), cfg)[0])
        p = PT.forward(pp, t(toks).long(), pcfg)[0].numpy()
        scale = np.abs(r).max()
        assert np.abs(p - r).max() <= LOGIT_BF16 * scale
        top2 = np.sort(r, axis=-1)[..., -2:]
        sure = (top2[..., 1] - top2[..., 0]) > 2 * LOGIT_BF16 * scale
        assert sure.sum() > 0
        np.testing.assert_array_equal(p.argmax(-1)[sure], r.argmax(-1)[sure])

    def test_padding_rows_take_part_in_argmax(self, models):
        """Logits span the padded vocabulary, as the reference's do."""
        cfg, pcfg, params, pp = models["granite-moe-3b-a800m"]
        narrow = dataclasses.replace(pcfg, vocab=200)
        logits, _ = PT.forward(pp, t(_tokens(narrow, 1, 4, 5)).long(),
                               narrow)
        assert narrow.vocab_padded == 256
        assert logits.shape[-1] == 256

    def test_init_params_tree_matches_reference(self):
        for arch in ("granite-moe-3b-a800m", "qwen2.5-32b"):
            cfg = get(arch).smoke_config()
            ref = jax.tree.map(lambda a: tuple(a.shape),
                               RT.init_params(jax.random.PRNGKey(0), cfg))
            port = PT.init_params(torch.Generator().manual_seed(0),
                                  port_mod(arch).smoke_config())
            got = jax.tree.map(lambda a: tuple(a.shape), port)
            assert got == ref
