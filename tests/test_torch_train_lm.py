"""LM training in the port against the JAX reference on the CPU: the loss
and its gradients (`repro.models.transformer.loss_fn`), gradients through
`chunked_attention`, one `make_train_step` step from the same parameters
and moments, the in-place update, gradient compression, the token
pipeline, the training launcher and the LM configs' `smoke_run`.

Inputs are numpy arrays from fixed seeds handed to both packages; the
reference's parameters cross over through `interop.lm_params`, its AdamW
moments through `interop.adamw_state`. Tolerances: the loss rtol 1e-5;
every gradient leaf rtol 1e-4 / atol 1e-6 (the GNN suite's bounds: f32
sums taken in another order, through a softmax and the logsumexp);
parameters, m and v after a step rtol 1e-5 (atol 1e-7 for values that
land near zero); the donated (in-place) step against new tensors, remat
on against off, and a restart from a checkpoint bitwise.
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st
from torch.utils import _pytree as pytree

from repro.configs import get
from repro.models import layers as R
from repro.models import transformer as RT
from repro.train import grad_compress as ref_gcmp
from repro.train import optimizer as ref_opt
from repro.train import train_loop as ref_loop
from repro.train.data import TokenPipelineConfig as RefTokenConfig
from repro.train.data import token_batch as ref_token_batch
from repro_torch import interop
from repro_torch.configs import (deepseek_7b, granite_moe_3b,
                                 h2o_danube_1_8b, qwen2_5_32b,
                                 qwen3_moe_235b)
from repro_torch.kernels.adamw import ref as adamw_ref
from repro_torch.launch import train as launch_train
from repro_torch.models import layers as P
from repro_torch.models import transformer as PT
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import grad_compress as gcmp
from repro_torch.train.data import TokenPipelineConfig, token_batch
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.train_loop import make_train_step

LOSS = dict(rtol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-6)
STATE = dict(rtol=1e-5, atol=1e-7)
PORT_CFG = {"h2o-danube-1.8b": h2o_danube_1_8b,
            "granite-moe-3b-a800m": granite_moe_3b,
            "deepseek-7b": deepseek_7b, "qwen2.5-32b": qwen2_5_32b,
            "qwen3-moe-235b-a22b": qwen3_moe_235b}


def _configs(arch: str, capacity_factor=None):
    """(reference cfg, port cfg) at smoke size; capacity_factor < 1.25
    makes the MoE drop assignments."""
    ref, port = get(arch).smoke_config(), PORT_CFG[arch].smoke_config()
    if capacity_factor is not None:
        ref = dataclasses.replace(ref, moe=dataclasses.replace(
            ref.moe, capacity_factor=capacity_factor))
        port = dataclasses.replace(port, moe=dataclasses.replace(
            port.moe, capacity_factor=capacity_factor))
    return ref, port


def _ref_params(cfg, seed=0):
    return jax.tree.map(np.asarray, RT.init_params(jax.random.PRNGKey(seed),
                                                   cfg))


def _tokens(vocab: int, b: int, s: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _by_path(tree) -> dict:
    flat, _ = pytree.tree_flatten_with_path(tree)
    return {pytree.keystr(p): v for p, v in flat}


def _ref_by_path(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"".join(f"[{p.key!r}]" for p in path): np.asarray(v)
            for path, v in flat}


def _port_grads(params, tokens, cfg):
    leaves, spec = pytree.tree_flatten(params)
    xs = [p.detach().clone().requires_grad_(True) for p in leaves]
    loss = PT.loss_fn(pytree.tree_unflatten(xs, spec),
                      {"tokens": torch.from_numpy(tokens)}, cfg)
    grads = torch.autograd.grad(loss, xs)
    return loss.detach(), pytree.tree_unflatten(list(grads), spec)


# LM loss_fn: window (danube), dense (deepseek), MoE with drops (granite)
LOSS_CASES = {"danube-window": ("h2o-danube-1.8b", None),
              "deepseek-dense": ("deepseek-7b", None),
              "granite-moe-drops": ("granite-moe-3b-a800m", 0.5)}


class TestLossFn:
    @pytest.mark.parametrize("case", sorted(LOSS_CASES))
    def test_loss_and_every_gradient_leaf(self, case):
        arch, cf = LOSS_CASES[case]
        rcfg, pcfg = _configs(arch, cf)
        ref = _ref_params(rcfg)
        tokens = _tokens(rcfg.vocab, 4, 17, seed=1)
        jl, jg = jax.value_and_grad(RT.loss_fn)(
            jax.tree.map(jnp.asarray, ref), {"tokens": jnp.asarray(tokens)},
            rcfg)
        loss, grads = _port_grads(interop.lm_params(ref, device="cpu"),
                                  tokens, pcfg)
        np.testing.assert_allclose(loss.numpy(), np.asarray(jl), **LOSS)
        want, got = _ref_by_path(jg), _by_path(grads)
        assert sorted(want) == sorted(got)
        for k, w in want.items():
            np.testing.assert_allclose(got[k].numpy(), w, err_msg=k, **GRAD)

    def test_granite_case_drops_assignments(self):
        _, pcfg = _configs("granite-moe-3b-a800m", 0.5)
        params = PT.cast_params(interop.lm_params(_ref_params(
            get("granite-moe-3b-a800m").smoke_config()), device="cpu"),
            pcfg.cdtype)
        stats = {}
        with torch.no_grad():
            PT._trunk(params, torch.from_numpy(
                _tokens(pcfg.vocab, 4, 17, seed=1)[:, :-1]), pcfg,
                stats=stats)
        assert int(stats["dropped"]) > 0

    @pytest.mark.parametrize("arch", ["h2o-danube-1.8b",
                                      "granite-moe-3b-a800m"])
    def test_remat_on_and_off_give_equal_gradients(self, arch):
        _, pcfg = _configs(arch)
        params = interop.lm_params(_ref_params(get(arch).smoke_config()),
                                   device="cpu")
        tokens = _tokens(pcfg.vocab, 2, 17, seed=2)
        on = _port_grads(params, tokens, dataclasses.replace(pcfg,
                                                             remat=True))
        off = _port_grads(params, tokens, dataclasses.replace(pcfg,
                                                              remat=False))
        for a, b in zip(pytree.tree_leaves(on), pytree.tree_leaves(off)):
            assert torch.equal(a, b)

    def test_serve_entry_points_stay_out_of_autograd(self):
        _, pcfg = _configs("h2o-danube-1.8b")
        params = interop.lm_params(_ref_params(
            get("h2o-danube-1.8b").smoke_config()), device="cpu")
        params = pytree.tree_map(lambda t: t.requires_grad_(True), params)
        logits, _ = PT.forward(params, torch.from_numpy(
            _tokens(pcfg.vocab, 1, 6, seed=3)), pcfg)
        assert not logits.requires_grad

    def test_layer_views_share_storage_and_stack_gradients(self):
        stack = {"w": torch.randn(3, 4, 5, requires_grad=True),
                 "moe": {"r": torch.randn(3, 2, requires_grad=True)}}
        views = P.layer_views(stack)
        assert len(views) == 3
        assert views[1]["w"].data_ptr() == stack["w"][1].data_ptr()
        sum(v["w"].sum() * (i + 1) + v["moe"]["r"].sum()
            for i, v in enumerate(views)).backward()
        assert torch.equal(stack["w"].grad[2], torch.full((4, 5), 3.0))
        assert torch.equal(stack["moe"]["r"].grad, torch.ones(3, 2))


# gradients through chunked_attention
ATTN_CASES = {
    "causal": dict(sq=20, sk=20, kw=dict(causal=True, q_chunk=8, k_chunk=8)),
    "window": dict(sq=20, sk=20, kw=dict(causal=True, window=5, q_chunk=8,
                                         k_chunk=4)),
    "q_offset": dict(sq=10, sk=16, kw=dict(causal=True, q_offset=6,
                                           q_chunk=4, k_chunk=8)),
    "no_valid_key": dict(sq=12, sk=12, kw=dict(causal=True, q_offset=-3,
                                               q_chunk=4, k_chunk=4)),
    "full": dict(sq=9, sk=13, kw=dict(causal=False, q_chunk=4, k_chunk=8)),
}


class TestAttentionGradient:
    """Forward (rtol 1e-5 / atol 1e-6, as tests/test_torch_lm.py) and the
    gradients of q, k, v under a random cotangent."""

    @pytest.mark.parametrize("case", sorted(ATTN_CASES))
    def test_grad_matches_reference(self, case):
        c = ATTN_CASES[case]
        rng = np.random.default_rng(sorted(ATTN_CASES).index(case))
        q = rng.standard_normal((2, c["sq"], 4, 8)).astype(np.float32)
        k = rng.standard_normal((2, c["sk"], 2, 8)).astype(np.float32)
        v = rng.standard_normal((2, c["sk"], 2, 8)).astype(np.float32)
        ct = rng.standard_normal((2, c["sq"], 4, 8)).astype(np.float32)

        def j_loss(q, k, v):
            return jnp.sum(R.chunked_attention(q, k, v, **c["kw"]) * ct)
        jgrads = jax.grad(j_loss, argnums=(0, 1, 2))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
        out = P.chunked_attention(*ts, **c["kw"])
        np.testing.assert_allclose(
            out.detach().numpy(), np.asarray(R.chunked_attention(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **c["kw"])),
            rtol=1e-5, atol=1e-6)
        (out * torch.from_numpy(ct)).sum().backward()
        for t, j, name in zip(ts, jgrads, "qkv"):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(j),
                                       err_msg=name, **GRAD)


# one step, microbatches, the in-place update
def _ref_state(ref, seed: int, step: int = 3):
    """An AdamW state as after a few steps: m ~ N(0, 1e-4), v ~ 1e-4 |N|."""
    rng = np.random.default_rng(seed)
    m = jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 1e-2)
                     .astype(np.float32), ref)
    v = jax.tree.map(lambda p: (np.abs(rng.standard_normal(p.shape)) * 1e-4)
                     .astype(np.float32), ref)
    return {"step": np.int32(step), "m": m, "v": v}


class TestTrainStep:
    @pytest.mark.parametrize("arch", ["h2o-danube-1.8b",
                                      "granite-moe-3b-a800m"])
    def test_two_microbatches_match_reference(self, arch):
        rcfg, pcfg = _configs(arch)
        ref = _ref_params(rcfg)
        state = _ref_state(ref, seed=4)
        tokens = _tokens(rcfg.vocab, 4, 13, seed=5)
        j_cfg = ref_opt.AdamWConfig(lr=1e-3)
        j_step = ref_loop.make_train_step(partial(RT.loss_fn, cfg=rcfg),
                                          j_cfg, num_microbatches=2,
                                          donate=False)
        jp, js, jm = j_step(jax.tree.map(jnp.asarray, ref),
                            jax.tree.map(jnp.asarray, state),
                            {"tokens": jnp.asarray(tokens)})
        step = make_train_step(partial(PT.loss_fn, cfg=pcfg),
                               AdamWConfig(lr=1e-3), num_microbatches=2,
                               donate=True)
        p, s, m = step(interop.lm_params(ref, device="cpu"),
                       interop.adamw_state(state, device="cpu"),
                       {"tokens": torch.from_numpy(tokens)})
        np.testing.assert_allclose(m["loss"].numpy(), np.asarray(jm["loss"]),
                                   **LOSS)
        np.testing.assert_allclose(m["grad_norm"].numpy(),
                                   np.asarray(jm["grad_norm"]), **LOSS)
        assert int(s["step"]) == int(js["step"]) == 4
        for got, want in ((p, jp), (s["m"], js["m"]), (s["v"], js["v"])):
            got, want = _by_path(got), _ref_by_path(want)
            assert sorted(got) == sorted(want)
            for k, w in want.items():
                np.testing.assert_allclose(got[k].numpy(), w, err_msg=k,
                                           **STATE)

    @pytest.mark.parametrize("micro", [1, 2])
    def test_donated_step_is_bitwise_the_new_tensor_step(self, micro,
                                                         monkeypatch):
        """In place (slice by slice; slices forced small here) against new
        tensors, and against the update of each leaf at once."""
        _, pcfg = _configs("granite-moe-3b-a800m")
        ref = _ref_params(get("granite-moe-3b-a800m").smoke_config())
        state = _ref_state(ref, seed=6)
        batch = {"tokens": torch.from_numpy(
            _tokens(pcfg.vocab, 4, 11, seed=7))}

        def run(donate: bool, slice_elems: int):
            monkeypatch.setattr(adamw_ref, "_SLICE_ELEMS", slice_elems)
            params = interop.lm_params(ref, device="cpu")
            opt = interop.adamw_state(state, device="cpu")
            step = make_train_step(partial(PT.loss_fn, cfg=pcfg),
                                   AdamWConfig(lr=1e-3),
                                   num_microbatches=micro, donate=donate)
            out = step(params, opt, batch)
            if donate:
                assert all(a is b for a, b in zip(
                    pytree.tree_leaves((params, opt)),
                    pytree.tree_leaves(out[:2])))
            return pytree.tree_leaves(out)
        base = run(False, 1 << 26)
        for donate, elems in ((True, 1 << 26), (True, 100), (False, 7)):
            got = run(donate, elems)
            assert all(torch.equal(a, b) for a, b in zip(base, got))

    def test_slices_follow_the_leading_axis(self):
        t = torch.zeros(6, 5, 4)
        old = adamw_ref._SLICE_ELEMS
        try:
            adamw_ref._SLICE_ELEMS = 45
            parts = adamw_ref._slices(t)
            assert [p.shape[0] for p in parts] == [2, 2, 2]
            assert all(p.data_ptr() == t[2 * i].data_ptr()
                       for i, p in enumerate(parts))
            adamw_ref._SLICE_ELEMS = 10
            assert len(adamw_ref._slices(t)) == 6
            assert len(adamw_ref._slices(torch.zeros(()))) == 1
        finally:
            adamw_ref._SLICE_ELEMS = old


# gradient compression (tests/test_train_substrate.py TestGradCompression)
class TestGradCompression:
    @given(st.integers(min_value=1, max_value=4096),
           st.integers(min_value=0, max_value=10_000))
    @settings(max_examples=25, deadline=None)
    def test_property_quantization_error_bounded_and_codes_equal(self, n,
                                                                 seed):
        g = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
        q, scale = gcmp.compress(torch.from_numpy(g))
        err = (gcmp.decompress(q, scale) - torch.from_numpy(g)).abs()
        assert float(err.max()) <= float(scale) * 0.5 + 1e-6
        jq, js = ref_gcmp.compress(jnp.asarray(g))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert float(scale) == float(js)

    @pytest.mark.parametrize("scale", [1e-3, 1.0, 1e4])
    def test_codes_equal_reference_with_ties(self, scale):
        g = (np.random.default_rng(11).standard_normal(500) * scale).astype(
            np.float32)
        g[:4] = [0.0, -0.0, 127.5 * scale, -63.5 * scale]   # round-half cases
        q, s = gcmp.compress(torch.from_numpy(g))
        jq, js = ref_gcmp.compress(jnp.asarray(g))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        ghat, err = gcmp.ef_compress(torch.from_numpy(g), torch.zeros(500))
        jghat, jerr = ref_gcmp.ef_compress(jnp.asarray(g), jnp.zeros(500))
        np.testing.assert_array_equal(ghat.numpy(), np.asarray(jghat))
        np.testing.assert_array_equal(err.numpy(), np.asarray(jerr))

    def test_error_feedback_removes_bias(self):
        """Sum of EF-compressed gradients tracks the true sum (bias-free)."""
        rng = np.random.default_rng(0)
        err = torch.zeros(256)
        total_true = torch.zeros(256)
        total_hat = torch.zeros(256)
        for _ in range(60):
            g = torch.from_numpy(rng.standard_normal(256).astype(
                np.float32)) * 1e-3
            g_hat, err = gcmp.ef_compress(g, err)
            total_true += g
            total_hat += g_hat
        resid = float((total_true - (total_hat + err)).abs().max())
        assert resid < 1e-5  # invariant: sum(g) == sum(g_hat) + err

    def test_tree_api(self):
        params = {"a": torch.ones(8), "b": [torch.ones(3, 3)]}
        err = gcmp.init_error_tree(params)
        g_hat, err2 = gcmp.ef_compress_tree(params, err)
        assert pytree.tree_structure(g_hat) == pytree.tree_structure(params)
        assert pytree.tree_structure(err2) == pytree.tree_structure(params)
        assert all(e.dtype == torch.float32 and not e.any()
                   for e in pytree.tree_leaves(err))


# the token pipeline (TestDataPipelines)
class TestTokenBatch:
    def test_token_batch_deterministic_and_resumable(self):
        cfg = TokenPipelineConfig(vocab=1000, seq_len=16, global_batch=4,
                                  seed=3)
        a = token_batch(cfg, step=17, device="cpu")
        b = token_batch(cfg, step=17, device="cpu")   # "resume" at 17
        assert a["tokens"].shape == (4, 17)
        assert a["tokens"].dtype == torch.int32
        assert torch.equal(a["tokens"], b["tokens"])
        c = token_batch(cfg, step=18, device="cpu")
        assert not torch.equal(a["tokens"], c["tokens"])
        other = token_batch(dataclasses.replace(cfg, seed=4), step=17,
                            device="cpu")
        assert not torch.equal(a["tokens"], other["tokens"])

    def test_ids_in_range_with_the_power_law_mean(self):
        cfg = TokenPipelineConfig(vocab=1000, seq_len=511, global_batch=64)
        toks = token_batch(cfg, 0, device="cpu")["tokens"]
        assert int(toks.min()) >= 0 and int(toks.max()) < 1000
        # E[floor(V u^3)] = V / 4 - 1/2
        assert abs(float(toks.double().mean()) - 249.5) < 5.0
        ref = np.asarray(ref_token_batch(
            RefTokenConfig(vocab=1000, seq_len=511, global_batch=64),
            0)["tokens"])
        assert abs(float(toks.double().mean()) - ref.mean()) < 8.0

    def test_default_device_is_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            token_batch(TokenPipelineConfig(10, 4, 2), 0)


# end to end (TestEndToEnd)
class TestEndToEnd:
    def test_loss_decreases_tiny_lm(self):
        cfg = deepseek_7b.smoke_config()
        params = PT.init_params(torch.Generator().manual_seed(0), cfg)
        opt_cfg = AdamWConfig(lr=3e-3, weight_decay=0.0)
        opt = adamw_init(params, opt_cfg)
        step = make_train_step(partial(PT.loss_fn, cfg=cfg), opt_cfg,
                               num_microbatches=2, donate=False)
        dcfg = TokenPipelineConfig(vocab=cfg.vocab, seq_len=16,
                                   global_batch=8)
        losses = []
        for i in range(30):
            batch = token_batch(dcfg, i % 2, device="cpu")  # memorizable
            params, opt, metrics = step(params, opt, batch)
            losses.append(float(metrics["loss"]))
        assert losses[-1] < losses[0] * 0.8, losses[:3] + losses[-3:]

    def test_checkpoint_restart_bitexact(self, tmp_path):
        cfg = deepseek_7b.smoke_config()
        params = PT.init_params(torch.Generator().manual_seed(1), cfg)
        opt_cfg = AdamWConfig(lr=1e-3)
        opt = adamw_init(params, opt_cfg)
        step = make_train_step(partial(PT.loss_fn, cfg=cfg), opt_cfg,
                               num_microbatches=1, donate=False)
        dcfg = TokenPipelineConfig(vocab=cfg.vocab, seq_len=12,
                                   global_batch=4)
        for i in range(2):
            params, opt, _ = step(params, opt, token_batch(dcfg, i, "cpu"))
        ckpt.save(tmp_path, 2, {"params": params, "opt": opt},
                  metadata={"data_step": 2})
        params3, _, _ = step(params, opt, token_batch(dcfg, 2, "cpu"))
        restored, meta = ckpt.restore(tmp_path, {"params": params,
                                                 "opt": opt})
        rp3, _, _ = step(restored["params"], restored["opt"],
                         token_batch(dcfg, meta["data_step"], "cpu"))
        for a, b in zip(pytree.tree_leaves(params3),
                        pytree.tree_leaves(rp3)):
            assert torch.equal(a, b)


# the launcher (tests/test_launch_cli.py)
class TestTrainCli:
    def test_train_cli_runs_and_resumes(self, tmp_path, capsys):
        args = ["--arch", "deepseek-7b", "--smoke", "--steps", "4",
                "--global-batch", "4", "--seq-len", "12",
                "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
                "--device", "cpu"]
        out = launch_train.main(args)
        first = ckpt.latest_step(tmp_path)
        assert first == 3 and out["start_step"] == 0
        assert all(np.isfinite(out["losses"]))
        out2 = launch_train.main(["--arch", "deepseek-7b", "--smoke",
                                  "--steps", "2", "--global-batch", "4",
                                  "--seq-len", "12", "--ckpt-dir",
                                  str(tmp_path), "--device", "cpu"])
        assert "resumed from step 3" in capsys.readouterr().out
        assert out2["start_step"] == 4 and ckpt.latest_step(tmp_path) == 5
        assert len(list(tmp_path.glob("step_*"))) == 3   # keeps 3

    def test_resumed_run_continues_the_same_run(self, tmp_path):
        """4 steps in one run equal 2 + 2 across a restart, bitwise."""
        base = ["--arch", "h2o-danube-1.8b", "--smoke", "--global-batch",
                "2", "--seq-len", "10", "--device", "cpu"]
        whole = launch_train.main(base + ["--steps", "4"])
        launch_train.main(base + ["--steps", "2", "--ckpt-dir",
                                  str(tmp_path)])
        resumed = launch_train.main(base + ["--steps", "2", "--ckpt-dir",
                                            str(tmp_path)])
        assert resumed["losses"] == whole["losses"][2:]
        for a, b in zip(pytree.tree_leaves(whole["params"]),
                        pytree.tree_leaves(resumed["params"])):
            assert torch.equal(a, b)

    @pytest.mark.parametrize("arch", ["pna", "meshgraphnet", "dlrm-rm2",
                                      "pagerank-serve"])
    def test_train_cli_rejects_gnn(self, arch):
        with pytest.raises(SystemExit, match="drives LM archs"):
            launch_train.main(["--arch", arch, "--smoke", "--device", "cpu"])

    def test_default_device_is_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            launch_train.main(["--arch", "deepseek-7b", "--smoke",
                               "--steps", "1"])


# the LM configs' smoke_run (tests/test_archs_smoke.py)
class TestSmokeRun:
    @pytest.mark.parametrize("arch", sorted(PORT_CFG))
    def test_smoke_step_finite(self, arch):
        out = PORT_CFG[arch].smoke_run(seed=0, device="cpu")
        assert sorted(out) == ["grad_norm", "logits", "loss"]
        for name, val in out.items():
            assert bool(torch.isfinite(val).all()), (arch, name)

    @pytest.mark.parametrize("arch", sorted(PORT_CFG))
    def test_smoke_deterministic(self, arch):
        a = PORT_CFG[arch].smoke_run(seed=0, device="cpu")
        b = PORT_CFG[arch].smoke_run(seed=0, device="cpu")
        c = PORT_CFG[arch].smoke_run(seed=1, device="cpu")
        for k in a:
            assert torch.equal(a[k], b[k]), (arch, k)
        assert not torch.equal(a["logits"], c["logits"])
