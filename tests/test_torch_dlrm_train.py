"""DLRM-RM2 training in the port against the JAX reference on the CPU:
the `embedding_bag` autograd function (its plain backward, an
`index_add_`, against `jax.grad` of the reference's `embedding_bag_ref`),
`dlrm.loss_fn` and its gradients, one AdamW step through
`make_train_step`, and `configs/dlrm_rm2.smoke_run`.

Inputs are numpy arrays from fixed seeds handed to both packages; the
reference's parameters cross over through `interop.dlrm_params`, its AdamW
state through `interop.adamw_state`. Tolerances: lookups and their
gradients rtol 1e-5 / atol 1e-6 (f32 sums of a few terms in another
order); the loss rtol 1e-5; every gradient leaf rtol 1e-4 / atol 1e-6 (the
GNN suite's bounds); parameters, m and v after a step rtol 1e-5 / atol
1e-7. Rows no id reads have a gradient of exactly zero.
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.kernels.embedding_bag.ref import embedding_bag_ref as j_eb_ref
from repro.models.recsys import dlrm as j_dlrm
from repro.train import optimizer as j_opt
from repro.train import train_loop as j_loop
from repro_torch import interop
from repro_torch.configs import dlrm_rm2 as cfgs
from repro_torch.kernels.embedding_bag import ops as eb_ops
from repro_torch.kernels.embedding_bag.ops import (embedding_bag,
                                                   embedding_bag_backward)
from repro_torch.kernels.embedding_bag.ref import embedding_bag_backward_ref
from repro_torch.models.recsys import dlrm
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.train_loop import make_train_step

LOOKUP = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
STATE = dict(rtol=1e-5, atol=1e-7)


def _ids(n_bags: int, bag: int, vocab: int, seed: int) -> np.ndarray:
    """ids with duplicates inside bags and across bags: drawn from the
    first third of the table, so most rows are never read."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, max(1, vocab // 3), (n_bags, bag)).astype(np.int32)
    if bag > 1:
        ids[0, 1] = ids[0, 0]                  # a duplicate inside a bag
    ids[-1, 0] = ids[0, 0]                     # and one across bags
    return ids


class TestEmbeddingBagGradient:
    @pytest.mark.parametrize("bag", [1, 3])
    @pytest.mark.parametrize("weighted", [False, True])
    def test_plain_backward_matches_jax_grad(self, bag, weighted):
        rng = np.random.default_rng(bag + 10 * weighted)
        v, d, b = 40, 6, 9
        table = rng.standard_normal((v, d)).astype(np.float32)
        ids = _ids(b, bag, v, seed=bag)
        w = rng.standard_normal((b, bag)).astype(np.float32) if weighted \
            else np.ones((b, bag), np.float32)
        ct = rng.standard_normal((b, d)).astype(np.float32)

        def j_loss(table, w):
            return jnp.sum(j_eb_ref(jnp.asarray(ids), table, w) * ct)
        jt, jw = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(table),
                                                  jnp.asarray(w))
        tt = torch.from_numpy(table).requires_grad_(True)
        tw = torch.from_numpy(w).requires_grad_(weighted)
        out = embedding_bag(torch.from_numpy(ids), tt,
                            tw if weighted else None)
        np.testing.assert_allclose(
            out.detach().numpy(),
            np.asarray(j_eb_ref(jnp.asarray(ids), jnp.asarray(table),
                                jnp.asarray(w))), **LOOKUP)
        (out * torch.from_numpy(ct)).sum().backward()
        np.testing.assert_allclose(tt.grad.numpy(), np.asarray(jt), **LOOKUP)
        unread = np.setdiff1d(np.arange(v), ids)
        assert len(unread) > 0 and not tt.grad[unread].any()
        if weighted:
            np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jw),
                                       **LOOKUP)

    def test_duplicates_accumulate_in_the_plain_version(self):
        ids = torch.tensor([[2, 2, 5], [5, 2, 0]], dtype=torch.int32)
        g = torch.tensor([[1.0, 10.0], [100.0, 1000.0]])
        w = torch.tensor([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]])
        got = embedding_bag_backward(ids, g, 7, w)
        want = torch.zeros(7, 2)
        want[2] = 3 * g[0] + 5 * g[1]
        want[5] = 3 * g[0] + 4 * g[1]
        want[0] = 6 * g[1]
        assert torch.equal(got, want)
        assert torch.equal(embedding_bag_backward_ref(ids, g, 7, w), want)

    def test_cpu_backward_launches_nothing(self):
        eb_ops.reset_launches()
        t = torch.randn(10, 4, requires_grad=True)
        embedding_bag(torch.tensor([[1, 2]]), t).sum().backward()
        assert eb_ops.launches() == 0 and eb_ops.backward_launches() == 0

    def test_backward_rejects_other_devices(self):
        with pytest.raises(ValueError, match="embedding_bag backward"):
            embedding_bag_backward(torch.zeros(2, 1, dtype=torch.int32),
                                   torch.zeros(2, 4, device="meta"), 5)

    def test_inference_mode_lookup_records_nothing(self):
        t = torch.randn(10, 4, requires_grad=True)
        with torch.inference_mode():
            out = embedding_bag(torch.tensor([[1, 2]]), t)
        assert not out.requires_grad


class TestBackwardPlan:
    """The chunk plan the wrapper computes before the backward kernel's
    launch (`backward_plan`), against a count in numpy: the fewest entries
    per chunk, at least TILE, that cut n into at most CHUNKS chunks."""

    @staticmethod
    def _count(n: int) -> tuple[int, int]:
        chunk = eb_ops.TILE
        while len(np.arange(0, n, chunk)) > eb_ops.CHUNKS:
            chunk += 1
        return chunk, len(np.arange(0, n, chunk))

    @pytest.mark.parametrize("n", [
        1, 255, 256, 257, 4_096, eb_ops.TILE * eb_ops.CHUNKS - 1,
        eb_ops.TILE * eb_ops.CHUNKS, eb_ops.TILE * eb_ops.CHUNKS + 1,
        1_703_936, 3_000_001])
    def test_plan_against_a_count(self, n):
        chunk, n_chunks = eb_ops.backward_plan(n)
        assert (chunk, n_chunks) == self._count(n)
        # every entry in exactly one chunk, none longer than `chunk`
        sizes = np.bincount(np.arange(n) // chunk)
        assert len(sizes) == n_chunks and sizes.sum() == n
        assert sizes.max() <= chunk and sizes.min() >= 1

    def test_train_batch_plan_and_scratch(self):
        """DLRM-RM2's train_batch: 1,703,936 entries in one wave of
        chunks; the head and tail partials, [2, n_chunks, D] floats, stay
        near 2 MB at D = 64."""
        chunk, n_chunks = eb_ops.backward_plan(65_536 * 26)
        assert n_chunks <= eb_ops.CHUNKS < n_chunks + 8
        assert chunk == -(-65_536 * 26 // eb_ops.CHUNKS) == 404
        assert n_chunks == 4_218 and 2 * n_chunks * 64 * 4 == 2_159_616

    def test_plan_constants_match_the_source(self):
        """TILE is the kernel's kTile; CHUNKS is an H100's 132 SMs times
        the blocks per SM of the kernel's launch bounds times its warps per
        block."""
        import re
        from repro_torch.kernels import _build
        src = _build.sources()["embedding_bag_backward"].read_text()

        def const(pattern):
            return int(re.search(pattern, src)[1])
        assert eb_ops.TILE == const(r"constexpr int kTile = (\d+);")
        assert eb_ops.CHUNKS == 132 * const(
            r"constexpr int kMinBlocks = (\d+);") * const(
            r"constexpr int kWarps = (\d+);")


def _ref_config(cfg):
    return j_dlrm.DLRMConfig(**dataclasses.asdict(cfg))


def _params(cfg, seed: int = 0):
    ref = jax.tree.map(np.asarray, j_dlrm.init_params(
        jax.random.PRNGKey(seed), _ref_config(cfg)))
    return ref, interop.dlrm_params(ref, device="cpu")


def _batch(cfg, bsz: int, seed: int) -> dict:
    """Power-law ids per table (most rows unread), N(0, 1) dense features,
    Bernoulli(0.3) labels."""
    rng = np.random.default_rng(seed)
    ids = np.stack([(v * rng.random((bsz, cfg.bag_size)) ** 2).astype(
        np.int64) for v in cfg.vocab_sizes], axis=1)
    return {"dense": rng.standard_normal((bsz, cfg.n_dense)).astype(
                np.float32),
            "sparse_ids": (ids + cfg.offsets[None, :, None]).astype(np.int32),
            "labels": (rng.random(bsz) < 0.3).astype(np.float32)}


def _leaves_by_path(tree) -> dict:
    flat, _ = pytree.tree_flatten_with_path(tree)
    return {pytree.keystr(p): v for p, v in flat}


def _j_by_path(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    out = {}
    for path, v in flat:
        key = "".join(f"[{p.key!r}]" if hasattr(p, "key") else f"[{p.idx}]"
                      for p in path)
        out[key] = np.asarray(v)
    return out


CONFIGS = {"smoke": cfgs.smoke_config(),
           "bag3": dataclasses.replace(cfgs.smoke_config(), bag_size=3)}


class TestLossFn:
    @pytest.mark.parametrize("name", sorted(CONFIGS))
    def test_loss_and_gradients_match_reference(self, name):
        cfg = CONFIGS[name]
        ref, params = _params(cfg)
        batch = _batch(cfg, 32, seed=1)
        jl, jg = jax.value_and_grad(j_dlrm.loss_fn)(
            jax.tree.map(jnp.asarray, ref),
            {k: jnp.asarray(v) for k, v in batch.items()}, _ref_config(cfg))
        leaves, spec = pytree.tree_flatten(params)
        xs = [p.requires_grad_(True) for p in leaves]
        loss = dlrm.loss_fn(pytree.tree_unflatten(xs, spec),
                            {k: torch.from_numpy(v) for k, v in
                             batch.items()}, cfg)
        grads = pytree.tree_unflatten(list(torch.autograd.grad(loss, xs)),
                                      spec)
        np.testing.assert_allclose(loss.detach().numpy(), np.asarray(jl),
                                   rtol=1e-5)
        got, want = _leaves_by_path(grads), _j_by_path(jg)
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            np.testing.assert_allclose(got[k].numpy(), w, err_msg=k, **GRAD)
        unread = np.setdiff1d(np.arange(cfg.padded_rows),
                              batch["sparse_ids"])
        assert len(unread) > cfg.padded_rows // 4
        assert not grads["table"][unread].any()

    def test_logit_zero_splits_the_gradient(self):
        """max(z, 0) at z = 0 takes half the gradient, as jnp.maximum."""
        z = torch.zeros(3, requires_grad=True)
        torch.maximum(z, torch.zeros_like(z)).sum().backward()
        assert torch.equal(z.grad, torch.full((3,), 0.5))
        jz = jax.grad(lambda z: jnp.sum(jnp.maximum(z, 0)))(jnp.zeros(3))
        np.testing.assert_array_equal(np.asarray(jz), z.grad.numpy())


class TestTrainStep:
    def test_one_step_matches_reference_and_decays_unread_rows(self):
        cfg = cfgs.smoke_config()
        ref, params = _params(cfg, seed=2)
        batch = _batch(cfg, 32, seed=3)
        rng = np.random.default_rng(4)
        state = {"step": np.int32(2),
                 "m": jax.tree.map(lambda p: (rng.standard_normal(p.shape)
                                              * 1e-3).astype(np.float32),
                                   ref),
                 "v": jax.tree.map(lambda p: (np.abs(rng.standard_normal(
                     p.shape)) * 1e-6).astype(np.float32), ref)}
        j_cfg = j_opt.AdamWConfig(lr=1e-3)
        j_step = j_loop.make_train_step(
            partial(j_dlrm.loss_fn, cfg=_ref_config(cfg)), j_cfg,
            donate=False)
        jp, js, jm = j_step(jax.tree.map(jnp.asarray, ref),
                            jax.tree.map(jnp.asarray, state),
                            {k: jnp.asarray(v) for k, v in batch.items()})
        table0 = params["table"].clone()
        step = make_train_step(partial(dlrm.loss_fn, cfg=cfg),
                               AdamWConfig(lr=1e-3), donate=True)
        p, s, m = step(params, interop.adamw_state(state, device="cpu"),
                       {k: torch.from_numpy(v) for k, v in batch.items()})
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(m[k].numpy(), np.asarray(jm[k]),
                                       rtol=1e-5)
        for got, want in ((p, jp), (s["m"], js["m"]), (s["v"], js["v"])):
            got, want = _leaves_by_path(got), _j_by_path(want)
            assert sorted(got) == sorted(want)
            for k, w in want.items():
                np.testing.assert_allclose(got[k].numpy(), w, err_msg=k,
                                           **STATE)
        # a row no id read: zero gradient, yet weight decay and the old
        # moments move it
        row = int(np.setdiff1d(np.arange(cfg.padded_rows),
                               batch["sparse_ids"])[0])
        assert not torch.equal(p["table"][row], table0[row])

    def test_adamw_state_carries_dtypes_and_step(self):
        state = {"step": np.int32(7),
                 "m": {"a": np.ones((2, 3), np.float32),
                       "l": [np.zeros(2, np.float32)]},
                 "v": {"a": np.asarray(jnp.ones((2, 3), jnp.bfloat16)),
                       "l": [np.zeros(2, np.float32)]}}
        got = interop.adamw_state(state, device="cpu")
        assert got["step"].dtype == torch.int32 and int(got["step"]) == 7
        assert got["m"]["a"].dtype == torch.float32
        assert got["v"]["a"].dtype == torch.bfloat16
        assert isinstance(got["m"]["l"], list)

    def test_loss_falls(self):
        cfg = cfgs.smoke_config()
        params = dlrm.init_params(cfg, seed=0, device="cpu")
        opt_cfg = AdamWConfig(lr=1e-2, weight_decay=0.0)
        opt = adamw_init(params, opt_cfg)
        batch = cfgs.make_batch(cfg, 64, seed=0, device="cpu")
        step = make_train_step(partial(dlrm.loss_fn, cfg=cfg), opt_cfg)
        losses = []
        for _ in range(10):
            params, opt, m = step(params, opt, batch)
            losses.append(float(m["loss"]))
        assert losses[-1] < 0.9 * losses[0], losses


class TestSmokeRun:
    def test_smoke_step_finite(self):
        out = cfgs.smoke_run(seed=0, device="cpu")
        assert sorted(out) == ["grad_norm", "loss", "retrieval_top"]
        for name, val in out.items():
            assert bool(torch.isfinite(val).all()), name

    def test_smoke_deterministic(self):
        a = cfgs.smoke_run(seed=0, device="cpu")
        b = cfgs.smoke_run(seed=0, device="cpu")
        c = cfgs.smoke_run(seed=1, device="cpu")
        for k in a:
            assert torch.equal(a[k], b[k]), k
        assert not torch.equal(a["loss"], c["loss"])

    def test_default_device_is_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            cfgs.smoke_run()
