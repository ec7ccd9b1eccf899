"""Port's training substrate vs the reference's, on the CPU: AdamW, the
train step (one step end to end, microbatches, donation), checkpoints and
the `train_gnn` launcher.

Tolerances: `adamw_update` on the same numpy gradients, rtol 1e-6 / atol
1e-7 over three steps (elementwise f32 arithmetic in the same order; the
global norm's sums differ in order). One `make_train_step` step: loss and
grad_norm rtol 1e-5; parameters rtol 1e-5, except elements whose gradient
is below 1e-6 of its leaf's largest: a step-1 Adam update is about
lr * sign(g), so a gradient at noise level may take the other sign in the
other package and move the parameter by up to 2 * lr.
"""
import dataclasses
import threading
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.configs import dimenet as j_dimenet_cfg
from repro.configs import graphcast as j_graphcast_cfg
from repro.configs import meshgraphnet as j_mgn_cfg
from repro.configs import pna as j_pna_cfg
from repro.configs import gnn_common as j_gc
from repro.models.gnn import dimenet as j_dimenet
from repro.models.gnn import graphcast as j_graphcast
from repro.models.gnn import meshgraphnet as j_mgn
from repro.models.gnn import pna as j_pna
from repro.train import optimizer as j_opt
from repro.train import train_loop as j_loop

from repro_torch import interop
from repro_torch.configs import dimenet as dimenet_cfg
from repro_torch.configs import gnn_common as gc
from repro_torch.configs import graphcast as graphcast_cfg
from repro_torch.configs import meshgraphnet as mgn_cfg
from repro_torch.configs import pna as pna_cfg
from repro_torch.launch import train_gnn
from repro_torch.models.gnn import dimenet, graphcast, meshgraphnet, pna
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import (AdamWConfig, adamw_init,
                                         adamw_update, global_norm)
from repro_torch.train.train_loop import make_train_step


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _shapes():
    return {"w": (7, 5), "b": (5,), "stack": [{"x": (3, 4, 2)}, {"y": ()}]}


def _numpy_tree(seed: int, scale: float = 1.0):
    r = np.random.default_rng(seed)
    return pytree.tree_map(
        lambda s: (r.standard_normal(s) * scale).astype(np.float32),
        _shapes(), is_leaf=lambda x: isinstance(x, tuple))


def _leaves_by_path(tree) -> dict:
    flat, _ = pytree.tree_flatten_with_path(tree)
    return {pytree.keystr(p): v for p, v in flat}


class TestAdamW:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("clip", [1.0, 100.0])
    def test_update_matches_reference(self, dtype, clip):
        cfg = AdamWConfig(lr=1e-2, m_dtype=dtype, v_dtype=dtype,
                          grad_clip=clip)
        j_cfg = j_opt.AdamWConfig(**dataclasses.asdict(cfg))
        p0 = _numpy_tree(0)
        params, state = pytree.tree_map(_t, p0), None
        jp = jax.tree.map(jnp.asarray, p0)
        state = adamw_init(params, cfg)
        jstate = j_opt.adamw_init(jp, j_cfg)
        for step in range(3):
            g = _numpy_tree(10 + step, scale=3.0)
            params, state, m = adamw_update(pytree.tree_map(_t, g), state,
                                            params, cfg)
            jp, jstate, jm = j_opt.adamw_update(
                jax.tree.map(jnp.asarray, g), jstate, jp, j_cfg)
            np.testing.assert_allclose(m["grad_norm"].numpy(),
                                       np.asarray(jm["grad_norm"]),
                                       rtol=1e-6, atol=1e-7)
            assert int(state["step"]) == int(jstate["step"]) == step + 1
            for tree, jtree in ((params, jp), (state["m"], jstate["m"]),
                                (state["v"], jstate["v"])):
                got = _leaves_by_path(tree)
                want = _leaves_by_path(jtree)
                for k in want:
                    assert str(got[k].dtype).endswith(str(want[k].dtype))
                    np.testing.assert_allclose(
                        got[k].float().numpy(),
                        np.asarray(want[k], np.float32), rtol=1e-6,
                        atol=1e-7, err_msg=k)

    def test_inputs_untouched_and_norm_reported_before_clip(self):
        params = {"w": torch.zeros(3)}
        cfg = AdamWConfig(lr=1.0, grad_clip=1.0, weight_decay=0.0)
        state = adamw_init(params, cfg)
        new, s2, metrics = adamw_update({"w": torch.full((3,), 1e6)}, state,
                                        params, cfg)
        assert float(metrics["grad_norm"]) > 1e5
        assert params["w"].abs().sum() == 0 and state["step"] == 0
        assert new["w"] is not params["w"] and s2["step"] == 1

    def test_quadratic_convergence(self):
        params = {"w": torch.tensor([5.0, -3.0])}
        cfg = AdamWConfig(lr=0.1, weight_decay=0.0)
        state = adamw_init(params, cfg)
        for _ in range(200):
            params, state, _ = adamw_update({"w": 2 * params["w"]}, state,
                                            params, cfg)
        assert float(params["w"].abs().max()) < 1e-2

    def test_global_norm(self):
        tree = _numpy_tree(3)
        np.testing.assert_allclose(
            global_norm(pytree.tree_map(_t, tree)).numpy(),
            np.asarray(j_opt.global_norm(jax.tree.map(jnp.asarray, tree))),
            rtol=1e-6)
        assert global_norm({"a": torch.ones(4, dtype=torch.float64)}
                           ).dtype == torch.float64


# ---------------------------------------------------------- train step --
def _j_gcast_init(key, cfg):
    return j_graphcast_cfg._init(key, cfg, d_in=12)


STEP_MODELS = {
    "meshgraphnet": (j_mgn, meshgraphnet, j_mgn_cfg.make_batch,
                     mgn_cfg.smoke_config(), j_mgn.init_params),
    "pna": (j_pna, pna, j_pna_cfg.make_batch, pna_cfg.smoke_config(),
            j_pna.init_params),
    "dimenet": (j_dimenet, dimenet, j_dimenet_cfg.make_batch,
                dimenet_cfg.smoke_config(), j_dimenet.init_params),
    "graphcast": (j_graphcast, graphcast,
                  partial(j_graphcast_cfg.make_batch, d_in=12),
                  graphcast_cfg.smoke_config(), _j_gcast_init),
}


class TestTrainStep:
    @pytest.mark.parametrize("name", sorted(STEP_MODELS))
    def test_one_step_matches_reference(self, name):
        j_mod, t_mod, j_make, cfg, j_init = STEP_MODELS[name]
        j_cfg = {"meshgraphnet": j_mgn.MeshGraphNetConfig,
                 "pna": j_pna.PNAConfig, "dimenet": j_dimenet.DimeNetConfig,
                 "graphcast": j_graphcast.GraphCastConfig}[name](
            **dataclasses.asdict(cfg))
        ref = jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(0), j_cfg))
        batch = {k: np.asarray(v) for k, v in j_make(
            j_cfg, j_gc.gnn_smoke_dims(), abstract=False, seed=0).items()}
        opt_cfg = AdamWConfig(lr=1e-3)
        j_opt_cfg = j_opt.AdamWConfig(lr=1e-3)
        jp = jax.tree.map(jnp.asarray, ref)
        j_step = j_loop.make_train_step(partial(j_mod.loss_fn, cfg=j_cfg),
                                        j_opt_cfg, donate=False)
        jp2, _, jm = j_step(jp, j_opt.adamw_init(jp, j_opt_cfg),
                            {k: jnp.asarray(v) for k, v in batch.items()})
        jgrads = jax.grad(j_mod.loss_fn)(jp, {k: jnp.asarray(v) for k, v
                                              in batch.items()}, j_cfg)
        params = interop.gnn_params(ref, device="cpu")
        step = make_train_step(partial(t_mod.loss_fn, cfg=cfg), opt_cfg,
                               donate=False)
        p2, opt2, m = step(params, adamw_init(params, opt_cfg),
                           {k: _t(v) for k, v in batch.items()})
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(m[k].numpy(), np.asarray(jm[k]),
                                       rtol=1e-5)
        got = _leaves_by_path(p2)
        want = {pytree.keystr(p): np.asarray(v) for p, v in
                _j_paths(jp2)}
        gmax = {pytree.keystr(p): np.asarray(v) for p, v in
                _j_paths(jgrads)}
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            g = np.abs(gmax[k])
            noise = g < 1e-6 * g.max()
            np.testing.assert_allclose(got[k].numpy()[~noise], w[~noise],
                                       rtol=1e-5, err_msg=k)
            assert (np.abs(got[k].numpy()[noise] - w[noise])
                    <= 2 * opt_cfg.lr * 1.0001).all(), k

    def test_microbatches_match_one_batch(self):
        """num_microbatches = 2 vs 1 on an MLP loss (a mean over rows, so
        the two splits average to the same gradient), and vs the
        reference's two-microbatch step."""
        from repro.models.layers import mlp_apply as j_mlp_apply
        from repro.models.layers import mlp_init as j_mlp_init
        from repro_torch.models.layers import mlp_apply
        ref = jax.tree.map(np.asarray, j_mlp_init(jax.random.PRNGKey(0),
                                                  (6, 16, 3)))
        r = np.random.default_rng(1)
        batch = {"x": r.standard_normal((8, 6)).astype(np.float32),
                 "y": r.standard_normal((8, 3)).astype(np.float32)}

        def loss(p, b):
            return ((mlp_apply(p, b["x"]) - b["y"]) ** 2).mean()

        def j_loss(p, b):
            return jnp.mean((j_mlp_apply(p, b["x"]) - b["y"]) ** 2)
        cfg = AdamWConfig(lr=1e-2)
        outs = {}
        for micro in (1, 2):
            params = interop.gnn_params(ref, device="cpu")
            step = make_train_step(loss, cfg, num_microbatches=micro,
                                   donate=False)
            outs[micro] = step(params, adamw_init(params, cfg),
                               {k: _t(v) for k, v in batch.items()})
        j_step = j_loop.make_train_step(j_loss, j_opt.AdamWConfig(lr=1e-2),
                                        num_microbatches=2, donate=False)
        jref = jax.tree.map(jnp.asarray, ref)
        jp, _, jm = j_step(jref, j_opt.adamw_init(
            jref, j_opt.AdamWConfig(lr=1e-2)),
            {k: jnp.asarray(v) for k, v in batch.items()})
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(outs[2][2][k].numpy(),
                                       outs[1][2][k].numpy(), rtol=1e-5)
            np.testing.assert_allclose(outs[2][2][k].numpy(),
                                       np.asarray(jm[k]), rtol=1e-5)
        two, one = _leaves_by_path(outs[2][0]), _leaves_by_path(outs[1][0])
        want = {pytree.keystr(p): np.asarray(v) for p, v in _j_paths(jp)}
        assert sorted(two) == sorted(want)
        for k, c in want.items():
            np.testing.assert_allclose(two[k].numpy(), one[k].numpy(),
                                       rtol=1e-5, atol=1e-7)
            np.testing.assert_allclose(two[k].numpy(), c, rtol=1e-5,
                                       atol=1e-7)
        with pytest.raises(ValueError):
            make_train_step(loss, cfg, num_microbatches=3)(
                interop.gnn_params(ref, device="cpu"),
                adamw_init(interop.gnn_params(ref, device="cpu"), cfg),
                {k: _t(v) for k, v in batch.items()})

    @pytest.mark.parametrize("donate", [False, True])
    def test_donate_is_update_in_place(self, donate):
        cfg = pna_cfg.smoke_config()
        gen = torch.Generator().manual_seed(0)
        params = pna.init_params(gen, cfg)
        batch = pna_cfg.make_batch(cfg, gc.gnn_smoke_dims(), device="cpu")
        opt_cfg = AdamWConfig(lr=1e-3)
        opt = adamw_init(params, opt_cfg)
        before = [t.detach().clone() for t in
                  pytree.tree_leaves((params, opt))]
        step = make_train_step(partial(pna.loss_fn, cfg=cfg), opt_cfg,
                               donate=donate)
        p2, o2, _ = step(params, opt, batch)
        after = pytree.tree_leaves((params, opt))
        new = pytree.tree_leaves((p2, o2))
        if donate:
            assert all(a is b for a, b in zip(after, new))
            assert not all(torch.equal(a, b) for a, b in zip(after, before))
        else:
            assert all(torch.equal(a, b) for a, b in zip(after, before))
            assert all(a is not b for a, b in zip(after, new))
        # the same values either way
        ref = make_train_step(partial(pna.loss_fn, cfg=cfg), opt_cfg,
                              donate=False)(
            *pytree.tree_unflatten(before, pytree.tree_flatten(
                (params, opt))[1]), batch)
        for a, b in zip(new, pytree.tree_leaves(ref[:2])):
            assert torch.equal(a, b)

    def test_loss_falls_on_one_batch(self):
        cfg = mgn_cfg.smoke_config()
        params = meshgraphnet.init_params(torch.Generator().manual_seed(0),
                                          cfg)
        batch = mgn_cfg.make_batch(cfg, gc.gnn_smoke_dims(), device="cpu")
        opt_cfg = AdamWConfig(lr=1e-2, weight_decay=0.0)
        opt = adamw_init(params, opt_cfg)
        step = make_train_step(partial(meshgraphnet.loss_fn, cfg=cfg),
                               opt_cfg)
        losses = []
        for _ in range(10):
            params, opt, m = step(params, opt, batch)
            losses.append(float(m["loss"]))
        assert losses[-1] < 0.8 * losses[0], losses


def _j_paths(tree):
    """JAX leaves keyed like torch's keystr ([k] for dicts and lists)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    out = []
    for path, v in flat:
        keys = []
        for p in path:
            keys.append(pytree.MappingKey(p.key) if hasattr(p, "key")
                        else pytree.SequenceKey(p.idx))
        out.append((tuple(keys), v))
    return out


# ------------------------------------------------------------ checkpoint --
def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(8, 4, generator=g),
                       "b": torch.randn(4, generator=g).to(torch.bfloat16),
                       "layers": [{"x": torch.randn(2, 3, generator=g)}]},
            "opt": {"step": torch.tensor(7, dtype=torch.int32),
                    "m": torch.zeros(0)}}


def _equal_trees(a, b):
    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


class TestCheckpoint:
    def test_roundtrip_bit_exact(self, tmp_path):
        tree = _tree()
        ckpt.save(tmp_path, 3, tree, metadata={"data_step": 3})
        restored, meta = ckpt.restore(tmp_path, _tree(seed=1))
        assert meta == {"data_step": 3}
        _equal_trees(restored, tree)

    def test_restore_keeps_requires_grad_and_matches_by_path(self, tmp_path):
        tree = _tree()
        ckpt.save(tmp_path, 1, tree)
        like = _tree(seed=2)
        like["params"]["w"].requires_grad_(True)
        # another insertion order of the same keys
        like = {"opt": like["opt"], "params": dict(reversed(
            list(like["params"].items())))}
        restored, _ = ckpt.restore(tmp_path, like)
        assert restored["params"]["w"].requires_grad
        assert torch.equal(restored["params"]["w"].detach(),
                           tree["params"]["w"])
        with pytest.raises(ValueError):
            ckpt.restore(tmp_path, {"params": tree["params"]})

    def test_latest_and_prune(self, tmp_path):
        tree = _tree()
        for s in (1, 5, 9, 12):
            ckpt.save(tmp_path, s, tree)
        assert ckpt.latest_step(tmp_path) == 12
        ckpt.prune(tmp_path, keep=2)
        assert sorted(p.name for p in tmp_path.iterdir()) == \
            ["step_000000009", "step_000000012"]
        assert ckpt.latest_step(tmp_path / "nope") is None
        with pytest.raises(FileNotFoundError):
            ckpt.restore(tmp_path / "nope", tree)

    def test_partial_write_ignored(self, tmp_path):
        """A step directory without the completion flag, or a .tmp one, is
        never 'latest'."""
        tree = _tree()
        ckpt.save(tmp_path, 1, tree)
        fake = tmp_path / "step_000000002"
        fake.mkdir()
        (fake / "data.bin").write_bytes(b"garbage")
        tmp = tmp_path / "step_000000003.tmp"
        tmp.mkdir()
        (tmp / "checkpoint-complete").touch()
        assert ckpt.latest_step(tmp_path) == 1
        restored, _ = ckpt.restore(tmp_path, tree)
        _equal_trees(restored, tree)

    def test_async_save_copies_before_returning(self, tmp_path):
        tree = _tree()
        want = [t.clone() for t in pytree.tree_leaves(tree)]
        t = ckpt.save(tmp_path, 4, tree, async_=True)
        assert isinstance(t, threading.Thread)
        with torch.no_grad():
            for leaf in pytree.tree_leaves(tree):
                leaf.add_(1) if leaf.dtype != torch.int32 else leaf.fill_(99)
        t.join(timeout=60)
        assert not t.is_alive()
        assert ckpt.latest_step(tmp_path) == 4
        restored, _ = ckpt.restore(tmp_path, tree)
        for a, b in zip(pytree.tree_leaves(restored), want):
            assert torch.equal(a, b)


# -------------------------------------------------------------- launcher --
class TestTrainGnn:
    def test_short_cpu_run_loss_falls_and_replay_is_bit_exact(self):
        lines = []
        out = train_gnn.run(steps=40, batch_nodes=16, device="cpu",
                            log=lines.append)
        losses = out["losses"]
        assert len(losses) == 40 and np.isfinite(losses).all()
        assert np.mean(losses[-10:]) < np.mean(losses[:10])
        assert out["replay_bitwise"], lines
        assert len(out["host_ms"]) == len(out["device_ms"]) == 40
        assert out["ckpt_step"] == 21

    def test_cli(self, capsys):
        assert train_gnn.main(["--steps", "4", "--batch-nodes", "8",
                               "--device", "cpu"]) == 0
        assert "bit-exact" in capsys.readouterr().out

    def test_replay_from_async_checkpoint(self, tmp_path):
        from repro_torch.graph import generators
        from repro_torch.train.data import GraphBatchPipeline
        g = generators.powerlaw_ba(300, 3, seed=0)
        pr, feats, targets, delta = train_gnn.pagerank_task(g, "cpu")
        assert pr.dtype == np.float64 and abs(pr.sum() - 1) < 1e-4
        cfg = pna.PNAConfig(name="t", n_layers=2, d_hidden=8,
                            d_in=feats.shape[1], d_out=targets.shape[1],
                            delta=delta)
        params = pna.init_params(torch.Generator().manual_seed(0), cfg)
        opt_cfg = AdamWConfig(lr=2e-3)
        step = make_train_step(partial(pna.loss_fn, cfg=cfg), opt_cfg,
                               donate=False)
        pipe = GraphBatchPipeline(g, feats, targets, 8, (4, 3), seed=1,
                                  ppr_weights=pr, device="cpu")
        out = train_gnn.fit(step, params, adamw_init(params, opt_cfg), pipe,
                            6, tmp_path, async_save=True)
        rp, rm, data_step = train_gnn.replay(
            step, tmp_path, {"params": out["params"], "opt": out["opt"]},
            pipe)
        assert data_step == 4 and out["ckpt_step"] == 4
        assert train_gnn.tree_max_gap(out["reference"][0], rp) == 0.0
        assert torch.equal(out["reference"][1]["loss"], rm["loss"])
        with pytest.raises(ValueError):
            train_gnn.fit(step, params, adamw_init(params, opt_cfg), pipe,
                          1, tmp_path)
