"""Port's GNN zoo vs the reference's, on the CPU.

The same numpy inputs (made from a seed, or the reference's own
`make_batch` arrays) go through both packages; the reference's parameters
are carried into the port with `repro_torch.interop.gnn_params`, so both
compute the same function. Tolerances: the primitives and the models'
forward and loss rtol 1e-5 / atol 1e-6 (f32 on both sides, sums in
different orders); gradients from `torch.autograd` against `jax.grad`
rtol 1e-4 / atol 1e-6 (the backward passes add many more terms, in
different orders). The atol is for arrays of magnitude 1 (8 ulps of 1.0
in f32) and scales with the largest |value| of the expected array where
that is above 1: DimeNet's smoke gradients reach 1.3e5 (an ulp there is
0.008), and a 3-layer interaction step's outputs reach 4.1, where one
element that cancels to 0.04 lands 1.49e-6 from the reference while both
packages' matmuls sit 2.6e-7 / 2.8e-7 from a float64 product. The host
builders (CSR, sampler, pipeline, synthetic graph arrays, mesh topology,
triplets) must give equal arrays.
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.configs import dimenet as j_dimenet_cfg
from repro.configs import gnn_common as j_gc
from repro.configs import graphcast as j_graphcast_cfg
from repro.configs import meshgraphnet as j_mgn_cfg
from repro.configs import pna as j_pna_cfg
from repro.graph import generators as j_generators
from repro.graph import ops as j_ops
from repro.graph import sampler as j_sampler
from repro.models import layers as j_layers
from repro.models.gnn import common as j_common
from repro.models.gnn import dimenet as j_dimenet
from repro.models.gnn import graphcast as j_graphcast
from repro.models.gnn import meshgraphnet as j_mgn
from repro.models.gnn import pna as j_pna
from repro.train import data as j_data

from repro_torch import interop
from repro_torch.configs import dimenet as dimenet_cfg
from repro_torch.configs import gnn_common as gc
from repro_torch.configs import graphcast as graphcast_cfg
from repro_torch.configs import meshgraphnet as mgn_cfg
from repro_torch.configs import pna as pna_cfg
from repro_torch.graph import generators, ops, sampler
from repro_torch.models import layers
from repro_torch.models.gnn import common, dimenet, graphcast, \
    meshgraphnet, pna
from repro_torch.train.data import GraphBatchPipeline

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _np(x) -> np.ndarray:
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _pairs(a, b, path=""):
    """(path, a_leaf, b_leaf) over two trees of dicts / lists, matched by
    key (JAX orders dict leaves by key, torch by insertion)."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), (path, sorted(a), sorted(b))
        for k in sorted(a):
            yield from _pairs(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            yield from _pairs(x, y, f"{path}[{i}]")
    else:
        yield path, a, b


def _close(got, want, rtol, atol, err_msg=""):
    """assert_allclose with atol scaled by max(1, max |want|)."""
    got, want = _np(got), np.asarray(want)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale,
                               err_msg=err_msg)


def _close_trees(got, want, **tol):
    n = 0
    for path, g, w in _pairs(got, want):
        assert tuple(_np(g).shape) == tuple(np.shape(w)), path
        _close(g, w, err_msg=path, **tol)
        n += 1
    return n


def _rng(seed):
    return np.random.default_rng(seed)


# ---------------------------------------------------------------- layers --
class TestPrimitives:
    def test_layer_norm(self):
        r = _rng(0)
        x = r.standard_normal((33, 24)).astype(np.float32) * 3 + 1
        g = r.standard_normal(24).astype(np.float32)
        b = r.standard_normal(24).astype(np.float32)
        want = j_layers.layer_norm(jnp.asarray(x), jnp.asarray(g),
                                   jnp.asarray(b))
        got = layers.layer_norm(_t(x), _t(g), _t(b))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(_np(got), np.asarray(want), **FWD)

    def test_layer_norm_bf16_input_normalizes_in_f32(self):
        x = _rng(1).standard_normal((8, 16)).astype(np.float32)
        xb = torch.from_numpy(x).to(torch.bfloat16)
        one, zero = torch.ones(16, dtype=torch.bfloat16), \
            torch.zeros(16, dtype=torch.bfloat16)
        got = layers.layer_norm(xb, one, zero)
        want = j_layers.layer_norm(jnp.asarray(x, jnp.bfloat16),
                                   jnp.ones(16, jnp.bfloat16),
                                   jnp.zeros(16, jnp.bfloat16))
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))

    @pytest.mark.parametrize("bias", [True, False])
    @pytest.mark.parametrize("act", ["relu", "silu"])
    @pytest.mark.parametrize("final_act", [False, True])
    def test_mlp_apply(self, bias, act, final_act):
        ref = jax.tree.map(np.asarray, j_layers.mlp_init(
            jax.random.PRNGKey(3), (10, 20, 7), bias=bias))
        x = _rng(2).standard_normal((15, 10)).astype(np.float32)
        j_act = {"relu": jax.nn.relu, "silu": jax.nn.silu}[act]
        t_act = {"relu": torch.relu, "silu": torch.nn.functional.silu}[act]
        want = j_layers.mlp_apply(ref, jnp.asarray(x), act=j_act,
                                  final_act=final_act)
        got = layers.mlp_apply(interop.gnn_params(ref, device="cpu"), _t(x),
                               act=t_act, final_act=final_act)
        np.testing.assert_allclose(_np(got), np.asarray(want), **FWD)

    def test_mlp_init_bias_flag(self):
        gen = torch.Generator().manual_seed(0)
        assert all("b" not in p for p in layers.mlp_init(gen, (4, 5, 6),
                                                         bias=False))
        assert all(p["b"].abs().sum() == 0
                   for p in layers.mlp_init(gen, (4, 5, 6)))


def _graph_pair(n: int, src, dst):
    """The same hand-built graph in both packages (vertices without an
    incoming edge give empty segments)."""
    src = np.asarray(src, np.int32)
    dst = np.asarray(dst, np.int32)
    deg = np.maximum(np.bincount(src, minlength=n), 1)
    inv = (1.0 / deg).astype(np.float32)
    jdg = j_ops.DeviceGraph(n, jnp.asarray(src), jnp.asarray(dst),
                            jnp.asarray(inv))
    tdg = ops.DeviceGraph(n, _t(src), _t(dst), _t(inv))
    return jdg, tdg


def _random_graph(seed, n=40, m=150):
    r = _rng(seed)
    src = r.integers(0, n, m)
    dst = r.integers(0, n - 5, m)          # the last 5 vertices: empty
    return _graph_pair(n, src, dst)


class TestGraphOps:
    @pytest.mark.parametrize("kind", ["sum", "mean", "max", "min"])
    @pytest.mark.parametrize("weighted", [False, True])
    def test_aggregate(self, kind, weighted):
        jdg, tdg = _random_graph(5)
        r = _rng(6)
        x = r.standard_normal((40, 9)).astype(np.float32)
        w = r.random(150).astype(np.float32) if weighted else None
        want = np.asarray(j_ops.aggregate(
            jdg, jnp.asarray(x), kind,
            None if w is None else jnp.asarray(w)))
        got = _np(ops.aggregate(tdg, _t(x), kind,
                                None if w is None else _t(w)))
        if kind in ("max", "min"):
            assert np.isinf(want[-5:]).all()
        np.testing.assert_allclose(got, want, **FWD)

    def test_aggregate_rejects_unknown_kind(self):
        _, tdg = _random_graph(5)
        with pytest.raises(ValueError):
            ops.aggregate(tdg, torch.zeros(40, 2), "median")

    def test_edge_softmax(self):
        jdg, tdg = _random_graph(7)
        s = _rng(8).standard_normal(150).astype(np.float32) * 4
        want = j_ops.edge_softmax(jdg, jnp.asarray(s))
        np.testing.assert_allclose(_np(ops.edge_softmax(tdg, _t(s))),
                                   np.asarray(want), **FWD)

    @pytest.mark.parametrize("power", [-0.5, -1.0, 0.5])
    @pytest.mark.parametrize("ndim", [1, 2])
    def test_degree_normalize(self, power, ndim):
        jdg, tdg = _random_graph(9)
        x = _rng(10).standard_normal((40, 3)[:ndim]).astype(np.float32)
        want = j_ops.degree_normalize(jdg, jnp.asarray(x), power)
        got = ops.degree_normalize(tdg, _t(x), power)
        np.testing.assert_allclose(_np(got), np.asarray(want), **FWD)

    @pytest.mark.parametrize("name", ["max", "min"])
    def test_segment_extreme_gradient_splits_ties(self, name):
        """Ties split the gradient evenly in both packages; an empty
        segment's +-inf, replaced by 0 as PNA does, passes no gradient."""
        x = np.array([[1.0], [1.0], [0.5], [2.0]], np.float32)
        if name == "min":
            x = -x
        seg = np.array([0, 0, 0, 2], np.int32)
        j_fn = {"max": jax.ops.segment_max, "min": jax.ops.segment_min}[name]
        t_fn = {"max": ops.segment_max, "min": ops.segment_min}[name]
        w = np.array([[1.0], [2.0], [3.0]], np.float32)

        def j_loss(v):
            out = j_fn(v, jnp.asarray(seg), num_segments=3)
            return jnp.sum(jnp.where(jnp.isfinite(out), out, 0.0) * w)
        xt = _t(x).requires_grad_(True)
        out = t_fn(xt, _t(seg), 3)
        torch.sum(torch.where(torch.isfinite(out), out, 0.0) * _t(w)
                  ).backward()
        np.testing.assert_allclose(xt.grad.numpy(),
                                   np.asarray(jax.grad(j_loss)(
                                       jnp.asarray(x))), **FWD)
        assert xt.grad[:2].abs().sum() == 1.0     # split evenly


class TestCommon:
    def test_segment_std(self):
        r = _rng(11)
        x = r.standard_normal((80, 6)).astype(np.float32)
        seg = r.integers(0, 30, 80).astype(np.int32)   # some empty
        seg[:3] = 29                                     # and one single
        want = j_common.segment_std(jnp.asarray(x), jnp.asarray(seg), 31)
        got = common.segment_std(_t(x), _t(seg), 31)
        np.testing.assert_allclose(_np(got), np.asarray(want), **FWD)

    def test_lnmlp_apply(self):
        ref = jax.tree.map(np.asarray, j_common.lnmlp_init(
            jax.random.PRNGKey(4), (7, 16, 16)))
        ref["ln_g"] = _rng(12).standard_normal(16).astype(np.float32)
        ref["ln_b"] = _rng(13).standard_normal(16).astype(np.float32)
        x = _rng(14).standard_normal((21, 7)).astype(np.float32)
        want = j_common.lnmlp_apply(ref, jnp.asarray(x))
        got = common.lnmlp_apply(interop.gnn_params(ref, device="cpu"),
                                 _t(x))
        np.testing.assert_allclose(_np(got), np.asarray(want), **FWD)

    @pytest.mark.parametrize("aggregator", ["sum", "mean"])
    @pytest.mark.parametrize("mlp_layers", [2, 3])
    def test_interaction_apply(self, aggregator, mlp_layers):
        ref = jax.tree.map(np.asarray, j_common.interaction_init(
            jax.random.PRNGKey(5), 12, 12, 16, mlp_layers))
        r = _rng(15)
        h = r.standard_normal((30, 12)).astype(np.float32)
        e = r.standard_normal((90, 12)).astype(np.float32)
        snd = r.integers(0, 30, 90).astype(np.int32)
        rcv = r.integers(0, 25, 90).astype(np.int32)
        jh, je = j_common.interaction_apply(
            ref, *map(jnp.asarray, (h, e, snd, rcv)), 30, aggregator)
        th, te = common.interaction_apply(
            interop.gnn_params(ref, device="cpu"),
            *map(_t, (h, e, snd, rcv)), 30, aggregator)
        _close(th, jh, **FWD)
        _close(te, je, **FWD)

    @pytest.mark.parametrize("masked", [False, True])
    def test_mse_loss(self, masked):
        r = _rng(16)
        p = r.standard_normal((20, 3)).astype(np.float32)
        t = r.standard_normal((20, 3)).astype(np.float32)
        m = (r.random(20) < 0.4).astype(np.float32) if masked else None
        want = j_common.mse_loss(jnp.asarray(p), jnp.asarray(t),
                                 None if m is None else jnp.asarray(m))
        got = common.mse_loss(_t(p), _t(t), None if m is None else _t(m))
        np.testing.assert_allclose(_np(got), np.asarray(want), **FWD)


# ---------------------------------------------------------------- models --
def _mgn_case(cfg):
    return (j_mgn, meshgraphnet, mgn_cfg.make_batch, j_mgn_cfg.make_batch,
            j_mgn.MeshGraphNetConfig, cfg, j_mgn.init_params, None)


def _gcast_init(key, cfg):
    return j_graphcast_cfg._init(key, cfg, d_in=12)


MODELS = {
    "meshgraphnet": _mgn_case(mgn_cfg.smoke_config()),
    "meshgraphnet_mlp3": _mgn_case(dataclasses.replace(
        mgn_cfg.smoke_config(), mlp_layers=3)),
    "pna": (j_pna, pna, pna_cfg.make_batch, j_pna_cfg.make_batch,
            j_pna.PNAConfig, pna_cfg.smoke_config(), j_pna.init_params,
            None),
    "dimenet": (j_dimenet, dimenet, dimenet_cfg.make_batch,
                j_dimenet_cfg.make_batch, j_dimenet.DimeNetConfig,
                dimenet_cfg.smoke_config(), j_dimenet.init_params, None),
    "graphcast": (j_graphcast, graphcast,
                  partial(graphcast_cfg.make_batch, d_in=12),
                  partial(j_graphcast_cfg.make_batch, d_in=12),
                  j_graphcast.GraphCastConfig,
                  graphcast_cfg.smoke_config(), _gcast_init, None),
    # indices past the node sets (the reference's m2g arrays at widths
    # where the grid outgrows the padded mesh, or the mesh the grid)
    "graphcast_grid_past_mesh": (
        j_graphcast, graphcast, partial(graphcast_cfg.make_batch, d_in=12),
        partial(j_graphcast_cfg.make_batch, d_in=12),
        j_graphcast.GraphCastConfig, graphcast_cfg.smoke_config(),
        _gcast_init, dict(n=600, e=0, d_feat=12)),
    "graphcast_mesh_past_grid": (
        j_graphcast, graphcast, partial(graphcast_cfg.make_batch, d_in=12),
        partial(j_graphcast_cfg.make_batch, d_in=12),
        j_graphcast.GraphCastConfig, graphcast_cfg.smoke_config(),
        _gcast_init, dict(n=32, e=0, d_feat=12)),
}


def _model_case(name, seed=0):
    """(reference module, port module, ref cfg, port cfg, reference params
    as numpy, port params, the reference batch as numpy)."""
    j_mod, t_mod, _, j_make, j_cfg_cls, cfg, j_init, dims = MODELS[name]
    j_cfg = j_cfg_cls(**dataclasses.asdict(cfg))
    dims = dims or gc.gnn_smoke_dims()
    ref = jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(seed), j_cfg))
    batch = {k: np.asarray(v) for k, v in
             j_make(j_cfg, dims, abstract=False, seed=seed).items()}
    return j_mod, t_mod, j_cfg, cfg, ref, interop.gnn_params(
        ref, device="cpu"), batch


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {k: _t(v) for k, v in batch.items()}


class TestModels:
    @pytest.mark.parametrize("name", sorted(MODELS))
    def test_forward_and_loss(self, name):
        j_mod, t_mod, j_cfg, cfg, ref, params, batch = _model_case(name)
        want = np.asarray(j_mod.forward(ref, _jbatch(batch), j_cfg))
        got = t_mod.forward(params, _tbatch(batch), cfg)
        assert np.isfinite(want).all()
        _close(got, want, **FWD)
        _close(t_mod.loss_fn(params, _tbatch(batch), cfg),
               j_mod.loss_fn(ref, _jbatch(batch), j_cfg), **FWD)

    @pytest.mark.parametrize("name", sorted(MODELS))
    def test_gradients(self, name):
        j_mod, t_mod, j_cfg, cfg, ref, params, batch = _model_case(name, 1)
        want = jax.grad(j_mod.loss_fn)(jax.tree.map(jnp.asarray, ref),
                                       _jbatch(batch), j_cfg)
        leaves, spec = pytree.tree_flatten(params)
        loss = t_mod.loss_fn(params, _tbatch(batch), cfg)
        grads = pytree.tree_unflatten(
            list(torch.autograd.grad(loss, leaves)), spec)
        n = _close_trees(grads, jax.tree.map(np.asarray, want), **GRAD)
        assert n == len(jax.tree.leaves(want))

    @pytest.mark.parametrize("name", ["meshgraphnet", "pna", "dimenet",
                                      "graphcast"])
    def test_checkpointed_layers_keep_gradients(self, name):
        """Per-layer activation checkpointing recomputes in the backward
        pass; the gradients equal those of the same forward with autograd
        keeping every activation."""
        _, t_mod, _, cfg, _, params, batch = _model_case(name, 2)
        leaves, spec = pytree.tree_flatten(params)
        g1 = torch.autograd.grad(t_mod.loss_fn(params, _tbatch(batch), cfg),
                                 leaves)
        orig = common.checkpointed
        try:
            for mod in (meshgraphnet, pna, dimenet, graphcast):
                mod.checkpointed = lambda fn, *a: fn(*a)
            g2 = torch.autograd.grad(
                t_mod.loss_fn(params, _tbatch(batch), cfg), leaves)
        finally:
            for mod in (meshgraphnet, pna, dimenet, graphcast):
                mod.checkpointed = orig
        for a, b in zip(g1, g2):
            torch.testing.assert_close(a, b, rtol=0, atol=0)

    def test_init_params_structure_and_requires_grad(self):
        for name in ("meshgraphnet", "pna", "dimenet", "graphcast"):
            j_mod, t_mod, j_cfg, cfg, ref, _, _ = _model_case(name)
            gen = torch.Generator().manual_seed(0)
            init = graphcast_cfg._init if name == "graphcast" else None
            ours = init(gen, cfg, 12) if init else t_mod.init_params(gen, cfg)
            for path, a, b in _pairs(ours, ref):
                assert tuple(a.shape) == b.shape, (name, path)
                assert a.requires_grad and a.dtype == torch.float32, path

    def test_dimenet_bases(self):
        r = _rng(17)
        d = r.random(50).astype(np.float32) * 6
        ang = r.random(50).astype(np.float32) * 3
        np.testing.assert_allclose(
            _np(dimenet.radial_basis(_t(d), 6, 5.0)),
            np.asarray(j_dimenet.radial_basis(jnp.asarray(d), 6, 5.0)), **FWD)
        np.testing.assert_allclose(
            _np(dimenet.spherical_basis(_t(d), _t(ang), 7, 6, 5.0)),
            np.asarray(j_dimenet.spherical_basis(jnp.asarray(d),
                                                 jnp.asarray(ang), 7, 6,
                                                 5.0)), **FWD)


# --------------------------------------------------------- host builders --
class TestHostArraysEqual:
    @pytest.mark.parametrize("seed", [0, 3])
    def test_build_csr(self, seed):
        g = generators.powerlaw_ba(300, 3, seed=seed)
        a, b = sampler.build_csr(g), j_sampler.build_csr(
            j_generators.powerlaw_ba(300, 3, seed=seed))
        assert a.n == b.n
        np.testing.assert_array_equal(a.row_ptr, b.row_ptr)
        np.testing.assert_array_equal(a.col_idx, b.col_idx)

    @pytest.mark.parametrize("ppr", [False, True])
    def test_neighbor_sampler(self, ppr):
        g = generators.powerlaw_ba(400, 3, seed=1)
        w = _rng(18).random(400) if ppr else None
        seeds = _rng(19).choice(400, 24, replace=False)
        a = sampler.NeighborSampler(g, (5, 3), w, seed=7).sample(seeds)
        b = j_sampler.NeighborSampler(
            j_generators.powerlaw_ba(400, 3, seed=1), (5, 3), w,
            seed=7).sample(seeds)
        assert len(a) == len(b) == 2
        for x, y in zip(a, b):
            for f in ("nodes", "src", "dst_local", "mask"):
                np.testing.assert_array_equal(getattr(x, f), getattr(y, f))

    @pytest.mark.parametrize("ppr", [False, True])
    @pytest.mark.parametrize("step", [0, 5])
    def test_graph_batch_pipeline(self, ppr, step):
        g = generators.powerlaw_ba(300, 3, seed=1)
        r = _rng(20)
        feats = r.standard_normal((300, 6)).astype(np.float32)
        targs = r.standard_normal((300, 2)).astype(np.float32)
        w = r.random(300) if ppr else None
        pipe = GraphBatchPipeline(g, feats, targs, 16, (4, 3), seed=2,
                                  ppr_weights=w, device="cpu")
        jpipe = j_data.GraphBatchPipeline(
            j_generators.powerlaw_ba(300, 3, seed=1), feats, targs, 16,
            (4, 3), seed=2, ppr_weights=w)
        # twice: the port's sampler (built once) is reseeded per batch
        for _ in range(2):
            got, want = pipe.batch(step), jpipe.batch(step)
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].device.type == "cpu"
                np.testing.assert_array_equal(_np(got[k]),
                                              np.asarray(want[k]), err_msg=k)

    @pytest.mark.parametrize("shape", ["full_graph_sm", "molecule"])
    def test_graph_arrays(self, shape):
        dims = gc.GNN_SHAPES[shape]
        assert dims == j_gc.GNN_SHAPES[shape]
        got = gc.graph_arrays(dims, seed=4)
        want = j_gc.graph_arrays(dims, abstract=False, seed=4)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == np.asarray(want[k]).dtype
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))

    def test_shapes_and_flops_match(self):
        assert gc.GNN_SHAPES == j_gc.GNN_SHAPES
        assert gc._sampled_dims(1024, (15, 10)) == \
            j_gc._sampled_dims(1024, (15, 10))
        for t_cfg, j_cfg in ((mgn_cfg, j_mgn_cfg), (pna_cfg, j_pna_cfg),
                             (dimenet_cfg, j_dimenet_cfg),
                             (graphcast_cfg, j_graphcast_cfg)):
            assert dataclasses.asdict(t_cfg.full_config(602)) == \
                dataclasses.asdict(j_cfg.full_config(602))
            assert dataclasses.asdict(t_cfg.smoke_config()) == \
                dataclasses.asdict(j_cfg.smoke_config())
            for dims in j_gc.GNN_SHAPES.values():
                cfg = t_cfg.full_config(dims["d_feat"])
                assert t_cfg.model_flops(cfg, dims) == j_cfg.model_flops(
                    j_cfg.full_config(dims["d_feat"]), dims)

    @pytest.mark.parametrize("refinement", [0, 2, 4])
    def test_mesh_topology(self, refinement):
        for a, b in zip(graphcast.mesh_topology(refinement, seed=3),
                        j_graphcast.mesh_topology(refinement, seed=3)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)

    @pytest.mark.parametrize("n_grid,n_mesh,per", [(100, 42, 4),
                                                   (3072, 40962, 3)])
    def test_grid_mesh_edges(self, n_grid, n_mesh, per):
        for a, b in zip(graphcast.grid_mesh_edges(n_grid, n_mesh, per, 5),
                        j_graphcast.grid_mesh_edges(n_grid, n_mesh, per, 5)):
            np.testing.assert_array_equal(a, b)

    @pytest.mark.parametrize("n_grid", [96, 600])
    def test_graphcast_topology_arrays(self, n_grid):
        cfg = graphcast_cfg.smoke_config()
        dims = dict(n=n_grid, e=0, d_feat=12)
        want = j_graphcast_cfg.make_batch(
            j_graphcast.GraphCastConfig(**dataclasses.asdict(cfg)), dims,
            abstract=False, seed=2, d_in=12)
        got = graphcast_cfg.make_batch(cfg, dims, seed=2, d_in=12,
                                       device="cpu")
        assert sorted(got) == sorted(want)
        for k in graphcast_cfg.topology_arrays(cfg, n_grid, seed=2):
            np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]),
                                          err_msg=k)
        for k in want:
            assert tuple(got[k].shape) == want[k].shape, k

    @pytest.mark.parametrize("per_edge", [2, 8])
    def test_build_triplets(self, per_edge):
        r = _rng(21)
        snd = r.integers(0, 50, 400).astype(np.int32)
        rcv = r.integers(0, 50, 400).astype(np.int32)
        for a, b in zip(dimenet.build_triplets(snd, rcv, 50, per_edge, 4),
                        j_dimenet.build_triplets(snd, rcv, 50, per_edge, 4)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)

    @pytest.mark.parametrize("name", ["meshgraphnet", "pna", "dimenet"])
    def test_make_batch_index_arrays(self, name):
        t_make, j_make = {"meshgraphnet": (mgn_cfg, j_mgn_cfg),
                          "pna": (pna_cfg, j_pna_cfg),
                          "dimenet": (dimenet_cfg, j_dimenet_cfg)}[name]
        cfg = t_make.smoke_config()
        dims = gc.gnn_smoke_dims()
        got = t_make.make_batch(cfg, dims, seed=3, device="cpu")
        want = j_make.make_batch(type(j_make.smoke_config())(
            **dataclasses.asdict(cfg)), dims, abstract=False, seed=3)
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert tuple(got[k].shape) == v.shape, k
            if v.dtype == jnp.int32 or k in ("deg", "t_mask", "node_mask"):
                np.testing.assert_array_equal(_np(got[k]), np.asarray(v))


# ----------------------------------------------------------------- smoke --
SMOKE = {"meshgraphnet": mgn_cfg, "pna": pna_cfg, "dimenet": dimenet_cfg,
         "graphcast": graphcast_cfg}


class TestSmokeRun:
    @pytest.mark.parametrize("name", sorted(SMOKE))
    def test_finite(self, name):
        out = SMOKE[name].smoke_run(seed=0, device="cpu")
        assert sorted(out) == ["grad_norm", "loss"]
        for k, v in out.items():
            assert v.ndim == 0 and bool(torch.isfinite(v)), (name, k)

    @pytest.mark.parametrize("name", sorted(SMOKE))
    def test_deterministic(self, name):
        a = SMOKE[name].smoke_run(seed=0, device="cpu")
        b = SMOKE[name].smoke_run(seed=0, device="cpu")
        c = SMOKE[name].smoke_run(seed=1, device="cpu")
        for k in a:
            assert torch.equal(a[k], b[k]), (name, k)
        assert not torch.equal(a["loss"], c["loss"])


class TestInterop:
    def test_gnn_params_tree(self):
        ref = jax.tree.map(np.asarray, j_mgn.init_params(
            jax.random.PRNGKey(0), j_mgn.MeshGraphNetConfig(
                **dataclasses.asdict(mgn_cfg.smoke_config()))))
        ours = interop.gnn_params(ref, device="cpu")
        assert isinstance(ours["layers"]["edge"]["mlp"], list)
        assert ours["layers"]["edge"]["mlp"][0]["w"].shape[0] == 3
        for path, a, b in _pairs(ours, ref):
            assert a.requires_grad, path
            np.testing.assert_array_equal(_np(a), b)
