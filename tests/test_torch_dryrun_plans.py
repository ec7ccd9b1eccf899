"""The port's dry-run plans (`configs.*.build`, `configs.base`) and spec
builders (`distributed.sharding`) against the JAX package's.

For every registry cell that is not skipped (43), with multi_pod False
and, for the LM and cpaa-pagerank cells, also True: every abstract leaf's
shape and dtype by path, every spec as a tuple, `donate`, `note`,
`static["microbatches"]`, `cost_model` L and M (and a probe that builds)
and `model_flops` (rel 1e-12). The spec builders directly on the smoke
and full configs, and `shard_shape` against the division written out on
the (16, 16) and (2, 16, 16) meshes. Nothing here allocates a full-size
tensor: the port's abstract leaves are meta tensors.
"""
import numpy as np
import pytest
import torch

import jax
from jax.sharding import PartitionSpec as JP

from repro.configs import registry as ref_registry
from repro.distributed import sharding as ref_shard
from repro_torch.configs import registry
from repro_torch.configs.base import DryRunPlan, abstract_call, \
    abstract_tree
from repro_torch.distributed import sharding as shard
from repro_torch.distributed.sharding import P

LM = ("qwen2.5-32b", "h2o-danube-1.8b", "deepseek-7b",
      "granite-moe-3b-a800m", "qwen3-moe-235b-a22b")
TWO_MESHES = LM + ("cpaa-pagerank",)


def _cases():
    out = []
    for arch, cell in ref_registry.all_cells():
        if cell.skip_reason:
            continue
        for mp in ((False, True) if arch in TWO_MESHES else (False,)):
            out.append((arch, cell.shape, mp))
    return out


CASES = _cases()


def _walk(tree, is_leaf, path=()):
    """[(path, leaf)] over dicts (sorted keys), lists and tuples."""
    if is_leaf(tree):
        return [(path, tree)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in
                _walk(tree[k], is_leaf, path + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in
                _walk(v, is_leaf, path + (str(i),))]
    return [(path, tree)]


def _ref_leaves(tree):
    return [(p, tuple(x.shape), str(x.dtype)) for p, x in
            _walk(tree, lambda x: isinstance(x, jax.ShapeDtypeStruct))]


def _port_leaves(tree):
    return [(p, tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for p, x in _walk(tree, lambda x: isinstance(x, torch.Tensor))]


def _ref_specs(tree):
    return [(p, tuple(s)) for p, s in
            _walk(tree, lambda x: isinstance(x, JP))]


def _port_specs(tree):
    return [(p, tuple(s)) for p, s in
            _walk(tree, lambda x: isinstance(x, P))]


@pytest.fixture(scope="module")
def plans():
    cache = {}

    def get(arch, shape, mp):
        key = (arch, shape, mp)
        if key not in cache:
            cache[key] = (ref_registry.get(arch).build(shape, mp),
                          registry.get(arch).build(shape, mp))
        return cache[key]
    return get


@pytest.mark.parametrize("arch,shape,mp", CASES,
                         ids=[f"{a}-{s}-{'2pod' if m else '1pod'}"
                              for a, s, m in CASES])
def test_plan_matches_reference(plans, arch, shape, mp):
    ref, got = plans(arch, shape, mp)
    assert isinstance(got, DryRunPlan)
    port_leaves = _port_leaves(got.abstract_args)
    assert all(x.device.type == "meta" for x in
               torch.utils._pytree.tree_leaves(got.abstract_args))
    assert port_leaves == _ref_leaves(ref.abstract_args)
    assert _port_specs(got.in_specs) == _ref_specs(ref.in_specs)
    assert tuple(got.donate) == tuple(ref.donate)
    assert got.note == ref.note
    assert got.static.get("microbatches") == ref.static.get("microbatches")
    assert got.model_flops == pytest.approx(ref.model_flops, rel=1e-12)
    assert (got.cost_model is None) == (ref.cost_model is None)
    if ref.cost_model:
        assert got.cost_model["L"] == ref.cost_model["L"]
        assert got.cost_model["M"] == ref.cost_model["M"]
    assert (got.step is None) == (ref.step is None)
    assert callable(got.step or got.static["step_builder"])
    assert callable(got.static["make_args"])


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "qwen3-moe-235b-a22b",
                                  "pna", "cpaa-pagerank"])
def test_probe_plans_match_reference(arch):
    """The cost model's probe at L = 1, M = 1 (and M = 2 where M > 1)
    builds the reference's reduced plan."""
    cell = next(c for c in ref_registry.get(arch).cells()
                if not c.skip_reason)
    ref = ref_registry.get(arch).build(cell.shape, False)
    got = registry.get(arch).build(cell.shape, False)
    for lm in ((1, 1), (1, 2)) if ref.cost_model["M"] > 1 else ((1, 1),):
        r, g = ref.cost_model["probe"](*lm), got.cost_model["probe"](*lm)
        assert _port_leaves(g.abstract_args) == \
            _ref_leaves(r.abstract_args)
        assert g.model_flops == pytest.approx(r.model_flops, rel=1e-12)
        assert g.static.get("microbatches") == r.static.get("microbatches")


def test_pagerank_serve_build_raises_as_the_reference():
    with pytest.raises(NotImplementedError) as ref_err:
        ref_registry.get("pagerank-serve").build("x", False)
    with pytest.raises(NotImplementedError) as err:
        registry.get("pagerank-serve").build("x", False)
    assert str(err.value) == str(ref_err.value)


def test_make_args_match_the_abstract_args():
    """The real arguments of a small cell have the plan's shapes and
    dtypes, on the device asked for, integer leaves in range."""
    plan = registry.get("pna").build("molecule", False)
    args = plan.static["make_args"](seed=0, device="cpu")
    assert _port_leaves(abstract_tree(args)) == \
        _port_leaves(plan.abstract_args)
    batch = args[2]
    n = batch["node_feat"].shape[0]
    for k in ("senders", "receivers"):
        assert 0 <= int(batch[k].min()) and int(batch[k].max()) < n


def test_abstract_call_allocates_nothing():
    """qwen3's full parameter tree (235B parameters) as meta tensors."""
    from repro_torch.configs import qwen3_moe_235b
    from repro_torch.models import transformer as tf
    cfg = qwen3_moe_235b.full_config()
    tree = abstract_call(tf.init_params, torch.Generator(), cfg)
    leaves = torch.utils._pytree.tree_leaves(tree)
    assert {x.device.type for x in leaves} == {"meta"}
    # n_params counts the embedding and head at the unpadded vocabulary
    pad = 2 * (cfg.vocab_padded - cfg.vocab) * cfg.d_model
    assert sum(x.numel() for x in leaves) == cfg.n_params() + pad


# ---------------------------------------------------------- spec builders --

def _lm_configs():
    out = []
    for arch in LM:
        for which in ("smoke_config", "full_config"):
            out.append((arch, which))
    return out


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch,which", _lm_configs())
def test_lm_specs_match_reference(arch, which, multi_pod):
    ref_cfg = getattr(ref_registry.get(arch), which)()
    cfg = getattr(registry.get(arch), which)()
    ref_p = ref_shard.lm_param_specs(ref_cfg, multi_pod)
    got_p = shard.lm_param_specs(cfg, multi_pod)
    assert _port_specs(got_p) == _ref_specs(ref_p)
    assert _port_specs(shard.lm_opt_specs(got_p)) == \
        _ref_specs(ref_shard.lm_opt_specs(ref_p))
    assert _port_specs(shard.lm_batch_specs(multi_pod)) == \
        _ref_specs(ref_shard.lm_batch_specs(multi_pod))
    assert tuple(shard.lm_cache_spec(multi_pod)) == \
        tuple(ref_shard.lm_cache_spec(multi_pod))
    assert shard.flat_axes(multi_pod) == ref_shard.flat_axes(multi_pod)
    assert shard.batch_axes(multi_pod) == ref_shard.batch_axes(multi_pod)


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("which", ["smoke_config", "full_config"])
def test_dlrm_and_replicated_specs_match_reference(which, multi_pod):
    from repro.models.recsys import dlrm as ref_dlrm
    from repro_torch.models.recsys import dlrm
    ref_cfg = getattr(ref_registry.get("dlrm-rm2"), which)()
    cfg = getattr(registry.get("dlrm-rm2"), which)()
    ref_a = jax.eval_shape(lambda k: ref_dlrm.init_params(k, ref_cfg),
                           jax.random.PRNGKey(0))
    got_a = abstract_call(dlrm.init_params, cfg, device="cpu")
    assert _port_specs(shard.dlrm_param_specs(got_a, multi_pod)) == \
        _ref_specs(ref_shard.dlrm_param_specs(ref_a, multi_pod))
    assert _port_specs(shard.replicated_specs(got_a)) == \
        _ref_specs(ref_shard.replicated_specs(ref_a))


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("shape", ["molecule", "ogb_products",
                                   "minibatch_lg"])
def test_gnn_batch_specs_match_reference(shape, multi_pod):
    """GraphCast's batch mixes arrays that tile the mesh with the mesh
    arrays that do not."""
    from repro.configs import gnn_common as ref_gc, graphcast as ref_gcast
    from repro_torch.configs import gnn_common as gc, graphcast
    dims = gc.GNN_SHAPES[shape]
    ref_b = ref_gcast.make_batch(ref_gcast.full_config(), dims,
                                 abstract=True)
    got_b = graphcast.make_batch(graphcast.full_config(), dims,
                                 abstract=True)
    assert _port_specs(shard.gnn_batch_specs(got_b, multi_pod)) == \
        _ref_specs(ref_shard.gnn_batch_specs(ref_b, multi_pod))
    assert ref_gc.GNN_SHAPES[shape] == dims


def test_maybe_shard_and_shard_activation_are_identities():
    x = torch.ones(4, 3)
    assert shard.maybe_shard(x, "data", None) is x
    assert shard.shard_activation(x, "batch", "tp") is x


def test_p_is_a_tuple_leaf():
    spec = P(("data", "model"), None)
    assert tuple(spec) == tuple(JP(("data", "model"), None))
    assert spec == (("data", "model"), None)
    assert torch.utils._pytree.tree_leaves({"a": spec}) == [spec]
    assert repr(P()) == "P()"


MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


@pytest.mark.parametrize("mesh", list(MESHES))
def test_shard_shape_against_the_division(mesh):
    sizes = MESHES[mesh]
    pods = sizes.get("pod", 1)
    assert shard.shard_shape((4096, 512), P("data", "model"), sizes) == \
        (4096 // 16, 512 // 16)
    assert shard.shard_shape((94, 128, 4096, 1536),
                             P(None, "model", "data", None), sizes) == \
        (94, 128 // 16, 4096 // 16, 1536)
    flat = ("pod", "data", "model") if pods > 1 else ("data", "model")
    assert shard.shard_shape((1 << 26,), P(flat), sizes) == \
        ((1 << 26) // (256 * pods),)
    batch = ("pod", "data") if pods > 1 else ("data",)
    assert shard.shard_shape((256, 4097), P(batch, None), sizes) == \
        (256 // (16 * pods), 4097)
    # uneven: rounded up, as an uneven split pads
    assert shard.shard_shape((40962, 4), P(flat, None), sizes) == \
        (-(-40962 // (256 * pods)), 4)
    assert shard.shard_shape((3, 5), P(), sizes) == (3, 5)
    assert shard.shard_shape((), P(), sizes) == ()


def test_shard_shape_of_every_qwen3_leaf_divides_exactly():
    """qwen3's parameters on the (16, 16) mesh: per-device elements times
    the mesh's 256 devices over the elements of the sharded leaves."""
    plan = registry.get("qwen3-moe-235b-a22b").build("train_4k", False)
    sizes = MESHES["16x16"]
    params, pspecs = plan.abstract_args[0], plan.in_specs[0]
    leaves = _port_leaves(params)
    specs = dict(_port_specs(pspecs))
    for path, shape, _ in leaves:
        per = shard.shard_shape(shape, P(*specs[path]), sizes)
        k = 1
        for e in specs[path]:
            if e is not None:
                k *= 16
        assert np.prod(per) * k == np.prod(shape), path
