"""The mesh that model code runs under, and the sharding plans of the
dry-run (port of `repro.distributed.sharding`).

The reference asks JAX for the active mesh (`_current_mesh`: a `with
mesh:` block) and runs the expert-parallel MoE under `shard_map` over its
"model" axis. The port is SPMD over ranks: every process runs the model
on its own shard, and the mesh is a torch `DeviceMesh` whose dimensions
carry the reference's axis names, ("data", "model"), built by
`core.distributed.init_mesh(shape, ("data", "model"), device)` (NCCL on
cuda, which raises without a GPU; gloo on the CPU). `use_mesh(mesh)`
makes it the active mesh and `current_mesh()` reads it.

Under a mesh, each rank feeds the model its shard of the batch: the rows
of its "data" coordinate, the same rows on every rank of a "model" group
(the reference's token spec `P(("data",), None, None)`).
`train.train_loop.make_train_step` takes the mean of the ranks'
gradients.

Axis roles of the reference's production mesh (`launch/mesh.py`):
  "pod"   outermost data parallelism across pods (multi-pod mesh only)
  "data"  data parallelism + FSDP/ZeRO shard axis within a pod
  "model" tensor parallelism (attention heads / FFN width / experts /
          embedding-table rows / KV-cache sequence for decode)

The spec builders (`lm_param_specs` ... `dlrm_param_specs`) give the
reference's plans as trees of `P`, one axis name, tuple of names or None
per dimension; `shard_shape` turns a shape, its spec and a mesh's axis
sizes into the shape each device holds (the dry-run's per-device bytes).
The port's models run no tensor or FSDP parallelism, so nothing shards a
tensor by these specs: `maybe_shard` and `shard_activation` are
identities (as the reference's are without a mesh). `shard_map_compat`
has no counterpart: the port is SPMD already.
"""
from __future__ import annotations

import contextlib

from torch.utils import _pytree as pytree

__all__ = ["use_mesh", "current_mesh", "axis_size", "axis_index", "P",
           "flat_axes", "batch_axes", "maybe_shard", "shard_activation",
           "lm_param_specs", "lm_opt_specs", "lm_batch_specs",
           "lm_cache_spec", "gnn_batch_specs", "replicated_specs",
           "dlrm_param_specs", "shard_shape"]

_ACTIVE: list = []     # stack of the meshes entered with use_mesh


@contextlib.contextmanager
def use_mesh(mesh):
    """Make `mesh` the active mesh inside the block (None: no mesh, so
    model code takes its single-rank paths). Process-wide, so the
    autograd engine's threads see it too; nests."""
    _ACTIVE.append(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.pop()


def current_mesh():
    """The innermost mesh of `use_mesh`, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def _names(mesh) -> tuple:
    return tuple(mesh.mesh_dim_names or ())


def axis_size(mesh, name: str) -> int:
    """Ranks along dimension `name` of `mesh` (1 when it has none)."""
    names = _names(mesh)
    return int(mesh.mesh.shape[names.index(name)]) if name in names else 1


def axis_index(mesh, name: str) -> int:
    """This rank's coordinate along dimension `name` (0 when it has none)."""
    return int(mesh.get_local_rank(name)) if name in _names(mesh) else 0


# ------------------------------------------------------------------ specs --

class P(tuple):
    """A partition spec: per dimension an axis name, a tuple of names
    (sharded over their product) or None (whole); a one-name tuple is
    that name, as `PartitionSpec` normalizes it. A tuple, so
    `tuple(spec)` compares with the reference's `PartitionSpec`; a leaf
    of torch's pytrees."""

    def __new__(cls, *dims):
        return super().__new__(cls, tuple(
            d[0] if isinstance(d, tuple) and len(d) == 1 else d
            for d in dims))

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


def flat_axes(multi_pod: bool) -> tuple:
    """All mesh axes, for flattened node/edge sharding (GNN/pagerank)."""
    return ("pod", "data", "model") if multi_pod else ("data", "model")


def batch_axes(multi_pod: bool) -> tuple:
    return ("pod", "data") if multi_pod else ("data",)


def maybe_shard(x, *spec):
    """x: the reference pins x to `spec` under a mesh (a no-op on one
    device); the port shards no tensor by spec."""
    del spec
    return x


def shard_activation(x, *roles):
    """x: the reference's role-based activation constraint, an identity
    here as `maybe_shard` is."""
    del roles
    return x


def _axis_count(entry, mesh_shape: dict) -> int:
    if entry is None:
        return 1
    names = entry if isinstance(entry, tuple) else (entry,)
    k = 1
    for a in names:
        k *= int(mesh_shape[a])
    return k


def shard_shape(shape, spec, mesh_shape: dict) -> tuple:
    """The shape one device holds of a tensor of `shape` laid out by
    `spec` on a mesh of axis sizes `mesh_shape` ({"data": 16, ...}): each
    dimension divided by the product of its axes' sizes, rounded up (an
    uneven split pads, as GSPMD's does). A spec shorter than the shape
    leaves the trailing dimensions whole."""
    dims = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(-(-int(n) // _axis_count(e, mesh_shape))
                 for n, e in zip(shape, dims))


# ------------------------------------------------------------------- LM ----

def lm_param_specs(cfg, multi_pod: bool) -> dict:
    """P tree matching models.transformer.init_params(cfg) (Megatron TP x
    FSDP: attention / MLP weights over (data, model), experts over model
    when their count tiles it, vocab over model)."""
    del multi_pod
    fsdp = "data"
    tp = "model"
    layer = {
        "ln1": P(None, None),
        "ln2": P(None, None),
        "wq": P(None, fsdp, tp),
        "wk": P(None, fsdp, tp),
        "wv": P(None, fsdp, tp),
        "wo": P(None, tp, fsdp),
    }
    if cfg.qkv_bias:
        layer["bq"] = P(None, tp)
        layer["bk"] = P(None, tp)
        layer["bv"] = P(None, tp)
    if cfg.moe:
        if cfg.moe.n_experts % 16 == 0:
            # expert parallelism: experts tile the model axis
            layer["moe"] = {
                "router": P(None, fsdp, None),
                "w1": P(None, tp, fsdp, None),
                "w3": P(None, tp, fsdp, None),
                "w2": P(None, tp, None, fsdp),
            }
        else:
            # the expert count does not tile the 16-way axis (granite: 40)
            # -> intra-expert tensor parallelism over d_ff
            layer["moe"] = {
                "router": P(None, fsdp, None),
                "w1": P(None, None, fsdp, tp),
                "w3": P(None, None, fsdp, tp),
                "w2": P(None, None, tp, fsdp),
            }
    else:
        layer["w1"] = P(None, fsdp, tp)
        layer["w3"] = P(None, fsdp, tp)
        layer["w2"] = P(None, tp, fsdp)
    return {
        "embed": P(tp, None),
        "layers": layer,
        "final_ln": P(None),
        "lm_head": P(None, tp),
    }


def lm_opt_specs(param_specs) -> dict:
    """AdamW state: m and v mirror the parameter sharding; step whole."""
    return {"step": P(), "m": param_specs, "v": param_specs}


def lm_batch_specs(multi_pod: bool) -> dict:
    return {"tokens": P(batch_axes(multi_pod), None)}


def lm_cache_spec(multi_pod: bool) -> P:
    """KV cache [L, B, S, Hkv, Dh]: batch over data, sequence over
    model."""
    return P(None, batch_axes(multi_pod), "model", None, None)


# ------------------------------------------------------------------ GNN ----

def gnn_batch_specs(batch_tree, multi_pod: bool):
    """Node/edge arrays over all axes on dim 0 when the size tiles the
    mesh; arrays that do not tile it (the 40,962-node icosphere) and
    scalars whole."""
    ax = flat_axes(multi_pod)
    n_dev = 512 if multi_pod else 256

    def spec_for(leaf):
        if leaf.ndim == 0 or leaf.shape[0] % n_dev:
            return P(*([None] * leaf.ndim))
        return P(ax, *([None] * (leaf.ndim - 1)))

    return pytree.tree_map(spec_for, batch_tree)


def replicated_specs(tree):
    return pytree.tree_map(
        lambda leaf: P(*([None] * getattr(leaf, "ndim", 0))), tree)


# ----------------------------------------------------------------- DLRM ----

def dlrm_param_specs(abstract_params, multi_pod: bool) -> dict:
    """The combined embedding table row-sharded over model (the RM2
    layout); the MLPs whole (they are tiny)."""
    del multi_pod

    def walk(tree, in_table: bool):
        if isinstance(tree, dict):
            return {k: walk(v, in_table or k == "table")
                    for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, in_table) for v in tree)
        if in_table:
            return P("model", None)
        return P(*([None] * tree.ndim))
    return walk(abstract_params, False)
