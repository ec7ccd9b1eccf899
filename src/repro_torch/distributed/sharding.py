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

Sharded execution. `local_shard(x, spec, mesh)` is this rank's piece of
a whole tensor under a spec, `shard_tree` maps it over a tree and
`gather_tree` puts the pieces back together (tests). The split rule is
`shard_shape`'s, the one GSPMD pads: a dimension of n over k ranks
gives every rank c = ceil(n / k) entries, rank i holding [i c, (i + 1)
c) of them clipped to n and zero-padded to c, so the last ranks hold
padding or nothing (`split`). Under `use_mesh(mesh, sharded=True)` the
models take their parameters as such local shards (`params_sharded()`)
and run SPMD: each rank computes on its shards and calls the collectives
of `distributed.parallel` explicitly, so `collective_counts` sees every
trip. Without `sharded` a mesh changes only what it changed before (the
all-to-all MoE, the data-parallel mean of whole gradients).

`maybe_shard` and `shard_activation` stay identities: the reference's
are layout constraints for XLA's partitioner, which the port has not;
its layouts are the explicit collectives above. `shard_map_compat` has
no counterpart: the port is SPMD already.
"""
from __future__ import annotations

import contextlib

import torch
from torch.utils import _pytree as pytree

__all__ = ["use_mesh", "current_mesh", "params_sharded", "axis_size",
           "axis_index", "P", "flat_axes", "batch_axes", "maybe_shard",
           "shard_activation", "split", "axes_of", "local_shard",
           "shard_tree", "gather_tree",
           "lm_param_specs", "lm_opt_specs", "lm_batch_specs",
           "lm_cache_spec", "gnn_batch_specs", "replicated_specs",
           "dlrm_param_specs", "shard_shape"]

_ACTIVE: list = []     # stack of (mesh, sharded) entered with use_mesh


@contextlib.contextmanager
def use_mesh(mesh, sharded: bool = False):
    """Make `mesh` the active mesh inside the block (None: no mesh, so
    model code takes its single-rank paths). `sharded`: the models'
    parameters are this rank's local shards under their specs (module
    docstring). Process-wide, so the autograd engine's threads see it
    too; nests."""
    _ACTIVE.append((mesh, bool(sharded) and mesh is not None))
    try:
        yield mesh
    finally:
        _ACTIVE.pop()


def current_mesh():
    """The innermost mesh of `use_mesh`, or None."""
    return _ACTIVE[-1][0] if _ACTIVE else None


def params_sharded() -> bool:
    """True inside `use_mesh(mesh, sharded=True)` (innermost block)."""
    return bool(_ACTIVE) and _ACTIVE[-1][1]


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
    """x: the reference pins x to `spec` for XLA's partitioner under a
    mesh. The port has no partitioner to pin for: its sharded layouts are
    made by explicit collectives (`distributed.parallel`), so this stays
    an identity."""
    del spec
    return x


def shard_activation(x, *roles):
    """x: the reference's role-based activation constraint, an identity
    here for the reason `maybe_shard` gives."""
    del roles
    return x


# ------------------------------------------------------------ local shards --

def split(n: int, k: int, i: int) -> tuple[int, int, int]:
    """(lo, hi, c): rank i of k holds entries [lo, hi) of a dimension of n,
    padded to c = ceil(n / k) (`shard_shape`'s count; the last ranks may
    hold fewer entries, or none)."""
    c = -(-int(n) // int(k))
    lo = min(i * c, n)
    return lo, min(lo + c, n), c


def axes_of(entry) -> tuple:
    """The axis names of one spec entry (None: none)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _coordinate(mesh, entry) -> tuple[int, int]:
    """(index, count) of this rank over the axes of one spec entry, in
    row-major order of the named axes (a mesh without one counts 1)."""
    idx, k = 0, 1
    for a in axes_of(entry):
        size = axis_size(mesh, a)
        idx = idx * size + axis_index(mesh, a)
        k *= size
    return idx, k


def _dims(spec, ndim: int) -> tuple:
    return tuple(spec) + (None,) * (ndim - len(spec))


def local_shard(x, spec, mesh):
    """This rank's piece of the whole tensor x under `spec` on `mesh`:
    along each sharded dimension its `split` range, zero-padded to the
    even count, so the piece has `shard_shape`'s shape. Works on meta
    tensors."""
    for d, entry in enumerate(_dims(spec, x.ndim)):
        idx, k = _coordinate(mesh, entry)
        if k == 1:
            continue
        lo, hi, c = split(x.shape[d], k, idx)
        piece = x.narrow(d, lo, hi - lo)
        if hi - lo < c:
            pad = list(x.shape)
            pad[d] = c - (hi - lo)
            piece = torch.cat([piece, x.new_zeros(pad)], dim=d)
        x = piece
    return x.contiguous()


def _is_spec(s) -> bool:
    return isinstance(s, P)


def shard_tree(tree, specs, mesh):
    """`local_shard` of every leaf of `tree` under the matching spec of
    `specs` (a tree of `P` of the same structure; None leaves whole)."""
    if specs is None:
        return tree
    if _is_spec(specs):
        return local_shard(tree, specs, mesh)
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_tree(v, s, mesh)
                          for v, s in zip(tree, specs))
    raise TypeError(f"no spec for {type(tree)}")


def gather_tree(tree, specs, mesh, like):
    """The inverse of `shard_tree`: every leaf all-gathered over the axes
    of its spec (not counted) and trimmed to the shape of the matching
    leaf of `like`. Every rank must call it."""
    from repro_torch.core import distributed as cdist
    if specs is None:
        return tree
    if _is_spec(specs):
        x = tree
        for d, entry in enumerate(_dims(specs, x.ndim)):
            for a in reversed(axes_of(entry)):
                if axis_size(mesh, a) > 1:
                    x = cdist.all_gather(x.movedim(d, 0),
                                         mesh.get_group(a)).movedim(0, d)
            x = x.narrow(d, 0, like.shape[d])
        return x.contiguous()
    if isinstance(tree, dict):
        return {k: gather_tree(v, specs[k], mesh, like[k])
                for k, v in tree.items()}
    return type(tree)(gather_tree(v, s, mesh, w)
                      for v, s, w in zip(tree, specs, like))


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
