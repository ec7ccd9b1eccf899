"""Shared GNN machinery (port of `repro.models.gnn.common`): MLP blocks,
interaction-network layers, the segment statistics and the loss.

All message passing is a gather (`index_select` of x[senders]) + a
segment reduction over receivers (`graph.ops.segment_sum`, an
`index_add_`), the same gather + scatter the COO PageRank engine runs.
Parameters are dicts and lists of tensors in the reference's layout;
models with a layer stack keep it stacked on a leading axis, which
`layer_slice` indexes one layer at a time. The reference's
`shard_activation` calls pin activations to a mesh and do nothing on one
device, so the port has none.

Partitioned message passing. The production plans shard a batch's node
and edge arrays over every mesh axis where their count tiles the mesh
(`sharding.gnn_batch_specs`), leaving the others whole; the reference's
GSPMD partitions the same program. The port runs SPMD on the pieces:
a `GraphLayout` (the batch's global row counts and which leaves are
sharded, from the plan's specs) is passed to a model's `forward` /
`loss_fn`, and under `use_mesh(mesh, sharded=True)` each node or edge set
is a `Rows`: its global count and whether this rank holds its `split`
piece or the whole set. Message passing then
  * gathers x[idx] (global ids) from the whole set: an all-gather of the
    pieces (`parallel.gather`) when the set is sharded, none when whole;
  * scatters into a whole-size array with the local rows (the padding
    rows of an uneven split masked out, since they hold sender and
    receiver 0), then reduce-scatters it to the target's pieces
    (`parallel.scatter_sum`), or all-reduces it into a whole target
    (`parallel.reduce_sum`), or takes the local piece of a sum of whole
    rows;
  * takes a segment max / min over every rank (`parallel.
    segment_extreme`).
So the models' index rules stay as they are, and the collective bytes
depend on the shapes only (meta tensors count them). Each rank's loss is
its part of the one global loss (`mse_loss`), so the replicated
parameters' gradient is the sum of the ranks' gradients
(`train_loop.make_train_step(grad_rule="sum")`). Without a layout, or
without a sharded mesh, every `Rows` is the plain whole set and the
models run as they did.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.utils import _pytree as pytree

from repro_torch.distributed import parallel
from repro_torch.distributed.sharding import axes_of, current_mesh, \
    params_sharded, split
from repro_torch.graph.ops import segment_max, segment_min, segment_sum
from repro_torch.models.layers import (checkpointed, layer_norm, mlp_apply,
                                       mlp_init)

__all__ = ["lnmlp_init", "lnmlp_apply", "interaction_init",
           "interaction_apply", "segment_std", "mse_loss", "stack_layers",
           "layer_slice", "n_stacked", "checkpointed", "requires_grad",
           "GraphLayout", "Rows", "rows_of", "TAG"]

TAG = "gnn"     # the collective counters' tag of the message passing


@dataclass(frozen=True)
class Rows:
    """One node or edge set of a batch: its global row count `n`, the flat
    mesh axes it runs over (() = no sharded mesh: the plain whole set)
    and whether this rank holds its `split` piece over them (else the
    whole set, replicated)."""
    n: int
    axes: tuple = ()
    sharded: bool = False

    def piece(self) -> tuple[int, int, int]:
        """(lo, hi, c): this rank's rows [lo, hi) of the set, padded to
        c (the whole set when not sharded)."""
        if not self.sharded:
            return 0, self.n, self.n
        return split(self.n, parallel.size(self.axes),
                     parallel.index(self.axes))

    def valid(self, like: torch.Tensor) -> torch.Tensor | None:
        """[c] bool: which local rows are real (None when all are)."""
        lo, hi, c = self.piece()
        if hi - lo == c:
            return None
        return torch.arange(c, device=like.device) < hi - lo

    def whole(self, x: torch.Tensor) -> torch.Tensor:
        """The whole set's rows (x: this rank's)."""
        if not self.sharded:
            return x
        return parallel.gather(x, 0, self.n, self.axes, TAG, "gather")

    def gather(self, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """x[idx] of the whole set, idx global ids."""
        return self.whole(x).index_select(0, idx)

    def scatter_sum(self, vals: torch.Tensor, seg: torch.Tensor,
                    src: "Rows", keep: torch.Tensor | None = None):
        """This set's local rows of the sum of src's rows `vals` by their
        segment ids `seg` (global ids of this set); `keep` (None: all)
        masks rows out as well as src's padding."""
        mask = src.valid(vals)
        if keep is not None:
            mask = keep if mask is None else keep & mask
        part = segment_sum(_zero_rows(vals, mask), seg, self.n)
        if src.sharded and self.sharded:
            return parallel.scatter_sum(part, 0, self.axes, TAG, "scatter")
        if src.sharded:
            return parallel.reduce_sum(part, self.axes, TAG, "scatter")
        if self.sharded:
            return parallel.local_piece(part, 0, self.axes)
        return part

    def extreme(self, vals: torch.Tensor, seg: torch.Tensor, src: "Rows",
                reduce: str) -> torch.Tensor:
        """This set's local rows of the segment max ("amax") / min
        ("amin") of src's rows; +-inf where a segment is empty."""
        if not (src.sharded or self.sharded):
            fn = segment_max if reduce == "amax" else segment_min
            return fn(vals, seg, self.n)
        return parallel.segment_extreme(vals, seg, self.n, reduce,
                                        self.axes, self.sharded, TAG,
                                        valid=src.valid(vals))

    def total(self, x: torch.Tensor) -> torch.Tensor:
        """The column sums of x over every row of the set (x: the local
        rows; padding rows left out), on every rank."""
        s = _zero_rows(x, self.valid(x)).sum(0)
        if self.sharded:
            s = parallel.reduce_sum(s, self.axes, TAG, "total")
        return s


def _zero_rows(x: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    """x with the rows where `mask` is False set to 0 (None: x)."""
    if mask is None:
        return x
    return torch.where(mask.reshape((-1,) + (1,) * (x.ndim - 1)), x,
                       x.new_zeros(()))


@dataclass(frozen=True)
class GraphLayout:
    """A batch's global row counts (`rows`: key -> dim-0 size) and which
    of its leaves lie sharded over the flat axes `axes` (the plan's specs,
    `GraphLayout.of`)."""
    rows: dict
    sharded: frozenset
    axes: tuple

    @classmethod
    def of(cls, batch, specs) -> "GraphLayout":
        """The layout of `batch` (whole leaves, real or meta) under
        `specs` (`sharding.gnn_batch_specs`)."""
        axes: tuple = ()
        sharded = set()
        for k, spec in specs.items():
            if len(spec) and spec[0] is not None:
                sharded.add(k)
                axes = axes_of(spec[0])
        return cls(rows={k: int(v.shape[0]) for k, v in batch.items()
                         if v.ndim},
                   sharded=frozenset(sharded), axes=axes)


def rows_of(batch, key: str, layout: GraphLayout | None) -> Rows:
    """The `Rows` of the set whose leaf is batch[key]: under a sharded
    mesh with a layout, its global count and sharding; else the plain
    whole set of the local leaf."""
    if layout is None or current_mesh() is None or not params_sharded():
        return Rows(batch[key].shape[0])
    return Rows(layout.rows[key], layout.axes, key in layout.sharded)


def lnmlp_init(gen: torch.Generator, dims) -> dict:
    """MLP + final LayerNorm (MeshGraphNet/GraphCast convention)."""
    return {"mlp": mlp_init(gen, dims),
            "ln_g": torch.ones(dims[-1], device=gen.device),
            "ln_b": torch.zeros(dims[-1], device=gen.device)}


def lnmlp_apply(p, x: torch.Tensor) -> torch.Tensor:
    return layer_norm(mlp_apply(p["mlp"], x, act=F.silu), p["ln_g"],
                      p["ln_b"])


def interaction_init(gen: torch.Generator, d_node: int, d_edge: int,
                     d_hidden: int, mlp_layers: int = 2) -> dict:
    e_dims = (d_edge + 2 * d_node,) + (d_hidden,) * (mlp_layers - 1) + \
        (d_edge,)
    n_dims = (d_node + d_edge,) + (d_hidden,) * (mlp_layers - 1) + (d_node,)
    return {"edge": lnmlp_init(gen, e_dims), "node": lnmlp_init(gen, n_dims)}


def interaction_apply(p, h: torch.Tensor, e: torch.Tensor,
                      senders: torch.Tensor, receivers: torch.Tensor,
                      n_nodes, aggregator: str = "sum",
                      edges: Rows | None = None):
    """One residual interaction-network step (MeshGraphNet Eq. 1-2).

    h: [N, d_node]; e: [E, d_edge]; senders/receivers: [E] int32.
    n_nodes: the node count, or the node set's `Rows` (sharded message
    passing, with the edge set's `edges`).
    """
    nodes = n_nodes if isinstance(n_nodes, Rows) else Rows(n_nodes)
    edges = edges or Rows(e.shape[0])
    hw = nodes.whole(h)
    msg_in = torch.cat([e, hw.index_select(0, senders),
                        hw.index_select(0, receivers)], dim=-1)
    e_new = e + lnmlp_apply(p["edge"], msg_in)
    if aggregator == "sum":
        agg = nodes.scatter_sum(e_new, receivers, edges)
    elif aggregator == "mean":
        s = nodes.scatter_sum(e_new, receivers, edges)
        c = nodes.scatter_sum(e.new_ones(receivers.shape), receivers, edges)
        agg = s / torch.clamp(c, min=1.0)[:, None]
    else:
        raise ValueError(aggregator)
    h_new = h + lnmlp_apply(p["node"], torch.cat([h, agg], dim=-1))
    return h_new, e_new


def segment_std(x: torch.Tensor, seg: torch.Tensor, n,
                eps: float = 1e-5, src: Rows | None = None) -> torch.Tensor:
    """Per-segment standard deviation of x's rows; n: the segment count,
    or the target set's `Rows` (with the rows' set `src`)."""
    nodes = n if isinstance(n, Rows) else Rows(n)
    src = src or Rows(x.shape[0])
    cnt = torch.clamp(nodes.scatter_sum(x.new_ones(seg.shape), seg, src),
                      min=1.0)[:, None]
    mu = nodes.scatter_sum(x, seg, src) / cnt
    var = nodes.scatter_sum(x.square(), seg, src) / cnt - mu.square()
    # torch.maximum, not clamp: at var == 0 it splits the gradient in
    # half, as jnp.maximum does
    return torch.sqrt(torch.maximum(var, var.new_zeros(())) + eps)


def mse_loss(pred: torch.Tensor, target: torch.Tensor,
             mask: torch.Tensor | None = None,
             rows: Rows | None = None) -> torch.Tensor:
    """Mean squared error in at least float32; with a node mask, the sum
    over masked rows / (sum(mask) * d_out + 1e-9). Under a sharded mesh
    (`rows` the prediction's set) this rank's part of it: its own rows'
    sum over the global denominator (the mask's sum all-reduced; padding
    rows left out), or, for a replicated set, the whole loss over the
    rank count, so the ranks' parts add up to the loss."""
    dt = torch.promote_types(pred.dtype, torch.float32)
    se = (pred.to(dt) - target.to(dt)).square()
    if rows is None or not rows.axes:
        if mask is not None:
            se = se * mask[:, None]
            return se.sum() / (mask.sum() * se.shape[-1] + 1e-9)
        return se.mean()
    se = _zero_rows(se, rows.valid(se))
    if mask is not None:
        se = se * mask[:, None]
        den = mask.detach().sum()
        if rows.sharded:
            den = parallel.all_sum(den, (rows.axes,), TAG, "loss")
        loss = se.sum() / (den * se.shape[-1] + 1e-9)
    else:
        loss = se.sum() / (rows.n * se.shape[-1])
    return loss if rows.sharded else loss / parallel.size(rows.axes)


def stack_layers(layers: list):
    """Per-layer parameter trees -> one tree whose leaves carry a leading
    layer axis (the reference's `tree.map(jnp.stack)`)."""
    return pytree.tree_map(lambda *xs: torch.stack(xs), *layers)


def n_stacked(tree) -> int:
    return pytree.tree_leaves(tree)[0].shape[0]


def layer_slice(tree, i: int):
    """Layer i of a stacked tree (views: gradients flow to the stack)."""
    return pytree.tree_map(lambda x: x[i], tree)


def requires_grad(tree):
    """Mark every leaf of a freshly built parameter tree as a parameter."""
    return pytree.tree_map(lambda t: t.requires_grad_(True), tree)
