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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils import _pytree as pytree

from repro_torch.graph.ops import segment_sum
from repro_torch.models.layers import (checkpointed, layer_norm, mlp_apply,
                                       mlp_init)

__all__ = ["lnmlp_init", "lnmlp_apply", "interaction_init",
           "interaction_apply", "segment_std", "mse_loss", "stack_layers",
           "layer_slice", "n_stacked", "checkpointed", "requires_grad"]


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
                      n_nodes: int, aggregator: str = "sum"):
    """One residual interaction-network step (MeshGraphNet Eq. 1-2).

    h: [N, d_node]; e: [E, d_edge]; senders/receivers: [E] int32.
    """
    msg_in = torch.cat([e, h.index_select(0, senders),
                        h.index_select(0, receivers)], dim=-1)
    e_new = e + lnmlp_apply(p["edge"], msg_in)
    if aggregator == "sum":
        agg = segment_sum(e_new, receivers, n_nodes)
    elif aggregator == "mean":
        s = segment_sum(e_new, receivers, n_nodes)
        c = segment_sum(e.new_ones(receivers.shape), receivers, n_nodes)
        agg = s / torch.clamp(c, min=1.0)[:, None]
    else:
        raise ValueError(aggregator)
    h_new = h + lnmlp_apply(p["node"], torch.cat([h, agg], dim=-1))
    return h_new, e_new


def segment_std(x: torch.Tensor, seg: torch.Tensor, n: int,
                eps: float = 1e-5) -> torch.Tensor:
    cnt = torch.clamp(segment_sum(x.new_ones(seg.shape), seg, n),
                      min=1.0)[:, None]
    mu = segment_sum(x, seg, n) / cnt
    var = segment_sum(x.square(), seg, n) / cnt - mu.square()
    # torch.maximum, not clamp: at var == 0 it splits the gradient in
    # half, as jnp.maximum does
    return torch.sqrt(torch.maximum(var, var.new_zeros(())) + eps)


def mse_loss(pred: torch.Tensor, target: torch.Tensor,
             mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean squared error in at least float32; with a node mask, the sum
    over masked rows / (sum(mask) * d_out + 1e-9)."""
    dt = torch.promote_types(pred.dtype, torch.float32)
    se = (pred.to(dt) - target.to(dt)).square()
    if mask is not None:
        se = se * mask[:, None]
        return se.sum() / (mask.sum() * se.shape[-1] + 1e-9)
    return se.mean()


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
