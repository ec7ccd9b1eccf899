"""MeshGraphNet [arXiv:2010.03409] (port of
`repro.models.gnn.meshgraphnet`): encode-process-decode on a mesh graph.

15 interaction-network layers, d=128, sum aggregation, 2-layer MLPs with
LayerNorm, residual node+edge updates. The reference scans a
`jax.checkpoint`ed body over the layer-stacked parameters; the port loops
over the leading layer axis and checkpoints each layer, so the backward
pass keeps only each layer's (h, e) carry. With a `GraphLayout` under a
sharded mesh, each layer gathers the whole h and reduce-scatters its
aggregate (`common`'s partitioned message passing).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import torch

from repro_torch.models.gnn.common import (GraphLayout, checkpointed,
                                           interaction_apply,
                                           interaction_init, layer_slice,
                                           lnmlp_apply, lnmlp_init, mse_loss,
                                           n_stacked, requires_grad,
                                           rows_of, stack_layers)
from repro_torch.models.layers import mlp_apply, mlp_init

__all__ = ["MeshGraphNetConfig", "init_params", "forward", "loss_fn"]


@dataclass(frozen=True)
class MeshGraphNetConfig:
    name: str
    n_layers: int = 15
    d_hidden: int = 128
    mlp_layers: int = 2
    d_in_node: int = 16
    d_in_edge: int = 8
    d_out: int = 8
    aggregator: str = "sum"
    scan_unroll: bool = False


def init_params(gen: torch.Generator, cfg: MeshGraphNetConfig) -> dict:
    """Random f32 parameters on the generator's device, each a leaf with
    requires_grad."""
    d = cfg.d_hidden
    hid = (d,) * cfg.mlp_layers
    layers = [interaction_init(gen, d, d, d, cfg.mlp_layers)
              for _ in range(cfg.n_layers)]
    return requires_grad({
        "enc_node": lnmlp_init(gen, (cfg.d_in_node,) + hid),
        "enc_edge": lnmlp_init(gen, (cfg.d_in_edge,) + hid),
        "layers": stack_layers(layers),
        "dec": mlp_init(gen, hid + (cfg.d_out,)),
    })


def forward(params, batch, cfg: MeshGraphNetConfig,
            layout: GraphLayout | None = None) -> torch.Tensor:
    """batch: node_feat [N, d_in_node], edge_feat [E, d_in_edge],
    senders/receivers [E]; `layout`: the batch's sharding (None: whole)."""
    nodes = rows_of(batch, "node_feat", layout)
    edges = rows_of(batch, "senders", layout)
    h = lnmlp_apply(params["enc_node"], batch["node_feat"])
    e = lnmlp_apply(params["enc_edge"], batch["edge_feat"])
    snd, rcv = batch["senders"], batch["receivers"]
    for i in range(n_stacked(params["layers"])):
        h, e = checkpointed(
            partial(_layer, layer_slice(params["layers"], i), snd, rcv,
                    nodes, edges, cfg.aggregator), h, e)
    return mlp_apply(params["dec"], h)


def _layer(lp, snd, rcv, nodes, edges, aggregator, h, e):
    return interaction_apply(lp, h, e, snd, rcv, nodes, aggregator, edges)


def loss_fn(params, batch, cfg: MeshGraphNetConfig,
            layout: GraphLayout | None = None) -> torch.Tensor:
    pred = forward(params, batch, cfg, layout)
    return mse_loss(pred, batch["targets"], batch.get("node_mask"),
                    rows_of(batch, "node_feat", layout))
