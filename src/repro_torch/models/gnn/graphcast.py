"""GraphCast [arXiv:2212.12794] (port of `repro.models.gnn.graphcast`):
encode-process-decode over a multi-scale icosahedral mesh.

  encoder:  grid nodes -> mesh nodes  (bipartite interaction network)
  processor: n_layers message-passing steps over the multi-level mesh graph
             (edges from every refinement level 0..R pooled together — the
             defining GraphCast trick for long-range propagation)
  decoder:  mesh nodes -> grid nodes

Mesh topology is synthesized host-side by icosahedron refinement; the grid
<-> mesh bipartite edges are synthetic nearest-assignment. `mesh_topology`
and `grid_mesh_edges` are copies of the reference's (host numpy, the same
arrays). Each processor layer is checkpointed, as the reference's scanned
body is; the encoder and decoder are not, in either package. With a
`GraphLayout` under a sharded mesh, the grid, mesh and each edge set is
sharded or whole by its own spec (`common`'s partitioned message
passing); the clamp and drop bounds are the sets' global counts.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np
import torch

from repro_torch.models.gnn.common import (GraphLayout, Rows, checkpointed,
                                           interaction_apply,
                                           interaction_init, layer_slice,
                                           lnmlp_apply, lnmlp_init, mse_loss,
                                           n_stacked, requires_grad,
                                           rows_of, stack_layers)
from repro_torch.models.layers import mlp_apply, mlp_init

__all__ = ["GraphCastConfig", "mesh_topology", "grid_mesh_edges",
           "init_params", "forward", "loss_fn"]


@dataclass(frozen=True)
class GraphCastConfig:
    name: str
    n_layers: int = 16
    d_hidden: int = 512
    mesh_refinement: int = 6
    n_vars: int = 227
    aggregator: str = "sum"
    mlp_layers: int = 2
    cheb_prop_rounds: int = 0     # >0: CPAA feature pre-propagation
    scan_unroll: bool = False

    @property
    def n_mesh_nodes(self) -> int:
        return 10 * 4 ** self.mesh_refinement + 2

    @property
    def n_mesh_edges(self) -> int:
        # all refinement levels pooled, both directions
        return sum(2 * 30 * 4 ** l for l in range(self.mesh_refinement + 1))


def mesh_topology(refinement: int, seed: int = 0):
    """Multi-level icosahedral mesh edges (host numpy).

    Exact icosphere connectivity requires geometry; we synthesize a
    structurally equivalent multi-level graph: level l is a ring+chord graph
    over the first 10*4^l+2 nodes with 30*4^l undirected edges — identical
    node/edge counts and nesting structure to the icosphere levels.
    """
    rng = np.random.default_rng(seed)
    sender, receiver = [], []
    for l in range(refinement + 1):
        n_l = 10 * 4 ** l + 2
        m_l = 30 * 4 ** l
        u = np.arange(n_l, dtype=np.int64)
        ring_u, ring_v = u, (u + 1) % n_l                       # n_l edges
        extra = m_l - n_l
        eu = rng.integers(0, n_l, extra)
        step = rng.integers(2, max(3, n_l // 2), extra)
        ev = (eu + step) % n_l
        uu = np.concatenate([ring_u, eu]); vv = np.concatenate([ring_v, ev])
        sender += [uu, vv]
        receiver += [vv, uu]
    return (np.concatenate(sender).astype(np.int32),
            np.concatenate(receiver).astype(np.int32))


def grid_mesh_edges(n_grid: int, n_mesh: int, per_grid: int = 4, seed: int = 0):
    """Synthetic nearest-assignment bipartite edges (grid->mesh)."""
    rng = np.random.default_rng(seed)
    base = (np.arange(n_grid, dtype=np.int64) * 2654435761 % n_mesh)
    g = np.repeat(np.arange(n_grid, dtype=np.int64), per_grid)
    m = (base[:, None] + rng.integers(0, max(n_mesh // 7, 1), (n_grid, per_grid))) % n_mesh
    return g.astype(np.int32), m.reshape(-1).astype(np.int32)


def init_params(gen: torch.Generator, cfg: GraphCastConfig) -> dict:
    """Random f32 parameters on the generator's device, each a leaf with
    requires_grad."""
    d = cfg.d_hidden
    hid = (d,) * cfg.mlp_layers
    layers = [interaction_init(gen, d, d, d, cfg.mlp_layers)
              for _ in range(cfg.n_layers)]
    return requires_grad({
        "emb_grid": lnmlp_init(gen, (cfg.n_vars,) + hid),
        "emb_mesh": lnmlp_init(gen, (4,) + hid),        # static mesh feats
        "emb_e_g2m": lnmlp_init(gen, (4,) + hid),
        "emb_e_mesh": lnmlp_init(gen, (4,) + hid),
        "emb_e_m2g": lnmlp_init(gen, (4,) + hid),
        "g2m": interaction_init(gen, d, d, d, cfg.mlp_layers),
        "m2g": interaction_init(gen, d, d, d, cfg.mlp_layers),
        "layers": stack_layers(layers),
        "dec": mlp_init(gen, hid + (cfg.n_vars,)),
    })


def _gather_clamped(x: torch.Tensor, idx: torch.Tensor,
                    src: Rows) -> torch.Tensor:
    """x[idx] of the whole set `src` with XLA's out-of-range rule: an
    index past its last row reads the last row, and its gradient is
    dropped."""
    valid = (idx < src.n)[:, None]
    rows = src.whole(x).index_select(0, idx.clamp(max=src.n - 1))
    return torch.where(valid, rows, rows.detach())


def _segment_sum_dropped(x: torch.Tensor, seg: torch.Tensor, dst: Rows,
                         edges: Rows):
    """segment_sum into the set `dst` that drops entries whose segment is
    >= its global count (XLA's scatter rule), with a zero gradient for
    them."""
    return dst.scatter_sum(x, seg.clamp(max=dst.n - 1), edges,
                           keep=seg < dst.n)


def _bipartite(p, h_src, h_dst, e, senders, receivers, sets, aggregator):
    """One-way interaction from src node set into dst node set (sum
    aggregation, whatever `aggregator` says, as in the reference).

    The reference's full-width batches hold m2g senders that are grid ids
    and receivers that are mesh ids (its make_batch's final reassignment),
    so indices can pass the node sets; XLA clamps such gathers and drops
    such scatters, and so does this function, to compute what the
    reference computes. `sets`: the `Rows` of (src, dst, the edges)."""
    src, dst, edges = sets
    msg_in = torch.cat([e, _gather_clamped(h_src, senders, src),
                        _gather_clamped(h_dst, receivers, dst)], dim=-1)
    e_new = e + lnmlp_apply(p["edge"], msg_in)
    agg = _segment_sum_dropped(e_new, receivers, dst, edges)
    return h_dst + lnmlp_apply(p["node"], torch.cat([h_dst, agg], -1))


def _layer(lp, snd, rcv, mesh, edges, aggregator, hm, e):
    return interaction_apply(lp, hm, e, snd, rcv, mesh, aggregator, edges)


def forward(params, batch, cfg: GraphCastConfig,
            layout: GraphLayout | None = None) -> torch.Tensor:
    """batch keys: grid_feat [Ng, n_vars]; mesh_feat [Nm, 4];
    g2m_(senders->grid idx, receivers->mesh idx); mesh_(senders, receivers);
    m2g_(senders->mesh idx, receivers->grid idx); *_edge_feat [E, 4];
    `layout`: the batch's sharding (None: whole)."""
    grid = rows_of(batch, "grid_feat", layout)
    mesh = rows_of(batch, "mesh_feat", layout)
    g2m = rows_of(batch, "g2m_senders", layout)
    m2m = rows_of(batch, "mesh_senders", layout)
    m2g = rows_of(batch, "m2g_senders", layout)
    hg = lnmlp_apply(params["emb_grid"], batch["grid_feat"])
    hm = lnmlp_apply(params["emb_mesh"], batch["mesh_feat"])
    e_g2m = lnmlp_apply(params["emb_e_g2m"], batch["g2m_edge_feat"])
    e_mesh = lnmlp_apply(params["emb_e_mesh"], batch["mesh_edge_feat"])
    e_m2g = lnmlp_apply(params["emb_e_m2g"], batch["m2g_edge_feat"])

    # encode grid -> mesh
    hm = _bipartite(params["g2m"], hg, hm, e_g2m, batch["g2m_senders"],
                    batch["g2m_receivers"], (grid, mesh, g2m), cfg.aggregator)

    # process on the multi-level mesh
    snd, rcv = batch["mesh_senders"], batch["mesh_receivers"]
    e = e_mesh
    for i in range(n_stacked(params["layers"])):
        hm, e = checkpointed(
            partial(_layer, layer_slice(params["layers"], i), snd, rcv,
                    mesh, m2m, cfg.aggregator), hm, e)

    # decode mesh -> grid
    hg = _bipartite(params["m2g"], hm, hg, e_m2g, batch["m2g_senders"],
                    batch["m2g_receivers"], (mesh, grid, m2g), cfg.aggregator)
    return mlp_apply(params["dec"], hg)


def loss_fn(params, batch, cfg: GraphCastConfig,
            layout: GraphLayout | None = None) -> torch.Tensor:
    pred = forward(params, batch, cfg, layout)
    return mse_loss(pred, batch["targets"], batch.get("node_mask"),
                    rows_of(batch, "grid_feat", layout))
