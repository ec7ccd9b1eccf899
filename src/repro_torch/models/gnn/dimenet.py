"""DimeNet [arXiv:2003.03123] (with the DimeNet++ down-projected bilinear
block [arXiv:2011.14115]) (port of `repro.models.gnn.dimenet`):
directional message passing over edge embeddings with radial (RBF) and
spherical (SBF) bases evaluated on distances and triplet angles.

The triplet list (edge k->j feeding edge j->i) is built host-side and capped
at `max_triplets_per_edge`; `build_triplets` is a copy of the reference's
(host numpy, the same arrays). The basis functions use sinusoidal radial /
Chebyshev angular forms, as in the reference. Each interaction block is
checkpointed, as the reference's scanned body is.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.graph.ops import segment_sum
from repro_torch.models.gnn.common import (checkpointed, layer_slice,
                                           mse_loss, n_stacked,
                                           requires_grad, stack_layers)
from repro_torch.models.layers import mlp_apply, mlp_init

__all__ = ["DimeNetConfig", "radial_basis", "spherical_basis",
           "build_triplets", "init_params", "forward", "loss_fn"]


@dataclass(frozen=True)
class DimeNetConfig:
    name: str
    n_blocks: int = 6
    d_hidden: int = 128
    n_bilinear: int = 8
    n_spherical: int = 7
    n_radial: int = 6
    d_in: int = 16
    cutoff: float = 5.0
    max_triplets_per_edge: int = 8
    scan_unroll: bool = False


def radial_basis(d: torch.Tensor, n_radial: int, cutoff: float):
    """sin(n pi d / c) / d envelope basis. d: [E] -> [E, n_radial]."""
    dn = torch.clamp(d, 1e-3, cutoff)[:, None] / cutoff
    n = torch.arange(1, n_radial + 1, dtype=d.dtype, device=d.device)
    env = 1.0 - dn ** 2
    return env * torch.sin(math.pi * n * dn) / dn


def spherical_basis(d: torch.Tensor, angle: torch.Tensor, n_spherical: int,
                    n_radial: int, cutoff: float):
    """Outer product of radial basis and Chebyshev angular basis.
    d, angle: [T] -> [T, n_spherical * n_radial] (row-major [T, S, R])."""
    rb = radial_basis(d, n_radial, cutoff)                     # [T, R]
    l = torch.arange(n_spherical, dtype=d.dtype, device=d.device)
    ab = torch.cos(l[None, :] * angle[:, None])                # [T, S]
    return (rb[:, None, :] * ab[:, :, None]).reshape(d.shape[0], -1)


def init_params(gen: torch.Generator, cfg: DimeNetConfig) -> dict:
    """Random f32 parameters on the generator's device, each a leaf with
    requires_grad; `w_rbf`, `w_sbf`, `down` and `up` have no bias."""
    d = cfg.d_hidden
    nsb = cfg.n_spherical * cfg.n_radial
    blocks = [{"w_rbf": mlp_init(gen, (cfg.n_radial, d), bias=False),
               "w_sbf": mlp_init(gen, (nsb, cfg.n_bilinear), bias=False),
               "down": mlp_init(gen, (d, cfg.n_bilinear), bias=False),
               "up": mlp_init(gen, (cfg.n_bilinear, d), bias=False),
               "mlp": mlp_init(gen, (d, d, d)),
               "out": mlp_init(gen, (d, d))}
              for _ in range(cfg.n_blocks)]
    return requires_grad({
        "emb_edge": mlp_init(gen, (2 * cfg.d_in + cfg.n_radial, d, d)),
        "blocks": stack_layers(blocks),
        "dec": mlp_init(gen, (d, d, 1)),
    })


def _norm(v: torch.Tensor) -> torch.Tensor:
    # jnp.linalg.norm(v + 1e-9, axis=-1): the 1e-9 goes on each component
    return torch.sqrt((v + 1e-9).square().sum(-1))


def _ord_minus_one_norm(v: torch.Tensor) -> torch.Tensor:
    """What the reference's `jnp.linalg.norm(v + 1e-9, -1)` computes: the
    -1 lands on `ord`, not `axis`, so it is the matrix norm of the whole
    [T, 3] array (the least column sum of |v + 1e-9|), one scalar for all
    triplets. Kept, so both packages compute the same angles."""
    return (v + 1e-9).abs().sum(0).min()


def _block(bp, rbf, sbf, t_kj, t_ji, t_mask, rcv, n, n_edges, x, out_sum):
    g = mlp_apply(bp["w_rbf"], rbf)                            # [E, d]
    x_rbf = x * g
    # directional message: down-project, modulate by SBF, re-aggregate
    m_kj = mlp_apply(bp["down"], x_rbf).index_select(0, t_kj)  # [T, nbi]
    m_kj = m_kj * mlp_apply(bp["w_sbf"], sbf) * t_mask         # [T, nbi]
    agg = segment_sum(m_kj, t_ji, n_edges)
    x_new = x + mlp_apply(bp["mlp"], mlp_apply(bp["up"], agg),
                          act=F.silu, final_act=True)
    out_sum = out_sum + segment_sum(mlp_apply(bp["out"], x_new), rcv, n)
    return x_new, out_sum


def forward(params, batch, cfg: DimeNetConfig) -> torch.Tensor:
    """batch: node_feat [N, d_in]; senders/receivers [E]; positions [N, 3];
    t_kj, t_ji [T] triplet edge indices (message k->j feeds edge j->i);
    t_mask [T]. Returns per-node scalar predictions [N, 1]."""
    snd, rcv = batch["senders"], batch["receivers"]
    pos = batch["positions"]
    feat = batch["node_feat"]
    n = feat.shape[0]

    vec = pos.index_select(0, rcv) - pos.index_select(0, snd)
    dist = _norm(vec)                                          # [E]
    rbf = radial_basis(dist, cfg.n_radial, cfg.cutoff)         # [E, R]

    # triplet angle between edge kj and edge ji
    t_kj, t_ji = batch["t_kj"], batch["t_ji"]
    v1 = vec.index_select(0, t_kj)
    v2 = -vec.index_select(0, t_ji)
    cosang = (v1 * v2).sum(-1) / (_ord_minus_one_norm(v1) *
                                  _ord_minus_one_norm(v2))
    angle = torch.arccos(torch.clamp(cosang, -1 + 1e-6, 1 - 1e-6))
    sbf = spherical_basis(dist.index_select(0, t_kj), angle,
                          cfg.n_spherical, cfg.n_radial, cfg.cutoff)
    t_mask = batch["t_mask"][:, None]

    x = mlp_apply(params["emb_edge"],
                  torch.cat([feat.index_select(0, snd),
                             feat.index_select(0, rcv), rbf], -1),
                  act=F.silu, final_act=True)                  # [E, d]
    out_sum = x.new_zeros((n, cfg.d_hidden))
    for i in range(n_stacked(params["blocks"])):
        x, out_sum = checkpointed(
            partial(_block, layer_slice(params["blocks"], i), rbf, sbf,
                    t_kj, t_ji, t_mask, rcv, n, snd.shape[0]), x, out_sum)
    return mlp_apply(params["dec"], out_sum, act=F.silu)


def loss_fn(params, batch, cfg: DimeNetConfig) -> torch.Tensor:
    pred = forward(params, batch, cfg)
    return mse_loss(pred, batch["targets"], batch.get("node_mask"))


def build_triplets(senders: np.ndarray, receivers: np.ndarray, n_nodes: int,
                   max_per_edge: int = 8, seed: int = 0):
    """Host-side triplet list: for edge e1 = (j -> i), pick up to
    max_per_edge incoming edges e0 = (k -> j), k != i.
    Returns (t_kj, t_ji, t_mask) arrays of length E * max_per_edge."""
    rng = np.random.default_rng(seed)
    n_edges = senders.shape[0]
    # incoming edge lists per node
    order = np.argsort(receivers, kind="stable")
    sorted_e = order
    counts = np.bincount(receivers, minlength=n_nodes)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    t_kj = np.zeros(n_edges * max_per_edge, np.int32)
    t_ji = np.repeat(np.arange(n_edges, dtype=np.int32), max_per_edge)
    t_mask = np.zeros(n_edges * max_per_edge, np.float32)
    for e1 in range(n_edges):
        j, i = senders[e1], receivers[e1]
        beg, cnt = starts[j], counts[j]
        if cnt == 0:
            continue
        incoming = sorted_e[beg:beg + cnt]
        incoming = incoming[senders[incoming] != i]
        if incoming.size == 0:
            continue
        take = min(max_per_edge, incoming.size)
        pick = incoming if incoming.size <= max_per_edge else \
            rng.choice(incoming, size=take, replace=False)
        t_kj[e1 * max_per_edge: e1 * max_per_edge + take] = pick
        t_mask[e1 * max_per_edge: e1 * max_per_edge + take] = 1.0
    return t_kj, t_ji, t_mask
