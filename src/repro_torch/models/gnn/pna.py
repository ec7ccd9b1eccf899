"""Principal Neighbourhood Aggregation [arXiv:2004.05718] (port of
`repro.models.gnn.pna`).

Per layer: messages M(h_u, h_v) -> 4 aggregators (mean/max/min/std) x 3
degree scalers (identity / amplification / attenuation) = 12 aggregated
views, concatenated and mixed by a linear update U. deg-scalers use
log(d+1)/delta with delta = mean log-degree of the training graph. Each
layer is checkpointed, as the reference's scanned body is.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import torch

from repro_torch.graph.ops import segment_max, segment_min, segment_sum
from repro_torch.models.gnn.common import (checkpointed, layer_slice,
                                           mse_loss, n_stacked,
                                           requires_grad, segment_std,
                                           stack_layers)
from repro_torch.models.layers import layer_norm, mlp_apply, mlp_init

__all__ = ["PNAConfig", "init_params", "forward", "loss_fn"]


@dataclass(frozen=True)
class PNAConfig:
    name: str
    n_layers: int = 4
    d_hidden: int = 75
    d_in: int = 16
    d_out: int = 8
    delta: float = 2.5   # mean log-degree normalizer
    scan_unroll: bool = False


def init_params(gen: torch.Generator, cfg: PNAConfig) -> dict:
    """Random f32 parameters on the generator's device, each a leaf with
    requires_grad."""
    d = cfg.d_hidden
    dev = gen.device
    layers = [{"msg": mlp_init(gen, (2 * d, d, d)),
               "upd": mlp_init(gen, (12 * d + d, d, d)),
               "ln": torch.ones(d, device=dev),
               "ln_b": torch.zeros(d, device=dev)}
              for _ in range(cfg.n_layers)]
    return requires_grad({
        "enc": mlp_init(gen, (cfg.d_in, d)),
        "layers": stack_layers(layers),
        "dec": mlp_init(gen, (d, d, cfg.d_out)),
    })


def _finite_or_zero(x: torch.Tensor) -> torch.Tensor:
    # empty segments (+-inf) become 0, with a zero gradient there
    return torch.where(torch.isfinite(x), x, x.new_zeros(()))


def _layer(lp, snd, rcv, n, s_amp, s_att, h):
    msg = mlp_apply(lp["msg"], torch.cat([h.index_select(0, snd),
                                          h.index_select(0, rcv)], -1),
                    act=torch.relu, final_act=True)
    cnt = torch.clamp(segment_sum(msg.new_ones(rcv.shape), rcv, n),
                      min=1.0)[:, None]
    mean = segment_sum(msg, rcv, n) / cnt
    mx = _finite_or_zero(segment_max(msg, rcv, n))
    mn = _finite_or_zero(segment_min(msg, rcv, n))
    sd = segment_std(msg, rcv, n)
    aggs = torch.cat([mean, mx, mn, sd], -1)                   # [N, 4d]
    scaled = torch.cat([aggs, aggs * s_amp, aggs * s_att], -1)
    h_new = mlp_apply(lp["upd"], torch.cat([h, scaled], -1),
                      act=torch.relu, final_act=True)
    return layer_norm(h + h_new, lp["ln"], lp["ln_b"])


def forward(params, batch, cfg: PNAConfig) -> torch.Tensor:
    """batch: node_feat [N, d_in], senders/receivers [E], deg [N] float."""
    n = batch["node_feat"].shape[0]
    snd, rcv = batch["senders"], batch["receivers"]
    h = mlp_apply(params["enc"], batch["node_feat"])
    logd = torch.log1p(batch["deg"]).to(h.dtype)[:, None]      # [N, 1]
    s_amp = logd / cfg.delta
    s_att = cfg.delta / torch.clamp(logd, min=1e-3)
    for i in range(n_stacked(params["layers"])):
        h = checkpointed(partial(_layer, layer_slice(params["layers"], i),
                                 snd, rcv, n, s_amp, s_att), h)
    return mlp_apply(params["dec"], h)


def loss_fn(params, batch, cfg: PNAConfig) -> torch.Tensor:
    pred = forward(params, batch, cfg)
    return mse_loss(pred, batch["targets"], batch.get("node_mask"))
