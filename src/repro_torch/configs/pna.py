"""pna [arXiv:2004.05718]: 4L, d=75, aggregators mean/max/min/std,
scalers identity/amplification/attenuation (port of `repro.configs.pna`;
`build`, the dry-run plan, waits for the dry-run tooling). `make_batch` draws
its features on `device` (None = cuda) from a generator seeded with seed + 1;
the graph arrays are the reference's."""
from __future__ import annotations

import torch

from repro_torch.configs import gnn_common as gc
from repro_torch.device import resolve_device
from repro_torch.models.gnn import pna

NAME = "pna"
FAMILY = "gnn"


def full_config(d_in: int = 128):
    return pna.PNAConfig(name=NAME, n_layers=4, d_hidden=75, d_in=d_in,
                         d_out=8)


def smoke_config():
    return pna.PNAConfig(name=NAME + "-smoke", n_layers=2, d_hidden=12,
                         d_in=12, d_out=4)


def make_batch(cfg, dims, seed: int = 0, device=None) -> dict:
    dev = resolve_device(device)
    n = dims["n"]
    batch = gc.upload(gc.graph_arrays(dims, seed), dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    batch["node_feat"] = gc.random_array((n, cfg.d_in), gen)
    batch["targets"] = gc.random_array((n, cfg.d_out), gen)
    return batch


def model_flops(cfg, dims) -> float:
    n, e, d = dims["n"], dims["e"], cfg.d_hidden
    per_layer = 2 * e * (2 * d * d + d * d) + 2 * n * (13 * d * d + d * d)
    return (cfg.n_layers * per_layer + 2 * n * cfg.d_in * d
            + 2 * n * (d * d + d * cfg.d_out))


def cells():
    return gc.gnn_cells()


def smoke_run(seed: int = 0, device=None):
    return gc.run_gnn_smoke(smoke_config(), pna.init_params, pna.loss_fn,
                            make_batch, seed, device=device)
