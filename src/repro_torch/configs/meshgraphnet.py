"""meshgraphnet [arXiv:2010.03409]: 15L, d=128, sum aggregator, 2-layer
MLPs (port of `repro.configs.meshgraphnet`). `make_batch` draws its features
on `device` (None = cuda) from a generator seeded with seed + 1; the graph
arrays are the reference's; with `abstract` it returns meta tensors of the
same shapes. `build` is a cell's dry-run plan."""
from __future__ import annotations

import torch

from repro_torch.configs import gnn_common as gc
from repro_torch.configs.base import meta
from repro_torch.device import resolve_device
from repro_torch.models.gnn import meshgraphnet as mgn

NAME = "meshgraphnet"
FAMILY = "gnn"

D_EDGE_FEAT = 8


def full_config(d_in: int = 128):
    return mgn.MeshGraphNetConfig(name=NAME, n_layers=15, d_hidden=128,
                                  mlp_layers=2, d_in_node=d_in,
                                  d_in_edge=D_EDGE_FEAT, d_out=3)


def smoke_config():
    return mgn.MeshGraphNetConfig(name=NAME + "-smoke", n_layers=3,
                                  d_hidden=16, d_in_node=12,
                                  d_in_edge=D_EDGE_FEAT, d_out=3)


def make_batch(cfg, dims, seed: int = 0, device=None,
               abstract: bool = False) -> dict:
    n, e = dims["n"], dims["e"]
    if abstract:
        batch = gc.abstract_graph_arrays(dims)
        batch.pop("deg")
        batch["node_feat"] = meta((n, cfg.d_in_node), torch.float32)
        batch["edge_feat"] = meta((e, cfg.d_in_edge), torch.float32)
        batch["targets"] = meta((n, cfg.d_out), torch.float32)
        return batch
    dev = resolve_device(device)
    arrays = gc.graph_arrays(dims, seed)
    arrays.pop("deg")
    batch = gc.upload(arrays, dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    batch["node_feat"] = gc.random_array((n, cfg.d_in_node), gen)
    batch["edge_feat"] = gc.random_array((e, cfg.d_in_edge), gen)
    batch["targets"] = gc.random_array((n, cfg.d_out), gen)
    return batch


def model_flops(cfg, dims) -> float:
    n, e, d = dims["n"], dims["e"], cfg.d_hidden
    per_layer = 2 * e * (3 * d * d + d * d) + 2 * n * (2 * d * d + d * d)
    enc = 2 * n * cfg.d_in_node * d + 2 * e * cfg.d_in_edge * d
    dec = 2 * n * (d * d + d * cfg.d_out)
    return cfg.n_layers * per_layer + enc + dec


def cells():
    return gc.gnn_cells()


def build(shape: str, multi_pod: bool):
    dims = gc.GNN_SHAPES[shape]
    cfg = full_config(d_in=dims["d_feat"])
    return gc.build_gnn_plan(cfg, mgn.init_params, mgn.loss_fn, make_batch,
                             shape, multi_pod, model_flops)


def smoke_run(seed: int = 0, device=None):
    return gc.run_gnn_smoke(smoke_config(), mgn.init_params, mgn.loss_fn,
                            make_batch, seed, device=device)
