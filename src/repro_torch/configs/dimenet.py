"""dimenet [arXiv:2003.03123]: 6 blocks, d=128, 8 bilinear, 7 spherical x 6
radial basis functions. Triplets capped at max_triplets_per_edge=8 on the
non-molecular shapes (port of `repro.configs.dimenet`). `make_batch` draws
its features on `device` (None = cuda) from a generator seeded with seed + 1;
the graph and triplet arrays are the reference's; with `abstract` it returns
meta tensors of the same shapes. `build` is a cell's dry-run plan."""
from __future__ import annotations

import torch

from repro_torch.configs import gnn_common as gc
from repro_torch.configs.base import meta
from repro_torch.device import resolve_device
from repro_torch.models.gnn import dimenet as dn

NAME = "dimenet"
FAMILY = "gnn"

TRIPLETS_PER_EDGE = 8


def full_config(d_in: int = 128):
    return dn.DimeNetConfig(name=NAME, n_blocks=6, d_hidden=128,
                            n_bilinear=8, n_spherical=7, n_radial=6,
                            d_in=d_in, max_triplets_per_edge=TRIPLETS_PER_EDGE)


def smoke_config():
    return dn.DimeNetConfig(name=NAME + "-smoke", n_blocks=2, d_hidden=16,
                            n_bilinear=4, n_spherical=3, n_radial=4, d_in=12,
                            max_triplets_per_edge=4)


def make_batch(cfg, dims, seed: int = 0, device=None,
               abstract: bool = False) -> dict:
    n = dims["n"]
    if abstract:
        t = dims["e"] * cfg.max_triplets_per_edge
        batch = gc.abstract_graph_arrays(dims)
        batch.pop("deg")
        batch["node_feat"] = meta((n, cfg.d_in), torch.float32)
        batch["positions"] = meta((n, 3), torch.float32)
        batch["targets"] = meta((n, 1), torch.float32)
        batch["t_kj"] = meta((t,), torch.int32)
        batch["t_ji"] = meta((t,), torch.int32)
        batch["t_mask"] = meta((t,), torch.float32)
        return batch
    dev = resolve_device(device)
    arrays = gc.graph_arrays(dims, seed)
    arrays.pop("deg")
    tkj, tji, tmask = dn.build_triplets(arrays["senders"],
                                        arrays["receivers"], n,
                                        cfg.max_triplets_per_edge, seed)
    arrays.update(t_kj=tkj, t_ji=tji, t_mask=tmask)
    batch = gc.upload(arrays, dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    batch["node_feat"] = gc.random_array((n, cfg.d_in), gen)
    batch["positions"] = gc.random_array((n, 3), gen)
    batch["targets"] = gc.random_array((n, 1), gen)
    return batch


def model_flops(cfg, dims) -> float:
    n, e, d = dims["n"], dims["e"], cfg.d_hidden
    t = e * cfg.max_triplets_per_edge
    nsb = cfg.n_spherical * cfg.n_radial
    per_block = (2 * e * (cfg.n_radial * d + d * cfg.n_bilinear  # rbf+down
                          + cfg.n_bilinear * d + 2 * d * d + d * d)  # up+mlp+out
                 + 2 * t * nsb * cfg.n_bilinear)
    emb = 2 * e * (2 * cfg.d_in + cfg.n_radial) * d + 2 * e * d * d
    return cfg.n_blocks * per_block + emb + 2 * n * (d * d + d)


def cells():
    return gc.gnn_cells()


def build(shape: str, multi_pod: bool):
    dims = gc.GNN_SHAPES[shape]
    cfg = full_config(d_in=dims["d_feat"])
    return gc.build_gnn_plan(cfg, dn.init_params, dn.loss_fn, make_batch,
                             shape, multi_pod, model_flops,
                             layers_field="n_blocks")


def smoke_run(seed: int = 0, device=None):
    return gc.run_gnn_smoke(smoke_config(), dn.init_params, dn.loss_fn,
                            make_batch, seed, device=device)
