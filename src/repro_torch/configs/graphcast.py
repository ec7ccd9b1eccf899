"""graphcast [arXiv:2212.12794]: 16L processor, d=512, mesh refinement 6
(40,962 mesh nodes, 327,660 multi-level directed mesh edges), 227 output
vars (port of `repro.configs.graphcast`; `build`, the dry-run plan, waits
for the dry-run tooling).
The input graph of each assigned shape plays the grid role; grid<->mesh
bipartite edges are synthetic nearest-assignment. `make_batch` draws its
features on `device` (None = cuda) from a generator seeded with seed + 1;
the topology arrays are the reference's, m2g included as its final
reassignment leaves it: senders are grid ids and receivers mesh ids (the
variables it swaps already hold each other's ids), so at full width they
index past the node sets, where the model applies XLA's rule."""
from __future__ import annotations

from functools import partial

import numpy as np
import torch

from repro_torch.configs import gnn_common as gc
from repro_torch.device import resolve_device
from repro_torch.models.gnn import graphcast as gcast
from repro_torch.models.gnn.common import lnmlp_init, requires_grad

NAME = "graphcast"
FAMILY = "gnn"

G2M_PER_GRID = 4
M2G_PER_GRID = 3


def full_config(d_in: int = 227):
    return gcast.GraphCastConfig(name=NAME, n_layers=16, d_hidden=512,
                                 mesh_refinement=6, n_vars=227)


def smoke_config():
    return gcast.GraphCastConfig(name=NAME + "-smoke", n_layers=2,
                                 d_hidden=16, mesh_refinement=1, n_vars=6)


def _init(gen: torch.Generator, cfg, d_in):
    # patch the grid embedder input width to the shape's d_feat
    params = gcast.init_params(gen, cfg)
    params["emb_grid"] = requires_grad(lnmlp_init(
        gen, (d_in,) + (cfg.d_hidden,) * cfg.mlp_layers))
    return params


def _pad512(x: int) -> int:
    return ((x + 511) // 512) * 512


def topology_arrays(cfg, n_grid: int, seed: int = 0) -> dict:
    """The batch's index arrays (host numpy, the reference's): the padded
    multi-level mesh, grid->mesh (g2m) and m2g edges."""
    n_mesh = _pad512(cfg.n_mesh_nodes)
    e_mesh = _pad512(cfg.n_mesh_edges)
    e_g2m = _pad512(n_grid * G2M_PER_GRID)
    e_m2g = _pad512(n_grid * M2G_PER_GRID)
    ms, mr = gcast.mesh_topology(cfg.mesh_refinement, seed)
    pad_e = e_mesh - len(ms)
    pad_node = n_mesh - 1
    ms = np.concatenate([ms, np.full(pad_e, pad_node, np.int32)])
    mr = np.concatenate([mr, np.full(pad_e, pad_node, np.int32)])
    g2m_s, g2m_r = gcast.grid_mesh_edges(n_grid, cfg.n_mesh_nodes,
                                         G2M_PER_GRID, seed)
    m2g_m, m2g_g = gcast.grid_mesh_edges(n_grid, cfg.n_mesh_nodes,
                                         M2G_PER_GRID, seed + 1)
    gpad = e_g2m - len(g2m_s)
    g2m_s = np.concatenate([g2m_s, np.zeros(gpad, np.int32)])
    g2m_r = np.concatenate([g2m_r, np.full(gpad, pad_node, np.int32)])
    mpad = e_m2g - len(m2g_m)
    m2g_m = np.concatenate([m2g_m, np.full(mpad, pad_node, np.int32)])
    m2g_g = np.concatenate([m2g_g, np.zeros(mpad, np.int32)])
    return {"mesh_senders": ms, "mesh_receivers": mr,
            "g2m_senders": g2m_s, "g2m_receivers": g2m_r,
            "m2g_senders": m2g_m, "m2g_receivers": m2g_g}


def make_batch(cfg, dims, seed: int = 0, d_in=None, device=None) -> dict:
    dev = resolve_device(device)
    n_grid = dims["n"]
    d_in = d_in or dims["d_feat"]
    arrays = topology_arrays(cfg, n_grid, seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    ar = gc.random_array
    batch = {
        "grid_feat": ar((n_grid, d_in), gen),
        "mesh_feat": ar((_pad512(cfg.n_mesh_nodes), 4), gen),
        "g2m_edge_feat": ar((len(arrays["g2m_senders"]), 4), gen),
        "mesh_edge_feat": ar((len(arrays["mesh_senders"]), 4), gen),
        "m2g_edge_feat": ar((len(arrays["m2g_senders"]), 4), gen),
        "targets": ar((n_grid, cfg.n_vars), gen),
        "node_mask": torch.ones((n_grid,), device=dev),
    }
    batch.update(gc.upload(arrays, dev))
    return batch


def model_flops(cfg, dims) -> float:
    d = cfg.d_hidden
    n_grid, n_mesh = dims["n"], cfg.n_mesh_nodes
    e_mesh = cfg.n_mesh_edges
    per_layer = 2 * e_mesh * (3 * d * d + d * d) + 2 * n_mesh * (3 * d * d)
    enc = 2 * n_grid * dims["d_feat"] * d + \
        2 * n_grid * G2M_PER_GRID * 4 * d * d
    dec = 2 * n_grid * M2G_PER_GRID * 4 * d * d + \
        2 * n_grid * (d * d + d * cfg.n_vars)
    return cfg.n_layers * per_layer + enc + dec


def cells():
    return gc.gnn_cells()


def smoke_run(seed: int = 0, device=None):
    cfg = smoke_config()
    dims = gc.gnn_smoke_dims(d_feat=12)
    return gc.run_gnn_smoke(cfg, partial(_init, d_in=12), gcast.loss_fn,
                            partial(make_batch, d_in=12), seed, dims=dims,
                            device=device)
