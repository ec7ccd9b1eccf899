"""Shared machinery for the GNN-family configs (port of
`repro.configs.gnn_common`).

Shapes (assignment):
  full_graph_sm  n=2,708  e=10,556  d_feat=1,433   (full-batch; cora-scale)
  minibatch_lg   n=232,965 e=114,615,892 batch_nodes=1,024 fanout=15-10
                 -> the training step consumes the PADDED SAMPLED SUBGRAPH
                    (graph.sampler supplies it); frontier/edge sizes below.
  ogb_products   n=2,449,029 e=61,859,140 d_feat=100 (full-batch-large)
  molecule       n=30 e=64 batch=128 (block-diagonal batched small graphs)

Node/edge counts are padded to multiples of 1024, as in the reference.
`graph_arrays` is host numpy and gives the reference's arrays; the random
features come from a `torch.Generator` on the batch's device
(`random_array`), so their values differ from the reference's
`jax.random` ones. `gnn_cells` lists the cells (the registry's); the
reference's `build_gnn_plan` (the dry-run plan) waits for the dry-run
tooling.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import torch

from repro_torch.configs.base import Cell
from repro_torch.device import resolve_device
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.train_loop import make_train_step

__all__ = ["GNN_SHAPES", "gnn_cells", "graph_arrays", "random_array", "upload",
           "gnn_smoke_dims", "run_gnn_smoke"]


def _pad(x: int, q: int = 1024) -> int:
    return ((x + q - 1) // q) * q


def _sampled_dims(batch_nodes: int, fanout):
    """Frontier/edge sizes of the padded fanout-sampled subgraph."""
    seeds = batch_nodes
    edges = 0
    frontier = seeds
    for f in fanout:
        edges += frontier * f
        frontier += frontier * f
    return frontier, edges


_MB_FRONTIER, _MB_EDGES = _sampled_dims(1024, (15, 10))

GNN_SHAPES = {
    "full_graph_sm": dict(n=_pad(2708), e=_pad(10556), d_feat=1433,
                          note="full-batch small (cora-scale)"),
    "minibatch_lg": dict(n=_pad(_MB_FRONTIER), e=_pad(_MB_EDGES), d_feat=602,
                         note="fanout-15/10-sampled subgraph of the "
                              "232,965-node graph (sampler in graph/sampler.py)"),
    "ogb_products": dict(n=_pad(2_449_029), e=_pad(61_859_140), d_feat=100,
                         note="full-batch large"),
    "molecule": dict(n=128 * 30, e=_pad(128 * 64 * 2), d_feat=16,
                     note="128 batched 30-node molecules (block-diagonal)"),
}


def random_array(shape, gen: torch.Generator) -> torch.Tensor:
    """f32 ~ N(0, 1) of `shape` on the generator's device."""
    return torch.randn(shape, generator=gen, device=gen.device)


def graph_arrays(dims, seed: int = 0) -> dict:
    """senders/receivers/deg (+mask) for a synthetic graph of these dims
    (host numpy, the reference's arrays)."""
    n, e = dims["n"], dims["e"]
    rng = np.random.default_rng(seed)
    snd = rng.integers(0, n, e).astype(np.int32)
    rcv = rng.integers(0, n, e).astype(np.int32)
    deg = np.bincount(snd, minlength=n).astype(np.float32)
    return {
        "senders": snd,
        "receivers": rcv,
        "deg": deg,
        "node_mask": np.ones((n,), np.float32),
    }


def upload(arrays: dict, dev: torch.device) -> dict:
    """Host numpy arrays -> tensors on `dev` (same dtypes)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in arrays.items()}


def gnn_smoke_dims(d_feat: int = 12):
    return dict(n=96, e=320, d_feat=d_feat, note="smoke")


def run_gnn_smoke(arch_cfg, init_params, loss_fn, batch_builder,
                  seed: int = 0, dims=None, device=None) -> dict:
    """One AdamW step (lr 1e-3) from parameters and a batch made from
    `seed` on `device` (None = cuda); returns its metrics."""
    dev = resolve_device(device)
    dims = dims or gnn_smoke_dims()
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_params(gen, cfg=arch_cfg)
    batch = batch_builder(arch_cfg, dims, seed=seed, device=dev)
    opt_cfg = AdamWConfig(lr=1e-3)
    opt = adamw_init(params, opt_cfg)
    step = make_train_step(partial(loss_fn, cfg=arch_cfg), opt_cfg,
                           num_microbatches=1, donate=False)
    _, _, metrics = step(params, opt, batch)
    return metrics


def gnn_cells() -> list:
    """One train Cell per GNN shape."""
    return [Cell(shape=s, kind="train") for s in GNN_SHAPES]
