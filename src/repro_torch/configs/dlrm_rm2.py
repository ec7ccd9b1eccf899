"""dlrm-rm2 [arXiv:1906.00091] as a config (port of
`repro.configs.dlrm_rm2`): 13 dense + 26 sparse features, embed_dim 64,
bottom MLP 13-512-256-64, top MLP 415-512-256-1, dot interaction.

Shapes:
  train_batch     B=65,536  train_step
  serve_p99       B=512     serve_step (online inference)
  serve_bulk      B=262,144 serve_step (offline scoring)
  retrieval_cand  B=1, 1M candidates retrieval_step (batched dot + top-k)

`make_batch` draws a real batch on a device (None = cuda) from a seeded
generator: dense features ~ N(0, 1) and ids uniform per table, plus the
table's offset. `smoke_run` is one train step and one retrieval on the
smoke config. `cells` lists one cell per shape; the reference's `build`
(the dry-run plan) waits for the dry-run tooling.
"""
from __future__ import annotations

from functools import partial

import torch

from repro_torch.configs.base import Cell
from repro_torch.device import resolve_device
from repro_torch.models.recsys import dlrm
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.train_loop import make_train_step

NAME = "dlrm-rm2"
FAMILY = "recsys"

SHAPES = {
    "train_batch": dict(kind="train", batch=65_536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262_144),
    "retrieval_cand": dict(kind="retrieval", batch=1,
                           n_candidates=1_000_448),  # 1M padded to tile 512 devices
}


def full_config():
    return dlrm.DLRMConfig(name=NAME)


def smoke_config():
    return dlrm.DLRMConfig(name=NAME + "-smoke",
                           vocab_sizes=(64, 96, 128, 32), n_sparse=4,
                           embed_dim=16, bot_mlp=(13, 32, 16),
                           top_mlp=(32, 32, 1))


def cells():
    return [Cell(shape=s, kind=i["kind"]) for s, i in SHAPES.items()]


def make_batch(cfg, bsz: int, seed: int = 0, device=None,
               with_labels: bool = True) -> dict:
    """dense [bsz, n_dense] f32, sparse_ids [bsz, n_sparse, bag] int32
    (uniform within each table, offsets applied) and, with labels,
    labels [bsz] f32 ~ Bernoulli(0.3); made on `device` from a generator
    seeded with `seed`."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dense = torch.randn((bsz, cfg.n_dense), generator=gen, device=dev)
    ids = torch.empty((bsz, cfg.n_sparse, cfg.bag_size), dtype=torch.int32,
                      device=dev)
    for f, (vocab, off) in enumerate(zip(cfg.vocab_sizes, cfg.offsets)):
        ids[:, f] = torch.randint(int(off), int(off) + vocab,
                                  (bsz, cfg.bag_size), generator=gen,
                                  device=dev, dtype=torch.int32)
    batch = {"dense": dense, "sparse_ids": ids}
    if with_labels:
        u = torch.rand(bsz, generator=gen, device=dev)
        batch["labels"] = (u < 0.3).to(torch.float32)
    return batch


def model_flops(cfg, bsz: int, kind: str) -> float:
    mlps = cfg.n_params() - cfg.total_rows * cfg.embed_dim
    f = cfg.n_sparse + 1
    inter = bsz * f * f * cfg.embed_dim
    fwd = 2 * bsz * mlps + 2 * inter
    return 3 * fwd if kind == "train" else fwd


def smoke_run(seed: int = 0, device=None) -> dict:
    """One AdamW train step (lr 1e-3, new tensors) on a batch of 16 at the
    smoke config, then `retrieval_step` top-8 over 512 N(0, 1) candidates
    for the batch's first query, on `device` (None = cuda). Returns the
    step's {'loss', 'grad_norm'} and 'retrieval_top' (the best score)."""
    dev = resolve_device(device)
    cfg = smoke_config()
    params = dlrm.init_params(cfg, seed=seed, device=dev)
    opt_cfg = AdamWConfig(lr=1e-3)
    batch = make_batch(cfg, 16, seed=seed, device=dev)
    step = make_train_step(partial(dlrm.loss_fn, cfg=cfg), opt_cfg,
                           num_microbatches=1, donate=False)
    _, _, metrics = step(params, adamw_init(params, opt_cfg), batch)
    gen = torch.Generator(device=dev).manual_seed(seed)
    cands = torch.randn((512, cfg.embed_dim), generator=gen, device=dev)
    scores, _ = dlrm.retrieval_step(
        params, {"dense": batch["dense"][:1], "candidates": cands}, cfg,
        top_k=8)
    metrics["retrieval_top"] = scores[0]
    return metrics
