"""dlrm-rm2 [arXiv:1906.00091] as a config (port of
`repro.configs.dlrm_rm2`): 13 dense + 26 sparse features, embed_dim 64,
bottom MLP 13-512-256-64, top MLP 415-512-256-1, dot interaction.

Shapes:
  train_batch     B=65,536  train_step (not ported yet: the training slice)
  serve_p99       B=512     serve_step (online inference)
  serve_bulk      B=262,144 serve_step (offline scoring)
  retrieval_cand  B=1, 1M candidates retrieval_step (batched dot + top-k)

`make_batch` draws a real batch on a device (None = cuda) from a seeded
generator: dense features ~ N(0, 1) and ids uniform per table, plus the
table's offset. The reference's `build`, `cells` (the TPU dry run) and
`smoke_run` (a train step) wait for the tooling and training slices.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models.recsys import dlrm

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
