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
table's offset (with `abstract`, meta tensors of the same shapes).
`smoke_run` is one train step and one retrieval on the smoke config.
`cells` lists one cell per shape; `build` is a cell's dry-run plan: the
train step (the `embedding_bag` kernel and its backward on the card),
`serve_step` (the kernel) or `retrieval_step`.
"""
from __future__ import annotations

from functools import partial

import torch

from repro_torch.configs.base import Cell, DryRunPlan, abstract_call, \
    grad_abstract, meta
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as shard
from repro_torch.distributed.sharding import P
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
               with_labels: bool = True, abstract: bool = False) -> dict:
    """dense [bsz, n_dense] f32, sparse_ids [bsz, n_sparse, bag] int32
    (uniform within each table, offsets applied) and, with labels,
    labels [bsz] f32 ~ Bernoulli(0.3); made on `device` from a generator
    seeded with `seed`, or meta tensors of those shapes (`abstract`)."""
    if abstract:
        b = {"dense": meta((bsz, cfg.n_dense), torch.float32),
             "sparse_ids": meta((bsz, cfg.n_sparse, cfg.bag_size),
                                torch.int32)}
        if with_labels:
            b["labels"] = meta((bsz,), torch.float32)
        return b
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


def _batch_specs(batch: dict, bx) -> dict:
    return {k: P(bx, *([None] * (v.ndim - 1))) for k, v in batch.items()}


def build(shape: str, multi_pod: bool) -> DryRunPlan:
    """The dry-run plan of one cell at `full_config()`.
    `static["make_args"](seed, device)` draws the parameters
    (`init_params(cfg, seed)`) and the batch (`make_batch`, seed + 1;
    retrieval: a query and candidates ~ N(0, 1))."""
    cfg = full_config()
    info = SHAPES[shape]
    bsz = info["batch"]
    aparams = abstract_call(dlrm.init_params, cfg, device="cpu")
    pspecs = shard.dlrm_param_specs(aparams, multi_pod)
    bx = shard.batch_axes(multi_pod)
    static = {"compute_dtype": "float32"}

    if info["kind"] == "train":
        opt_cfg = AdamWConfig()
        aopt = abstract_call(adamw_init, aparams, opt_cfg)
        ospecs = {"step": P(), "m": pspecs, "v": pspecs}
        batch = make_batch(cfg, bsz, abstract=True)
        step = make_train_step(partial(dlrm.loss_fn, cfg=cfg), opt_cfg,
                               num_microbatches=1, donate=True,
                               grad_specs=pspecs)

        def make_args(seed: int = 0, device=None):
            params = dlrm.init_params(cfg, seed=seed, device=device)
            return (params, adamw_init(params, opt_cfg),
                    make_batch(cfg, bsz, seed=seed + 1, device=device))
        return DryRunPlan(step=step, abstract_args=(aparams, aopt, batch),
                          in_specs=(pspecs, ospecs,
                                    _batch_specs(batch, bx)),
                          donate=(0, 1),
                          model_flops=model_flops(cfg, bsz, "train"),
                          static={**static, "make_args": make_args,
                                  "temp_abstract": grad_abstract(aparams)})

    if info["kind"] == "serve":
        batch = make_batch(cfg, bsz, abstract=True, with_labels=False)

        def make_args(seed: int = 0, device=None):
            return (dlrm.init_params(cfg, seed=seed, device=device),
                    make_batch(cfg, bsz, seed=seed + 1, device=device,
                               with_labels=False))
        return DryRunPlan(step=partial(dlrm.serve_step, cfg=cfg),
                          abstract_args=(aparams, batch),
                          in_specs=(pspecs, _batch_specs(batch, bx)),
                          out_specs=P(bx),
                          model_flops=model_flops(cfg, bsz, "serve"),
                          static={**static, "make_args": make_args,
                                  "out_abstract": meta((bsz,),
                                                       torch.float32)})

    # retrieval: one query, 1M candidates
    nc = info["n_candidates"]
    batch = {"dense": meta((1, cfg.n_dense), torch.float32),
             "candidates": meta((nc, cfg.embed_dim), torch.float32)}
    bspecs = {"dense": P(None, None),
              "candidates": P(shard.flat_axes(multi_pod), None)}

    def make_args(seed: int = 0, device=None):
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed + 1)
        return (dlrm.init_params(cfg, seed=seed, device=dev),
                {"dense": torch.randn((1, cfg.n_dense), generator=gen,
                                      device=dev),
                 "candidates": torch.randn((nc, cfg.embed_dim),
                                           generator=gen, device=dev)})
    return DryRunPlan(step=partial(dlrm.retrieval_step, cfg=cfg),
                      abstract_args=(aparams, batch),
                      in_specs=(pspecs, bspecs),
                      model_flops=2.0 * nc * cfg.embed_dim,
                      static={**static, "make_args": make_args})


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
