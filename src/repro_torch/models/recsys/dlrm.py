"""DLRM [arXiv:1906.00091], RM2 variant (port of `repro.models.recsys.dlrm`):
13 dense features -> bottom MLP, 26 categorical features -> embedding
tables, pairwise dot interaction, top MLP -> CTR logit.

The 26 tables are stacked into one combined [padded_rows, D] table with
per-table row offsets, as in the reference: one fused gather serves all
features. The lookup runs through the port's `embedding_bag` (the CUDA
kernel on the card; bag size 1 reproduces RM2). Parameters are a dict in
the reference's layout ({"table", "bot": [{"w", "b"}], "top": [...]}, MLP
weights [d_in, d_out]), so `repro_torch.interop.dlrm_params` carries the
reference's parameters across unchanged.

`loss_fn` is the training objective: binary cross-entropy with logits in
its numerically stable form; the lookup's table gradient is dense, the
backward kernel's (`embedding_bag_backward`), as `jnp.take`'s is in the
reference. `retrieval_step` scores one query against a candidate bank
with a single [Nc, D] x [D] product + top-k (the `retrieval_cand` shape).

Sharded (`use_mesh(mesh, sharded=True)`, the plan of
`dlrm_param_specs`): `params["table"]` is this rank's row shard, rows
[m c, (m + 1) c) of the padded table for "model" coordinate m (c =
padded_rows / model), and the batch is this rank's rows of the batch
axes. The lookup is the window kernel on the local rows
(`embedding_bag_window`), summed over "model" (one all-reduce,
`distributed.parallel.leave`); the MLPs are whole on every rank. The
retrieval bank is sharded over every axis: a local top-k, the candidates
gathered over the axes, and the top-k of those.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.distributed import parallel
from repro_torch.distributed.sharding import params_sharded, split
from repro_torch.kernels.embedding_bag.ops import embedding_bag, \
    embedding_bag_window
from repro_torch.models.layers import mlp_apply, mlp_init
from repro_torch.topk import topk_lower_index_first

__all__ = ["CRITEO_KAGGLE_VOCABS", "DLRMConfig", "init_params", "forward",
           "loss_fn", "serve_step", "retrieval_step"]

# Criteo-Kaggle per-feature cardinalities (DLRM paper experimental setup).
CRITEO_KAGGLE_VOCABS = (
    1460, 583, 10_131_227, 2_202_608, 305, 24, 12_517, 633, 3, 93_145, 5_683,
    8_351_593, 3_194, 27, 14_992, 5_461_306, 10, 5_652, 2_173, 4, 7_046_547,
    18, 15, 286_181, 105, 142_572,
)


@dataclass(frozen=True)
class DLRMConfig:
    name: str
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 64
    bot_mlp: tuple[int, ...] = (13, 512, 256, 64)
    top_mlp: tuple[int, ...] = (512, 512, 256, 1)
    vocab_sizes: tuple[int, ...] = CRITEO_KAGGLE_VOCABS
    bag_size: int = 1

    @property
    def total_rows(self) -> int:
        return sum(self.vocab_sizes)

    @property
    def padded_rows(self) -> int:
        # combined table padded so row-wise sharding tiles any mesh (<=512)
        return ((self.total_rows + 511) // 512) * 512

    @property
    def offsets(self) -> np.ndarray:
        return np.concatenate(
            [[0], np.cumsum(self.vocab_sizes)[:-1]]).astype(np.int32)

    @property
    def n_interactions(self) -> int:
        f = self.n_sparse + 1
        return f * (f - 1) // 2

    @property
    def top_in(self) -> int:
        return self.n_interactions + self.embed_dim

    def n_params(self) -> int:
        total = self.total_rows * self.embed_dim
        dims_b = self.bot_mlp
        total += sum(a * b + b for a, b in zip(dims_b[:-1], dims_b[1:]))
        dims_t = (self.top_in,) + self.top_mlp[1:]
        total += sum(a * b + b for a, b in zip(dims_t[:-1], dims_t[1:]))
        return total


def init_params(cfg: DLRMConfig, seed: int = 0, device=None) -> dict:
    """Random parameters from a generator seeded with `seed`, made directly
    on `device` (None = cuda): the table [padded_rows, D] ~ N(0, 0.01^2)
    (8.64 GB at RM2's widths, never staged on the host) and the MLPs as in
    `repro_torch.models.layers.mlp_init`."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    table = torch.empty((cfg.padded_rows, cfg.embed_dim), device=dev)
    table.normal_(0.0, 0.01, generator=gen)
    return {
        "table": table,
        "bot": mlp_init(gen, cfg.bot_mlp),
        "top": mlp_init(gen, (cfg.top_in,) + cfg.top_mlp[1:]),
    }


def _interact(dense_out: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """dense_out [B, D]; emb [B, F, D] -> [B, D + F(F+1)/2]: dense_out, then
    the strict upper triangle of the Gram matrix of [dense_out, emb] in
    row-major order (`jnp.triu_indices`'s)."""
    f = emb.shape[1]
    z = torch.cat([dense_out[:, None, :], emb], dim=1)          # [B, F+1, D]
    zzt = torch.bmm(z, z.transpose(1, 2))                       # [B, F+1, F+1]
    iu, ju = torch.triu_indices(f + 1, f + 1, offset=1, device=z.device)
    return torch.cat([dense_out, zzt[:, iu, ju]], dim=-1)


def _lookup(ids: torch.Tensor, table: torch.Tensor,
            cfg: DLRMConfig) -> torch.Tensor:
    """The bag sums of `ids` [N, bag] over the whole table: the lookup on
    a whole table, or, sharded, the window lookup on this rank's rows
    summed over "model"."""
    if not params_sharded():
        return embedding_bag(ids, table)
    lo, _, _ = split(cfg.padded_rows, parallel.size("model"),
                     parallel.index("model"))
    part = embedding_bag_window(ids, table, lo,
                                n_rows_total=cfg.padded_rows)
    return parallel.leave(part, "model", tag="tp")


def forward(params: dict, batch: dict, cfg: DLRMConfig) -> torch.Tensor:
    """CTR logits [B]. batch: dense [B, 13] f32; sparse_ids [B, 26, bag]
    int32 (combined-table row ids, offsets already applied)."""
    dense_out = mlp_apply(params["bot"], batch["dense"],
                          final_act=True)                       # [B, D]
    b = batch["dense"].shape[0]
    ids = batch["sparse_ids"].reshape(b * cfg.n_sparse, cfg.bag_size)
    emb = _lookup(ids, params["table"], cfg).reshape(
        b, cfg.n_sparse, cfg.embed_dim)
    x = _interact(dense_out, emb)
    return mlp_apply(params["top"], x)[:, 0]


def loss_fn(params: dict, batch: dict, cfg: DLRMConfig) -> torch.Tensor:
    """Mean binary cross-entropy with logits over batch["labels"] [B]:
    max(z, 0) - z * y + log1p(exp(-|z|)), the reference's stable form
    (`torch.maximum`, so a logit of exactly 0 splits its gradient as
    `jnp.maximum` does)."""
    logit = forward(params, batch, cfg)
    y = batch["labels"].to(torch.float32)
    loss = torch.maximum(logit, torch.zeros_like(logit)) - logit * y + \
        torch.log1p(torch.exp(-logit.abs()))
    return loss.mean()


def serve_step(params: dict, batch: dict, cfg: DLRMConfig) -> torch.Tensor:
    """Click probabilities [B] = sigmoid(forward), with no autograd state."""
    with torch.inference_mode():
        return torch.sigmoid(forward(params, batch, cfg))


def retrieval_step(params: dict, batch: dict, cfg: DLRMConfig,
                   top_k: int = 100):
    """batch: dense [1, 13]; candidates [Nc, D]. Scores the query embedding
    against every candidate (one product over the bank) and returns
    (scores [top_k] f32, indices [top_k] int32) as `lax.top_k` does, ties
    lower index first."""
    with torch.inference_mode():
        q = mlp_apply(params["bot"], batch["dense"], final_act=True)  # [1, D]
        scores = batch["candidates"] @ q[0]                           # [Nc]
        if params_sharded():
            return _sharded_top_k(scores, batch.get("n_candidates"), top_k)
        idx, vals = topk_lower_index_first(scores[None, :], top_k)
        return vals[0], idx[0]


def _sharded_top_k(scores: torch.Tensor, n_total: int | None, top_k: int):
    """Top-k over a bank sharded over every mesh axis (row-major over
    them): this rank's `split` piece of n_total candidates holds `scores`
    (its padding rows never taken); the local top-k with global indices is
    all-gathered over each axis, inner first, so the gathered entries run
    in rank order, and the top-k of those breaks ties lower index first
    as the whole bank's does."""
    axes = tuple(a for a in ("pod", "data", "model")
                 if parallel.size(a) > 1)
    flat, k_ranks = 0, 1
    for a in axes:
        flat = flat * parallel.size(a) + parallel.index(a)
        k_ranks *= parallel.size(a)
    c = scores.shape[0]
    n_total = n_total or c * k_ranks
    lo, hi, _ = split(n_total, k_ranks, flat)
    real = torch.arange(c, device=scores.device) < hi - lo
    scores = torch.where(real, scores, float("-inf"))
    k_loc = min(top_k, c)
    idx, vals = topk_lower_index_first(scores[None, :], k_loc)
    vals, idx = vals[0], idx[0].to(torch.int64) + lo
    for a in reversed(axes):
        vals = parallel.gather(vals, 0, vals.shape[0] * parallel.size(a), a,
                               tag="retrieval")
        idx = parallel.gather(idx, 0, idx.shape[0] * parallel.size(a), a,
                              tag="retrieval")
    pos, top = topk_lower_index_first(vals[None, :], top_k)
    return top[0], idx.gather(0, pos[0].long()).to(torch.int32)
