"""Deterministic synthetic data pipelines (port of `repro.train.data`): so
far the recsys pipeline.

Every batch is a pure function of (seed, step): resuming after a crash
means restoring the step counter, with no iterator state. The numbers
differ from the reference's `jax.random` streams; the formulas and the
ranges are the same.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["RecsysPipelineConfig", "recsys_batch"]


@dataclass(frozen=True)
class RecsysPipelineConfig:
    vocab_sizes: tuple
    n_dense: int
    bag_size: int
    global_batch: int
    seed: int = 0


def _step_seed(seed: int, step: int) -> int:
    """A generator seed for (seed, step), mixed so neighbouring steps and
    seeds give unrelated streams."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1)[0])


def recsys_batch(cfg: RecsysPipelineConfig, step: int, device=None) -> dict:
    """Power-law recsys batch on `device` (None = cuda): per table,
    id = min(floor(V * u^2), V - 1) + offset with u ~ U[0, 1), so small ids
    take most lookups, as production traffic does; dense ~ N(0, 1); labels
    ~ Bernoulli(0.25)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(_step_seed(cfg.seed, step))
    vocabs = torch.tensor(cfg.vocab_sizes, dtype=torch.int32, device=dev)
    offsets = (torch.cumsum(vocabs, 0) - vocabs).to(torch.int32)
    shape = (cfg.global_batch, len(cfg.vocab_sizes), cfg.bag_size)
    u = torch.rand(shape, generator=gen, device=dev)
    ids = (vocabs[None, :, None] * u ** 2).to(torch.int32)  # power-law ids
    ids = torch.minimum(ids, vocabs[None, :, None] - 1) + \
        offsets[None, :, None]
    dense = torch.randn((cfg.global_batch, cfg.n_dense), generator=gen,
                        device=dev)
    labels = torch.rand(cfg.global_batch, generator=gen, device=dev) < 0.25
    return {"dense": dense, "sparse_ids": ids,
            "labels": labels.to(torch.float32)}
