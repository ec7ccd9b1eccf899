"""Deterministic data pipelines (port of `repro.train.data`): the recsys
pipeline and the minibatch GNN pipeline.

Every batch is a pure function of (seed, step): resuming after a crash
means restoring the step counter, with no iterator state. The recsys
numbers differ from the reference's `jax.random` streams (the formulas and
the ranges are the same); the GNN batches are host numpy and equal the
reference's array for array.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.graph.sampler import NeighborSampler
from repro_torch.graph.structure import Graph

__all__ = ["RecsysPipelineConfig", "recsys_batch", "GraphBatchPipeline"]


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


class GraphBatchPipeline:
    """Minibatch GNN pipeline: deterministic seed schedule over a host-side
    neighbour sampler; emits fixed-shape padded subgraph batches.

    `batch_arrays(step)` is the host part and gives the reference's arrays
    for the same inputs; two host costs differ and not the result: the CSR
    is built once here (the reference rebuilds it every batch, then seeds
    the sampler's generator with seed + step, as here), and node ids are
    remapped with a search over the sorted node list instead of a dict.
    `batch(step)` puts those arrays on the pipeline's device."""

    def __init__(self, g: Graph, features: np.ndarray, targets: np.ndarray,
                 batch_nodes: int, fanouts, seed: int = 0,
                 ppr_weights: np.ndarray | None = None, device=None):
        self.device = resolve_device(device)
        self.g = g
        self.features = features
        self.targets = targets
        self.batch_nodes = batch_nodes
        self.fanouts = tuple(fanouts)
        self.seed = seed
        self.ppr = ppr_weights
        self.sampler = NeighborSampler(g, self.fanouts, ppr_weights, seed=seed)
        # fixed shapes (pad targets) so every batch has the same shapes
        e_pad = 0
        frontier = batch_nodes
        for f in self.fanouts:
            e_pad += frontier * f
            frontier += frontier * f
        self.n_pad = min(frontier, g.n) + 1   # +1 sacrificial padding node
        self.e_pad = e_pad

    def batch_arrays(self, step: int) -> dict:
        rng = np.random.default_rng(self.seed + 1_000_003 * step)
        seeds = rng.choice(self.g.n, size=self.batch_nodes, replace=False)
        self.sampler.rng = np.random.default_rng(self.seed + step)
        blocks = self.sampler.sample(seeds)
        # flatten the sampled blocks into one padded subgraph
        frontier = [np.asarray(seeds, np.int64)]
        senders_g, receivers_g, emask = [], [], []
        for blk in blocks:
            senders_g.append(blk.src.astype(np.int64))
            receivers_g.append(blk.nodes[blk.dst_local].astype(np.int64))
            emask.append(blk.mask)
            frontier.append(blk.src.astype(np.int64))
        nodes = np.unique(np.concatenate(frontier))
        # nodes is sorted and holds every id below, so the search is the
        # reference's {id: position} lookup
        snd = np.searchsorted(nodes, np.concatenate(senders_g)).astype(
            np.int32)
        rcv = np.searchsorted(nodes, np.concatenate(receivers_g)).astype(
            np.int32)
        emask = np.concatenate(emask)
        n_pad, e_pad = self.n_pad, self.e_pad
        pad_node = n_pad - 1
        node_mask = np.zeros(n_pad, np.float32)
        node_mask[np.searchsorted(nodes, seeds)] = 1.0
        # route masked/overflow edges at the sacrificial node
        snd_p = np.full(e_pad, pad_node, np.int32)
        rcv_p = np.full(e_pad, pad_node, np.int32)
        k = min(len(snd), e_pad)
        keep = emask[:k] > 0
        snd_p[:k][keep] = snd[:k][keep]
        rcv_p[:k][keep] = rcv[:k][keep]
        deg = np.bincount(snd_p, minlength=n_pad).astype(np.float32)
        feats = np.zeros((n_pad,) + self.features.shape[1:], np.float32)
        feats[:len(nodes)] = self.features[nodes]
        targs = np.zeros((n_pad,) + self.targets.shape[1:], np.float32)
        targs[:len(nodes)] = self.targets[nodes]
        return {"node_feat": feats, "senders": snd_p, "receivers": rcv_p,
                "deg": deg, "targets": targs, "node_mask": node_mask}

    def batch(self, step: int) -> dict:
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in self.batch_arrays(step).items()}
