"""Shared pieces of the LM-family configs (port of
`repro.configs.lm_common`): the assigned shapes and their FLOP counts.

Shapes:
  train_4k     seq 4096,    global_batch 256  -> train step
  prefill_32k  seq 32768,   global_batch 32   -> prefill (serve)
  decode_32k   cache 32768, global_batch 128  -> decode step (serve)
  long_500k    cache 524288, global_batch 1   -> decode step; only for
               sub-quadratic (sliding-window) archs

`lm_cells` lists an arch's cells (the registry's); `lm_smoke_run` is one
train step plus a prefill and a decode step on a reduced config.
`build_lm_plan` (the dry-run plan) waits for the dry-run tooling.
"""
from __future__ import annotations

from functools import partial

import torch

from repro_torch.configs.base import Cell
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.models.transformer import TransformerConfig
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.train_loop import make_train_step

__all__ = ["LM_SHAPES", "lm_cells", "lm_attn_flops", "lm_train_flops",
           "lm_decode_flops", "lm_smoke_run"]

LM_SHAPES = {
    "train_4k": dict(kind="train", seq=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq=524288, global_batch=1),
}


def lm_cells(cfg: TransformerConfig) -> list:
    """One Cell per shape; long_500k skipped for full-attention archs."""
    cells = []
    for name, info in LM_SHAPES.items():
        skip = None
        if name == "long_500k" and cfg.sliding_window is None:
            skip = ("pure full-attention arch: 500k decode requires "
                    "sub-quadratic attention (assignment rule)")
        cells.append(Cell(shape=name, kind=info["kind"], skip_reason=skip))
    return cells


def lm_attn_flops(cfg: TransformerConfig, batch: int, seq: int) -> float:
    """Forward attention flops: QK^T + PV, causal-halved, all layers."""
    win = cfg.sliding_window
    eff = seq if win is None else min(seq, 2 * win)
    return cfg.n_layers * 2.0 * batch * seq * eff * cfg.n_heads * cfg.head_dim


def lm_train_flops(cfg: TransformerConfig, tokens: int, batch: int = 1,
                   seq: int | None = None) -> float:
    """MODEL_FLOPS = 6 * N_active * D + 3x attention forward."""
    base = 6.0 * cfg.n_active_params() * tokens
    if seq:
        base += 3.0 * lm_attn_flops(cfg, batch, seq)
    return base


def lm_decode_flops(cfg: TransformerConfig, batch: int, cache: int) -> float:
    """Per decode step: 2*N_active matmul flops + attention over the cache."""
    attn = cfg.n_layers * batch * 4 * cache * cfg.n_heads * cfg.head_dim
    return 2.0 * cfg.n_active_params() * batch + attn


def lm_smoke_run(cfg: TransformerConfig, seed: int = 0, device=None) -> dict:
    """One train step (AdamW lr 1e-3, new tensors) on 2 random sequences
    of 17 tokens, then a prefill of their first 16 tokens into a cache of
    32 and one greedy decode step, on `device` (None = cuda). Parameters
    and tokens from generators seeded with `seed`. Returns {'loss',
    'grad_norm', 'logits'} (the decode step's logits [2, Vp])."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = tf.init_params(gen, cfg)
    opt_cfg = AdamWConfig(lr=1e-3)
    tokens = torch.randint(0, cfg.vocab, (2, 17), generator=gen, device=dev,
                           dtype=torch.int32)
    step = make_train_step(partial(tf.loss_fn, cfg=cfg), opt_cfg,
                           num_microbatches=1, donate=False)
    params2, _, metrics = step(params, adamw_init(params, opt_cfg),
                               {"tokens": tokens})
    logits, kv = tf.prefill(params2, tokens[:, :-1], cfg, pad_to=32)
    nxt = torch.argmax(logits, -1)[:, None]
    logits2, _ = tf.decode_step(params2, nxt, kv, 16, cfg)
    return {"loss": metrics["loss"], "grad_norm": metrics["grad_norm"],
            "logits": logits2}
