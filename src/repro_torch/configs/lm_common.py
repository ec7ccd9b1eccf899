"""Shared pieces of the LM-family configs (port of
`repro.configs.lm_common`): the assigned shapes and their FLOP counts.

Shapes:
  train_4k     seq 4096,    global_batch 256  -> train step
  prefill_32k  seq 32768,   global_batch 32   -> prefill (serve)
  decode_32k   cache 32768, global_batch 128  -> decode step (serve)
  long_500k    cache 524288, global_batch 1   -> decode step; only for
               sub-quadratic (sliding-window) archs

`lm_cells`, `build_lm_plan` (the TPU dry run) and `lm_smoke_run` (a train
step) wait for the tooling and training slices.
"""
from __future__ import annotations

from repro_torch.models.transformer import TransformerConfig

__all__ = ["LM_SHAPES", "lm_attn_flops", "lm_train_flops", "lm_decode_flops"]

LM_SHAPES = {
    "train_4k": dict(kind="train", seq=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq=524288, global_batch=1),
}


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
