"""Shared pieces of the LM-family configs (port of
`repro.configs.lm_common`): the assigned shapes and their FLOP counts.

Shapes:
  train_4k     seq 4096,    global_batch 256  -> train step
  prefill_32k  seq 32768,   global_batch 32   -> prefill (serve)
  decode_32k   cache 32768, global_batch 128  -> decode step (serve)
  long_500k    cache 524288, global_batch 1   -> decode step; only for
               sub-quadratic (sliding-window) archs

`lm_cells` lists an arch's cells (the registry's); `build_lm_plan` is
a cell's dry-run plan; `lm_smoke_run` is one train step plus a prefill
and a decode step on a reduced config.
"""
from __future__ import annotations

from functools import partial

import torch

from repro_torch.configs.base import Cell, DryRunPlan, abstract_call, \
    grad_abstract, meta
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as shard
from repro_torch.distributed.sharding import P
from repro_torch.models import transformer as tf
from repro_torch.models.transformer import TransformerConfig
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.train_loop import make_train_step

__all__ = ["LM_SHAPES", "lm_cells", "lm_attn_flops", "lm_train_flops",
           "lm_decode_flops", "build_lm_plan", "lm_smoke_run"]

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


def _abstract_params(cfg: TransformerConfig) -> dict:
    return abstract_call(tf.init_params, torch.Generator(), cfg)


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=resolve_device(device)).manual_seed(seed)


def build_lm_plan(cfg: TransformerConfig, shape: str, multi_pod: bool,
                  opt_cfg: AdamWConfig | None = None,
                  num_microbatches: int | None = None,
                  _override: dict | None = None) -> DryRunPlan:
    """The dry-run plan of one LM cell: the train step (donated params and
    AdamW state, M microbatches), prefill, or one decode step against a
    cache of the shape's length (the cache donated and written in place).
    `static["make_args"](seed, device)` draws the parameters from a
    generator seeded with `seed`, tokens uniform in [0, vocab), a KV cache
    ~ N(0, 1) and cache_len = seq - 1 (the whole cache valid).
    `static["out_abstract"]` holds the outputs the step allocates beside
    its arguments (prefill's logits and cache, decode's logits).
    _override (probe use only): {"n_layers": L, "batch": B, "nm": M}."""
    import dataclasses as dc
    info = LM_SHAPES[shape]
    kind = info["kind"]
    bsz, seq = info["global_batch"], info["seq"]
    if _override:
        cfg = dc.replace(cfg, n_layers=_override["n_layers"],
                         scan_unroll=True,
                         q_chunk=max(cfg.q_chunk, seq // 8),
                         k_chunk=max(cfg.k_chunk, seq // 8))
        bsz = _override.get("batch", bsz)
    aparams = _abstract_params(cfg)
    pspecs = shard.lm_param_specs(cfg, multi_pod)
    bx = shard.batch_axes(multi_pod)
    n_dp = 32 if multi_pod else 16
    bx_or_none = bx if bsz % n_dp == 0 else None
    static = {"compute_dtype": cfg.compute_dtype}

    def params_of(seed, device):
        return tf.init_params(_generator(seed, device), cfg)

    def tokens_of(gen, rows, cols):
        return torch.randint(0, cfg.vocab, (rows, cols), generator=gen,
                             device=gen.device, dtype=torch.int32)

    if kind == "train":
        opt_cfg = opt_cfg or AdamWConfig()
        nm = num_microbatches or max(1, bsz // 32)
        micro = (info["global_batch"] if not _override else bsz) // nm
        if _override:
            nm = _override["nm"]
            micro = bsz // nm
        aopt = abstract_call(adamw_init, aparams, opt_cfg)
        ospecs = shard.lm_opt_specs(pspecs)
        batch = {"tokens": meta((bsz, seq + 1), torch.int32)}
        bspecs = {"tokens": P(bx_or_none, None)}
        loss = partial(tf.loss_fn, cfg=cfg)
        step = make_train_step(lambda p, b: loss(p, b), opt_cfg,
                               num_microbatches=nm, donate=True,
                               grad_specs=pspecs)

        def make_args(seed: int = 0, device=None):
            params = params_of(seed, device)
            gen = _generator(seed + 1, device)
            return (params, adamw_init(params, opt_cfg),
                    {"tokens": tokens_of(gen, bsz, seq + 1)})
        plan = DryRunPlan(step=step, abstract_args=(aparams, aopt, batch),
                          in_specs=(pspecs, ospecs, bspecs),
                          donate=(0, 1),
                          model_flops=lm_train_flops(cfg, bsz * seq, bsz, seq),
                          static={"microbatches": nm, **static,
                                  "make_args": make_args,
                                  "temp_abstract": grad_abstract(aparams)})
        if not _override:
            plan.cost_model = {
                "L": cfg.n_layers, "M": nm,
                "probe": lambda L, M: build_lm_plan(
                    cfg, shape, multi_pod, opt_cfg,
                    _override={"n_layers": L, "batch": micro * M, "nm": M}),
            }
        return plan

    cache_shape = (cfg.n_layers, bsz, seq, cfg.n_kv_heads, cfg.head_dim)
    if kind == "prefill":
        tokens = meta((bsz, seq), torch.int32)

        def step(params, toks):
            return tf.prefill(params, toks, cfg)

        def make_args(seed: int = 0, device=None):
            gen = _generator(seed + 1, device)
            return params_of(seed, device), tokens_of(gen, bsz, seq)
        out = (meta((bsz, cfg.vocab_padded), torch.float32),
               (meta(cache_shape, cfg.cdtype),) * 2)
        cache_spec = P(None, bx_or_none, "model", None, None)
        plan = DryRunPlan(step=step, abstract_args=(aparams, tokens),
                          in_specs=(pspecs, P(bx_or_none, None)),
                          out_specs=(P(bx_or_none, None),
                                     (cache_spec, cache_spec)),
                          model_flops=2.0 * cfg.n_active_params() * bsz * seq
                          + lm_attn_flops(cfg, bsz, seq),
                          static={**static, "make_args": make_args,
                                  "out_abstract": out})
    else:
        # decode: one new token against a cache of `seq`
        kv = (meta(cache_shape, cfg.cdtype),) * 2
        cache_spec = P(None, bx_or_none, "model", None, None)
        token = meta((bsz, 1), torch.int32)
        clen = meta((), torch.int32)

        def step(params, tok, kv_cache, cache_len):
            return tf.decode_step(params, tok, kv_cache, cache_len, cfg)

        def make_args(seed: int = 0, device=None):
            gen = _generator(seed + 1, device)
            cache = tuple(torch.randn(cache_shape, generator=gen,
                                      device=gen.device, dtype=cfg.cdtype)
                          for _ in range(2))
            return (params_of(seed, device), tokens_of(gen, bsz, 1), cache,
                    torch.tensor(seq - 1, dtype=torch.int32,
                                 device=gen.device))
        plan = DryRunPlan(step=step,
                          abstract_args=(aparams, token, kv, clen),
                          in_specs=(pspecs, P(bx_or_none, None),
                                    (cache_spec, cache_spec), P()),
                          out_specs=P(bx_or_none, None),
                          donate=(2,),
                          model_flops=lm_decode_flops(cfg, bsz, seq),
                          static={**static, "make_args": make_args,
                                  "scalar_args": {3: seq - 1},
                                  "out_abstract": meta(
                                      (bsz, cfg.vocab_padded),
                                      torch.float32)})
    if not _override:
        plan.cost_model = {
            "L": cfg.n_layers, "M": 1,
            "probe": lambda L, M: build_lm_plan(
                cfg, shape, multi_pod, opt_cfg,
                _override={"n_layers": L}),
        }
    return plan


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
