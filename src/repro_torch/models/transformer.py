"""Decoder-only LM (port of `repro.models.transformer`): dense or MoE FFN,
GQA + RoPE, optional sliding window.

Weights for all layers are stacked on a leading [L] axis, as the
reference's are, so its parameter trees carry across unchanged
(`interop.lm_params`); the blocks run in a Python loop over layer views.

Entry points:
  loss_fn      training: mean next-token cross-entropy + the MoE aux loss,
               with autograd (the serve entry points run without it)
  forward      tokens -> logits (and optionally the stacked KV)
  prefill      last-token logits + a KV cache [L, B, S(_pad), Hkv, Dh]
  decode_step  one token against a KV cache, updated in place

Each casts the parameters to `compute_dtype` as the reference's `_cast`
does (the f32 MoE router included); a caller that serves many steps
casts once with `cast_params` and passes the result, for which the cast
is free. Layer views come from one `unbind` per stacked leaf
(`layer_views`). With `remat` (the default, as in the reference), each
block runs under activation checkpointing when autograd records;
inside it `chunked_attention`'s backward (`_Attention`) recomputes each
score tile from the saved output and row statistics.
`seq_shard_carry` shards the saved carry over a TPU mesh's model axis in
the reference; on one card it means nothing and is carried as a field so
configs construct unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models.layers import (apply_rope, checkpointed,
                                       chunked_attention, decode_attention,
                                       decode_mask, dense_init, embed_init,
                                       layer_views, rms_norm, rope_tables)
from repro_torch.models.moe import MoEConfig, moe_apply, moe_init

__all__ = ["TransformerConfig", "init_params", "cast_params", "loss_fn",
           "forward", "prefill", "decode_step", "make_kv_cache",
           "layer_views", "qkv", "ffn", "rope_for"]


@dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int | None = None
    qkv_bias: bool = False
    sliding_window: int | None = None
    rope_theta: float = 1_000_000.0
    moe: MoEConfig | None = None          # if set, d_ff is per-expert width
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = True                    # checkpoint each block (train)
    q_chunk: int = 512
    k_chunk: int = 1024
    scan_unroll: bool = False             # the reference's dry-run probe
    seq_shard_carry: bool = True          # a TPU mesh's; nothing here

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        """Embedding/head rows padded to 256 (the reference's padded-vocab
        convention); logits over the padding rows exist."""
        return ((self.vocab + 255) // 256) * 256

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def n_params(self) -> int:
        """Total parameter count (embeddings included)."""
        d, hd = self.d_model, self.head_dim
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) \
            + self.n_heads * hd * d
        if self.moe:
            ffn = self.moe.n_experts * 3 * d * self.d_ff \
                + d * self.moe.n_experts
        else:
            ffn = 3 * d * self.d_ff
        per_layer = attn + ffn + 2 * d
        return self.n_layers * per_layer + 2 * self.vocab * d + d

    def n_active_params(self) -> int:
        """Params touched per token (MoE: top_k experts only)."""
        if not self.moe:
            return self.n_params()
        d = self.d_model
        attn = d * self.head_dim * (self.n_heads + 2 * self.n_kv_heads) \
            + self.n_heads * self.head_dim * d
        ffn = self.moe.top_k * 3 * d * self.d_ff + d * self.moe.n_experts
        return self.n_layers * (attn + ffn + 2 * d) + 2 * self.vocab * d + d


# ------------------------------------------------------------------ init ---

def init_params(gen: torch.Generator, cfg: TransformerConfig) -> dict:
    """The reference's parameter tree with random weights from `gen`, on
    the generator's device, in `param_dtype`: {'embed': [Vp, D],
    'layers': {'ln1', 'ln2', 'wq', 'wk', 'wv', 'wo', ('bq', 'bk', 'bv'),
    'w1', 'w3', 'w2' | 'moe': {...}} each [L, ...], 'final_ln': [D],
    'lm_head': [D, Vp]}."""
    d, hd, h, hkv = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    n, dev = cfg.n_layers, gen.device

    def stack(d_in, d_out):
        return torch.stack([dense_init(gen, d_in, d_out) for _ in range(n)])
    layer = {"ln1": torch.ones((n, d), device=dev),
             "ln2": torch.ones((n, d), device=dev),
             "wq": stack(d, h * hd), "wk": stack(d, hkv * hd),
             "wv": stack(d, hkv * hd), "wo": stack(h * hd, d)}
    if cfg.qkv_bias:
        layer["bq"] = torch.zeros((n, h * hd), device=dev)
        layer["bk"] = torch.zeros((n, hkv * hd), device=dev)
        layer["bv"] = torch.zeros((n, hkv * hd), device=dev)
    if cfg.moe:
        layer["moe"] = moe_init(gen, d, cfg.d_ff, cfg.moe, n_layers=n)
    else:
        layer["w1"] = stack(d, cfg.d_ff)
        layer["w3"] = stack(d, cfg.d_ff)
        layer["w2"] = stack(cfg.d_ff, d)
    params = {"embed": embed_init(gen, cfg.vocab_padded, d), "layers": layer,
              "final_ln": torch.ones(d, device=dev),
              "lm_head": dense_init(gen, d, cfg.vocab_padded)}
    return cast_params(params, cfg.pdtype)


def cast_params(params, dtype: torch.dtype, device=None):
    """Every f32 / bf16 leaf in `dtype` (the reference's `_cast`; the MoE
    router too), others as they are, moved to `device` when given. A leaf
    already in place is returned as is, not copied."""
    if isinstance(params, dict):
        return {k: cast_params(v, dtype, device) for k, v in params.items()}
    if params.dtype in (torch.float32, torch.bfloat16):
        return params.to(device=device, dtype=dtype)
    return params.to(device=device)


# ----------------------------------------------------------------- blocks --

def rope_for(cfg: TransformerConfig, positions: torch.Tensor):
    """`rope_tables` of `positions` for q and k in the compute dtype's
    working precision: computed once per call, shared by every layer."""
    wide = torch.promote_types(cfg.cdtype, torch.float32)
    return rope_tables(positions, cfg.head_dim, cfg.rope_theta, wide)


def qkv(lp: dict, x: torch.Tensor, cfg: TransformerConfig, positions,
        rope=None):
    """Projected, rotated q [B, S, H, Dh] and k, v [B, S, Hkv, Dh]
    (`rope`: `rope_for(cfg, positions)`, when the caller has it)."""
    b, s, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = x @ lp["wq"], x @ lp["wk"], x @ lp["wv"]
    if cfg.qkv_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    rope = rope or rope_for(cfg, positions)
    q = apply_rope(q.reshape(b, s, h, hd), positions, cfg.rope_theta, rope)
    k = apply_rope(k.reshape(b, s, hkv, hd), positions, cfg.rope_theta, rope)
    return q, k, v.reshape(b, s, hkv, hd)


def ffn(lp: dict, x: torch.Tensor, cfg: TransformerConfig,
        stats: dict | None = None):
    """SwiGLU or MoE FFN on x [B, S, D] -> ([B, S, D], aux f32). The MoE
    sees all B * S tokens of the call at once (its capacity depends on
    them)."""
    if cfg.moe:
        b, s, d = x.shape
        y, aux = moe_apply(lp["moe"], x.reshape(b * s, d), cfg.moe,
                           stats=stats)
        return y.reshape(b, s, d), aux
    h = F.silu(x @ lp["w1"]) * (x @ lp["w3"])
    return h @ lp["w2"], torch.zeros((), device=x.device)


def _attn(lp, x, cfg: TransformerConfig, positions, rope, kv=None,
          cache_len=0, valid=None):
    """x: [B, S, D]. kv: (k_cache, v_cache) [B, S_max, Hkv, Dh] for decode,
    written in place at cache_len (clamped to S_max - S, as the
    reference's dynamic_update_slice clamps); valid: its decode_mask."""
    b, s, _ = x.shape
    q, k, v = qkv(lp, x, cfg, positions, rope)
    if kv is None:
        out = chunked_attention(q, k, v, causal=True,
                                window=cfg.sliding_window,
                                q_chunk=cfg.q_chunk, k_chunk=cfg.k_chunk)
        new_kv = (k, v)
    else:
        k_cache, v_cache = kv
        start = min(max(cache_len, 0), k_cache.shape[1] - s)
        k_cache[:, start:start + s] = k
        v_cache[:, start:start + s] = v
        out = decode_attention(q, k_cache, v_cache, cache_len + s,
                               window=cfg.sliding_window, valid=valid)
        new_kv = kv
    return out.reshape(b, s, -1) @ lp["wo"], new_kv


def _block(lp, x, cfg: TransformerConfig, positions, rope, kv=None,
           cache_len=0, valid=None, stats=None):
    a, new_kv = _attn(lp, rms_norm(x, lp["ln1"]), cfg, positions, rope, kv,
                      cache_len, valid)
    x = x + a
    f, aux = ffn(lp, rms_norm(x, lp["ln2"]), cfg, stats)
    return x + f, aux, new_kv


def _carry(lp, x, cfg: TransformerConfig, positions, rope):
    """A training block: (x, aux) without the KV, for `checkpointed`."""
    x, aux, _ = _block(lp, x, cfg, positions, rope)
    return x, aux


# --------------------------------------------------------------- forward ---

def _trunk(cp: dict, tokens: torch.Tensor, cfg: TransformerConfig,
           start_pos: int = 0, kv_sink=None, layers=None, stats=None):
    """Embedding, every block and the final norm over tokens [B, S] with
    cast parameters; kv_sink(layer, k, v) receives each layer's KV;
    `layers`: the per-layer views, when the caller keeps them; `stats`:
    passed to the MoE (dropped assignments). With `cfg.remat` and autograd
    on, each block is checkpointed (no KV sink then).
    Returns (x [B, S, D], aux f32)."""
    x = cp["embed"][tokens]
    positions = start_pos + torch.arange(tokens.shape[1],
                                         device=tokens.device)[None, :]
    rope = rope_for(cfg, positions)
    aux = torch.zeros((), device=x.device)
    remat = cfg.remat and kv_sink is None and stats is None and \
        torch.is_grad_enabled()
    for i, lp in enumerate(layers or layer_views(cp["layers"])):
        if remat:
            x, aux_l = checkpointed(partial(_carry, cfg=cfg,
                                            positions=positions, rope=rope),
                                    lp, x)
        else:
            x, aux_l, (k, v) = _block(lp, x, cfg, positions, rope,
                                      stats=stats)
            if kv_sink is not None:
                kv_sink(i, k, v)
        aux = aux + aux_l
    return rms_norm(x, cp["final_ln"]), aux


def loss_fn(params, batch: dict, cfg: TransformerConfig,
            aux_weight: float = 0.01) -> torch.Tensor:
    """batch: {'tokens': [B, S+1]} -> scalar mean next-token cross-entropy
    + aux_weight * aux / n_layers (the reference's `loss_fn`). The logits
    are f32 (float64 under a float64 compute dtype) over the padded
    vocabulary, logsumexp included; autograd records through the cast to
    `compute_dtype`."""
    tokens, labels = batch["tokens"][:, :-1], batch["tokens"][:, 1:]
    cp = cast_params(params, cfg.cdtype)
    x, aux = _trunk(cp, tokens, cfg)
    logits = x @ cp["lm_head"]
    logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (logz - ll).mean() + aux_weight * aux / cfg.n_layers


@torch.inference_mode()
def forward(params, tokens: torch.Tensor, cfg: TransformerConfig,
            return_kv: bool = False, start_pos: int = 0):
    """tokens: [B, S] -> (logits [B, S, Vp] f32, aux) or, with return_kv,
    (logits, aux, (k, v) each [L, B, S, Hkv, Dh])."""
    cp = cast_params(params, cfg.cdtype)
    kvs = []
    x, aux = _trunk(cp, tokens, cfg, start_pos,
                    (lambda i, k, v: kvs.append((k, v))) if return_kv
                    else None)
    logits = (x @ cp["lm_head"]).float()
    if not return_kv:
        return logits, aux
    return logits, aux, (torch.stack([k for k, _ in kvs]),
                         torch.stack([v for _, v in kvs]))


@torch.inference_mode()
def prefill(params, tokens: torch.Tensor, cfg: TransformerConfig,
            pad_to: int | None = None):
    """Returns (last-token logits [B, Vp] f32, kv cache (k, v) each
    [L, B, pad_to or S, Hkv, Dh] in the compute dtype). Each layer's KV is
    written straight into the cache; the head runs on the last position
    only."""
    cp = cast_params(params, cfg.cdtype)
    b, s = tokens.shape
    k_cache, v_cache = make_kv_cache(cfg, b, pad_to or s,
                                     device=tokens.device)

    def sink(i, k, v):
        k_cache[i, :, :s] = k
        v_cache[i, :, :s] = v
    x, _ = _trunk(cp, tokens, cfg, kv_sink=sink)
    return (x[:, -1] @ cp["lm_head"]).float(), (k_cache, v_cache)


@torch.inference_mode()
def decode_step(params, token: torch.Tensor, kv_cache, cache_len: int,
                cfg: TransformerConfig):
    """token: [B, 1]; kv_cache: (k, v) each [L, B, S, Hkv, Dh]; cache_len:
    number of valid positions (an int, or a 0-d tensor read once).
    Writes the new KV in place and returns (logits [B, Vp] f32, kv_cache)."""
    cp = cast_params(params, cfg.cdtype)
    cache_len = int(cache_len)
    x = cp["embed"][token]
    positions = torch.full((token.shape[0], 1), cache_len, dtype=torch.int32,
                           device=token.device)
    k_cache, v_cache = kv_cache
    rope = rope_for(cfg, positions)
    valid = decode_mask(cache_len + token.shape[1], k_cache.shape[2],
                        cfg.sliding_window, token.device)
    for i, lp in enumerate(layer_views(cp["layers"])):
        x, _, _ = _block(lp, x, cfg, positions, rope,
                         kv=(k_cache[i], v_cache[i]), cache_len=cache_len,
                         valid=valid)
    x = rms_norm(x, cp["final_ln"])
    return (x[:, 0] @ cp["lm_head"]).float(), kv_cache


def make_kv_cache(cfg: TransformerConfig, batch: int, max_len: int,
                  dtype: torch.dtype | None = None, device=None):
    """Zeroed (k, v) caches [L, batch, max_len, Hkv, Dh] in `dtype`
    (default the compute dtype) on `device` (None = cuda)."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    dev = resolve_device(device)
    dt = dtype or cfg.cdtype
    return (torch.zeros(shape, dtype=dt, device=dev),
            torch.zeros(shape, dtype=dt, device=dev))
