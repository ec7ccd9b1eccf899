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

Under `distributed.use_mesh(mesh)` (a ("data", "model") mesh), an MoE
config with `impl="a2a"` runs the expert-parallel all-to-all path
(`ffn`). The port is SPMD: each rank passes its shard of the batch (its
"data" rows) and gets its shard's loss, with the aux estimate averaged
over the mesh; the mean of the ranks' losses is the whole batch's, and
the mean of their gradients (each rank's expert slice, zero elsewhere)
is its gradient. `make_train_step` takes that mean.

Sharded (`use_mesh(mesh, sharded=True)`): the parameters are this
rank's pieces under `lm_param_specs` (`sharding.shard_tree`), the batch
its rows of the batch axes, and each entry point runs Megatron tensor
parallelism over "model" with FSDP over "data" (`layers.column_parallel`
/ `row_parallel`: a weight's "data" piece all-gathered just before its
product). Attention runs head-parallel: q, k and v are column products
whose pieces are `split` pieces of H * Dh (Hkv * Dh) columns, the split
the specs (and GSPMD's padding) give. The heads a rank computes follow
one rule, the same split over heads: rank m takes heads [m hq, (m + 1)
hq) of H, hq = ceil(H / model), so with H not a multiple of the model
size (granite's 24 or qwen2.5's 40 heads on 16 ranks) the last ranks take
fewer heads or none. k and v are all-gathered over "model" (GQA has
fewer KV heads than ranks, and prefill's cache needs them whole) and each
rank takes its heads' KV heads; q is all-gathered too unless H tiles the
model axis, and then the attention output is gathered back and each
rank multiplies its `split` piece of it by its rows of `wo`. The FFN
(d_ff over "model"), the MoE (`moe.moe_apply_sharded`, or the
all-to-all path with the expert weights gathered over "data"), the
vocabulary-parallel embedding and cross-entropy
(`layers.vocab_parallel_embed`, `vocab_parallel_xent`) follow the specs; `forward`, `prefill` and `decode_step` return
whole logits (gathered over "model"), and the KV cache is sharded over
"model" by sequence (`lm_cache_spec`), decode attending by split-K
(`layers.decode_attention_split`).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import torch
import torch.nn.functional as F

from repro_torch.core.distributed import flat_rank
from repro_torch.device import resolve_device
from repro_torch.distributed import parallel
from repro_torch.distributed.sharding import (axis_index, axis_size,
                                              current_mesh, params_sharded,
                                              split, use_mesh)
from repro_torch.models.layers import (apply_rope, checkpointed,
                                       chunked_attention, column_parallel,
                                       decode_attention,
                                       decode_attention_split, decode_mask,
                                       dense_init, embed_init, fsdp_weight,
                                       layer_views, rms_norm, row_parallel,
                                       rope_tables, vocab_parallel_embed,
                                       vocab_parallel_logits,
                                       vocab_parallel_xent)
from repro_torch.models.moe import (MoEConfig, all_reduce_mean, moe_apply,
                                    moe_apply_a2a, moe_apply_sharded,
                                    moe_init)

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
    them). `impl="a2a"` takes the all-to-all path under an active mesh
    that qualifies (`_moe_a2a_sharded`) and the dense path otherwise, as
    the reference falls back."""
    if params_sharded():
        return _ffn_sharded(lp, x, cfg, stats)
    if cfg.moe:
        b, s, d = x.shape
        if cfg.moe.impl == "a2a":
            out = _moe_a2a_sharded(lp["moe"], x, cfg, stats)
            if out is not None:
                return out
        y, aux = moe_apply(lp["moe"], x.reshape(b * s, d), cfg.moe,
                           stats=stats)
        return y.reshape(b, s, d), aux
    h = F.silu(x @ lp["w1"]) * (x @ lp["w3"])
    return h @ lp["w2"], torch.zeros((), device=x.device)


def experts_tile(cfg: TransformerConfig) -> bool:
    """True when the specs lay the MoE out expert-parallel (experts over
    "model"), False for intra-expert tensor parallelism
    (`lm_param_specs`'s rule: the expert count tiles 16)."""
    return cfg.moe.n_experts % 16 == 0


def _ffn_sharded(lp: dict, x: torch.Tensor, cfg: TransformerConfig,
                 stats: dict | None = None):
    """`ffn` on this rank's pieces (module docstring)."""
    b, s, d = x.shape
    if not cfg.moe:
        xin = parallel.enter(x, "model")
        h = F.silu(column_parallel(xin, lp["w1"], d)) * \
            column_parallel(xin, lp["w3"], d)
        return row_parallel(h, lp["w2"], d), torch.zeros((), device=x.device)
    mp = lp["moe"]
    w = {"router": fsdp_weight(mp["router"], 0, d),
         "w1": fsdp_weight(mp["w1"], 1, d), "w3": fsdp_weight(mp["w3"], 1, d),
         "w2": fsdp_weight(mp["w2"], 2, d)}
    ep = parallel.size("model")
    if experts_tile(cfg):
        e_loc = w["w1"].shape[0]
        lo = parallel.index("model") * e_loc
        if cfg.moe.impl == "a2a" and cfg.moe.n_experts % ep == 0:
            return _moe_a2a_local(w, x, cfg, ep, stats)
    else:
        lo = 0
    y, aux = moe_apply_sharded(w, x.reshape(b * s, d), cfg.moe, lo,
                               stats=stats)
    return y.reshape(b, s, d), aux


def _moe_a2a_local(w: dict, x: torch.Tensor, cfg: TransformerConfig, ep: int,
                   stats: dict | None = None):
    """The all-to-all path on this rank's experts (already whole along
    d_model), as a region over "model": every rank of a model group sends
    its copy of the tokens to the experts' owners, so x and the router
    enter the region (`parallel.enter`: their gradients summed over the
    group) and y and the aux estimate leave it as their means over the
    group (`parallel.leave` / ep). Where no assignment drops, the ranks'
    copies are equal and the mean is each of them (the whole-parameter
    path's y); where stage 2 drops, the ranks' rows differ and the
    sharded model, whose activations are replicated over "model", takes
    their mean. The aux is then averaged over the batch axes, the
    reference's pmean over (data, model)."""
    b, s, d = x.shape
    local = {"router": parallel.enter(w["router"], "model"),
             **{k: w[k] for k in ("w1", "w3", "w2")}}
    xin = parallel.enter(x, "model")
    y, aux = moe_apply_a2a(local, xin.reshape(b * s, d), cfg.moe, ep,
                           current_mesh().get_group("model"), stats=stats)
    y = parallel.leave(y, "model") / ep
    aux = parallel.leave(aux, "model") / ep
    aux = parallel.mean_over(aux, parallel.batch_axes_of(), tag="moe")
    return y.reshape(b, s, d), aux


def _moe_a2a_sharded(mp: dict, x: torch.Tensor, cfg: TransformerConfig,
                     stats: dict | None = None):
    """The reference's `_moe_a2a_sharded` over the active mesh: None (the
    caller takes the dense path) without a mesh, without a "model"
    dimension, or when its size does not divide the expert count.

    x is this rank's shard of the tokens: its "data" rows, the same on
    every rank of its "model" group (the reference's token spec). The
    rank runs its own slice of the experts (`w1`/`w3`/`w2` rows
    [m E/ep, (m+1) E/ep) for "model" coordinate m; the rest of the
    stacked weights get no gradient here) and averages the aux estimate
    over every rank of the mesh (data x model), as the reference's
    `pmean` does."""
    mesh = current_mesh()
    if mesh is None or "model" not in (mesh.mesh_dim_names or ()):
        return None
    ep = axis_size(mesh, "model")
    if cfg.moe.n_experts % ep:
        return None
    e_loc = cfg.moe.n_experts // ep
    lo = axis_index(mesh, "model") * e_loc
    local = {"router": mp["router"],
             **{w: mp[w][lo:lo + e_loc] for w in ("w1", "w3", "w2")}}
    b, s, d = x.shape
    y, aux = moe_apply_a2a(local, x.reshape(b * s, d), cfg.moe, ep,
                           mesh.get_group("model"), stats=stats)
    return y.reshape(b, s, d), all_reduce_mean(aux, flat_rank(mesh)[0])


def _attn(lp, x, cfg: TransformerConfig, positions, rope, kv=None,
          cache_len=0, valid=None):
    """x: [B, S, D]. kv: (k_cache, v_cache) [B, S_max, Hkv, Dh] for decode,
    written in place at cache_len (clamped to S_max - S, as the
    reference's dynamic_update_slice clamps); valid: its decode_mask."""
    if params_sharded():
        return _attn_sharded(lp, x, cfg, positions, rope, kv, cache_len,
                             valid)
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


def head_split(cfg: TransformerConfig) -> tuple[int, int, int]:
    """(h0, h1, hq): this rank computes query heads [h0, h1), of hq per
    rank (the `split` of H over "model")."""
    h0, h1, hq = split(cfg.n_heads, parallel.size("model"),
                       parallel.index("model"))
    return h0, h1, hq


def _kv_heads(k: torch.Tensor, h0: int, h1: int, groups: int):
    """The KV heads of query heads [h0, h1) from the whole k [B, S, Hkv,
    Dh], laid out for `chunked_attention`'s grouping: a slice when the
    heads take whole groups or share one KV head, else one KV head per
    query head."""
    lo, hi = h0 // groups, (h1 - 1) // groups + 1
    if (h0 % groups == 0 and (h1 - h0) % groups == 0) or hi - lo == 1:
        return k[:, :, lo:hi]
    idx = torch.arange(h0, h1, device=k.device) // groups
    return k.index_select(2, idx)


def _attn_sharded(lp, x, cfg: TransformerConfig, positions, rope, kv=None,
                  cache_len=0, valid=None):
    """`_attn` on this rank's pieces (module docstring). Returns (the
    attention output [B, S, D] replicated over "model", (k, v) whole
    [B, S, Hkv, Dh] rotated) for training and prefill, or, in decode with
    kv = this rank's (k_cache, v_cache) [B, S_loc, Hkv, Dh] holding
    positions [m S_loc, (m + 1) S_loc), the output and kv."""
    b, s, d = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h0, h1, hq = head_split(cfg)
    tiles = h % parallel.size("model") == 0
    xin = parallel.enter(x, "model")
    q = column_parallel(xin, lp["wq"], d)
    k = column_parallel(xin, lp["wk"], d)
    v = column_parallel(xin, lp["wv"], d)
    if cfg.qkv_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    k = parallel.gather(k, 2, hkv * hd, "model", tag="tp", site="kv")
    v = parallel.gather(v, 2, hkv * hd, "model", tag="tp", site="kv")
    if kv is not None or not tiles:
        q = parallel.gather(q, 2, h * hd, "model", tag="tp", site="q")
    rope = rope or rope_for(cfg, positions)
    k = apply_rope(k.reshape(b, s, hkv, hd), positions, cfg.rope_theta, rope)
    v = v.reshape(b, s, hkv, hd)
    if kv is not None:
        q = apply_rope(q.reshape(b, s, h, hd), positions, cfg.rope_theta,
                       rope)
        out = _decode_sharded(q, k, v, kv, cache_len, valid)
        return parallel.leave(parallel.local_piece(
            out.reshape(b, s, h * hd), 2, "model")
            @ fsdp_weight(lp["wo"], 1, d), "model"), kv
    if not tiles:
        q = q[..., h0 * hd:h1 * hd]
    q = apply_rope(q.reshape(b, s, h1 - h0, hd), positions, cfg.rope_theta,
                   rope)
    if h1 > h0:
        out = chunked_attention(
            q, _kv_heads(k, h0, h1, h // hkv), _kv_heads(v, h0, h1, h // hkv),
            causal=True, window=cfg.sliding_window, q_chunk=cfg.q_chunk,
            k_chunk=cfg.k_chunk).reshape(b, s, (h1 - h0) * hd)
    else:
        # no heads here: the empty output still depends on q, k and v
        # (with weight 0), so this rank's backward runs their gathers'
        # reduce-scatters in step with the other ranks'
        out = q.new_zeros((b, s, 0)) + 0.0 * (q.sum() + k.sum() + v.sum())
    if not tiles:
        out = parallel.gather(parallel.pad_to(out, 2, hq * hd), 2, h * hd,
                              "model", tag="tp", site="attn_out")
        out = parallel.local_piece(out, 2, "model")
    return row_parallel(out, lp["wo"], d), (k, v)


def _decode_sharded(q, k, v, kv, cache_len: int, valid):
    """Write the step's k, v into this rank's cache positions where the
    step's position falls in them, and attend by split-K."""
    k_cache, v_cache = kv
    s_loc, s = k_cache.shape[1], q.shape[1]
    m = parallel.index("model")
    start = min(max(cache_len, 0), s_loc * parallel.size("model") - s)
    lo = start - m * s_loc
    a, z = max(lo, 0), min(lo + s, s_loc)
    if z > a:
        k_cache[:, a:z] = k[:, a - lo:z - lo]
        v_cache[:, a:z] = v[:, a - lo:z - lo]
    return decode_attention_split(q, k_cache, v_cache, valid)


def _block(lp, x, cfg: TransformerConfig, positions, rope, kv=None,
           cache_len=0, valid=None, stats=None):
    a, new_kv = _attn(lp, rms_norm(x, lp["ln1"]), cfg, positions, rope, kv,
                      cache_len, valid)
    x = x + a
    f, aux = ffn(lp, rms_norm(x, lp["ln2"]), cfg, stats)
    return x + f, aux, new_kv


def _carry(lp, x, cfg: TransformerConfig, positions, rope, mesh=None,
           sharded: bool = False):
    """A training block: (x, aux) without the KV, for `checkpointed`,
    under the mesh of its forward (the recompute in the backward may run
    outside the caller's `use_mesh`)."""
    with use_mesh(mesh, sharded):
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
    x = vocab_parallel_embed(cp["embed"], tokens) if params_sharded() \
        else cp["embed"][tokens]
    positions = start_pos + torch.arange(tokens.shape[1],
                                         device=tokens.device)[None, :]
    rope = rope_for(cfg, positions)
    aux = torch.zeros((), device=x.device)
    remat = cfg.remat and kv_sink is None and stats is None and \
        torch.is_grad_enabled()
    for i, lp in enumerate(layers or layer_views(cp["layers"])):
        if remat:
            x, aux_l = checkpointed(partial(_carry, cfg=cfg,
                                            positions=positions, rope=rope,
                                            mesh=current_mesh(),
                                            sharded=params_sharded()),
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
    if params_sharded():
        logits = vocab_parallel_logits(parallel.enter(x, "model"),
                                       cp["lm_head"], cfg.vocab_padded)
        return vocab_parallel_xent(logits, labels).mean() + \
            aux_weight * aux / cfg.n_layers
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
    logits = _head(x, cp["lm_head"], cfg)
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
    # sharded: this rank's positions [m c, (m + 1) c) of the cache
    lo, _, c = split(pad_to or s, parallel.size("model"),
                     parallel.index("model")) if params_sharded() \
        else (0, 0, pad_to or s)
    k_cache, v_cache = make_kv_cache(cfg, b, c, device=tokens.device)
    n = max(0, min(s - lo, c))

    def sink(i, k, v):
        k_cache[i, :, :n] = k[:, lo:lo + n]
        v_cache[i, :, :n] = v[:, lo:lo + n]
    x, _ = _trunk(cp, tokens, cfg, kv_sink=sink)
    return _head(x[:, -1], cp["lm_head"], cfg), (k_cache, v_cache)


@torch.inference_mode()
def decode_step(params, token: torch.Tensor, kv_cache, cache_len: int,
                cfg: TransformerConfig):
    """token: [B, 1]; kv_cache: (k, v) each [L, B, S, Hkv, Dh]; cache_len:
    number of valid positions (an int, or a 0-d tensor read once).
    Writes the new KV in place and returns (logits [B, Vp] f32, kv_cache)."""
    cp = cast_params(params, cfg.cdtype)
    cache_len = int(cache_len)
    sharded = params_sharded()
    x = vocab_parallel_embed(cp["embed"], token) if sharded \
        else cp["embed"][token]
    positions = torch.full((token.shape[0], 1), cache_len, dtype=torch.int32,
                           device=token.device)
    k_cache, v_cache = kv_cache
    rope = rope_for(cfg, positions)
    s_loc = k_cache.shape[2]
    valid = decode_mask(cache_len + token.shape[1],
                        s_loc * (parallel.size("model") if sharded else 1),
                        cfg.sliding_window, token.device)
    if sharded:       # this rank's positions of the sequence-sharded cache
        m = parallel.index("model")
        valid = valid[:, m * s_loc:(m + 1) * s_loc]
    for i, lp in enumerate(layer_views(cp["layers"])):
        x, _, _ = _block(lp, x, cfg, positions, rope,
                         kv=(k_cache[i], v_cache[i]), cache_len=cache_len,
                         valid=valid)
    x = rms_norm(x, cp["final_ln"])
    return _head(x[:, 0], cp["lm_head"], cfg), kv_cache


def _head(x: torch.Tensor, head: torch.Tensor,
          cfg: TransformerConfig) -> torch.Tensor:
    """Logits [..., Vp] f32 of the final hidden states (inference):
    sharded, this rank's vocabulary piece all-gathered over "model"."""
    if not params_sharded():
        return (x @ head).float()
    logits = vocab_parallel_logits(x, head, cfg.vocab_padded)
    return parallel.gather(logits, logits.dim() - 1, cfg.vocab_padded,
                           "model", tag="tp", site="logits").float()


def make_kv_cache(cfg: TransformerConfig, batch: int, max_len: int,
                  dtype: torch.dtype | None = None, device=None):
    """Zeroed (k, v) caches [L, batch, max_len, Hkv, Dh] in `dtype`
    (default the compute dtype) on `device` (None = cuda)."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    dev = resolve_device(device)
    dt = dtype or cfg.cdtype
    return (torch.zeros(shape, dtype=dt, device=dev),
            torch.zeros(shape, dtype=dt, device=dev))
