"""Shared neural-net building blocks (port of `repro.models.layers`): the
dense and MLP helpers DLRM and the GNN zoo use, `layer_norm`, and the LM
layers (`rms_norm`, RoPE, chunked prefill attention and KV-cache decode
attention). Plain functions on tensors; weights keep the reference's
[d_in, d_out] layout, so parameters carry across unchanged.

The LM layers keep the reference's order of float32 upcasts and
compute-dtype downcasts (bfloat16 in serving): scores and softmax in f32,
probabilities cast to v's dtype before the PV product, products of
low-precision inputs accumulated in f32 (`matmul_f32`).

Both model families keep their layer stacks on a leading axis and take
one view per layer (`layer_views`), each layer under activation
checkpointing when training (`checkpointed`), as the reference scans a
`jax.checkpoint`ed body.

The tensor-parallel layers (`column_parallel`, `row_parallel`,
`vocab_parallel_*`, `decode_attention_split`) run SPMD over the active
mesh's "model" axis with the collectives of `distributed.parallel`
named in each docstring; a weight's "data" (FSDP) piece is all-gathered
just before its product and freed with the product's inputs."""
from __future__ import annotations

import math

import torch
from torch.utils import _pytree as pytree
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import parallel
from repro_torch.distributed.sharding import split
# the module, not its names: its plain version imports this module
from repro_torch.kernels.attention import ops as attention_ops

__all__ = ["dense_init", "embed_init", "mlp_init", "mlp_apply", "layer_norm",
           "rms_norm", "rope_freqs", "rope_tables", "apply_rope",
           "matmul_f32", "chunked_attention", "decode_mask",
           "decode_attention", "decode_attention_split", "layer_views",
           "checkpointed", "column_parallel", "row_parallel",
           "vocab_parallel_embed", "vocab_parallel_logits",
           "vocab_parallel_xent"]

NEG = -1e30     # masked score, as the reference's


def dense_init(gen: torch.Generator, d_in: int, d_out: int) -> torch.Tensor:
    """[d_in, d_out] f32 ~ N(0, 1/d_in), on the generator's device."""
    w = torch.empty((d_in, d_out), device=gen.device)
    return w.normal_(0.0, 1.0 / math.sqrt(d_in), generator=gen)


def embed_init(gen: torch.Generator, vocab: int, d: int) -> torch.Tensor:
    """[vocab, d] f32 ~ N(0, 0.02^2), on the generator's device."""
    w = torch.empty((vocab, d), device=gen.device)
    return w.normal_(0.0, 0.02, generator=gen)


def mlp_init(gen: torch.Generator, dims: tuple[int, ...],
             bias: bool = True) -> list[dict]:
    """[{'w': [d_i, d_{i+1}], 'b': [d_{i+1}] zeros}] for consecutive dims
    ('b' left out when `bias` is False)."""
    layers = []
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        p = {"w": dense_init(gen, d_in, d_out)}
        if bias:
            p["b"] = torch.zeros(d_out, device=gen.device)
        layers.append(p)
    return layers


def mlp_apply(layers, x: torch.Tensor, act=torch.relu,
              final_act: bool = False) -> torch.Tensor:
    """x @ w (+ b where the layer has one) per layer, `act` between layers
    (and after the last one when `final_act`)."""
    for i, p in enumerate(layers):
        x = x @ p["w"]
        if "b" in p:
            x = x + p["b"]
        if i < len(layers) - 1 or final_act:
            x = act(x)
    return x


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis with the biased variance, normalized in
    at least float32 (the reference's f32; float64 stays float64) and cast
    back to x's dtype before the affine."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * gamma + beta


def _wide(dtype: torch.dtype) -> torch.dtype:
    """The working dtype of a norm or rotation: at least float32."""
    return torch.promote_types(dtype, torch.float32)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) in at least f32, rounded to x's dtype
    before the gamma multiply (the reference's order)."""
    xf = x.to(_wide(x.dtype))
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * gamma


def rope_freqs(d_head: int, theta: float = 10_000.0,
               dtype: torch.dtype = torch.float32,
               device=None) -> torch.Tensor:
    """[d_head / 2] inverse frequencies theta^(-2i / d_head)."""
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=dtype,
                                         device=device) / d_head))


def rope_tables(positions: torch.Tensor, d_head: int,
                theta: float = 10_000.0, dtype: torch.dtype = torch.float32):
    """(cos, sin) of positions [..., S] x rope_freqs, each [..., S, 1,
    Dh/2] in `dtype`: what `apply_rope` rotates by. Callers that rotate
    several tensors at the same positions compute them once."""
    freqs = rope_freqs(d_head, theta, dtype, positions.device)
    angles = positions[..., None].to(dtype) * freqs         # [..., S, Dh/2]
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0, tables=None) -> torch.Tensor:
    """Rotate x [..., S, H, Dh] by positions [..., S] (split halves), in at
    least f32, back to x's dtype. `tables`: `rope_tables` of these
    positions in x's working dtype, when the caller has them."""
    wide = _wide(x.dtype)
    cos, sin = tables or rope_tables(positions, x.shape[-1], theta, wide)
    x1, x2 = x.to(wide).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def layer_views(tree) -> list:
    """The per-layer views of a tree whose leaves are stacked on a leading
    [L] axis: one `unbind` per leaf. Its backward stacks the L gradients
    once, where indexing `x[i]` per layer would add L full-size [L, ...]
    gradients (O(L^2) bytes per leaf)."""
    leaves, spec = pytree.tree_flatten(tree)
    per_leaf = [torch.unbind(x) for x in leaves]
    return [pytree.tree_unflatten([views[i] for views in per_leaf], spec)
            for i in range(len(per_leaf[0]))]


def checkpointed(fn, *args):
    """fn(*args) whose activations are recomputed in the backward pass
    (the reference's `jax.checkpoint` around each scanned layer); a plain
    call when autograd is off."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False)


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b (batched) accumulated in f32 and returned in f32, for inputs
    of any float dtype: the reference's `preferred_element_type=f32`.
    bf16/fp16 products are exact in f32, so CUDA takes the f32-output GEMM
    on the low-precision operands (which has no derivative: the callers
    run it outside autograd) and the CPU upcasts them; f32 and wider
    inputs multiply as they are."""
    if a.dtype in (torch.bfloat16, torch.float16):
        if a.is_cuda:
            mm = torch.mm if a.dim() == 2 else torch.bmm
            return mm(a, b, out_dtype=torch.float32)
        return torch.matmul(a.float(), b.float())
    return torch.matmul(a, b)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True, window: int | None = None,
                      q_chunk: int = 512, k_chunk: int = 512,
                      q_offset: int = 0) -> torch.Tensor:
    """Attention by online softmax over KV tiles (the reference's
    FlashAttention dataflow).

    q: [B, Sq, H, Dh]; k, v: [B, Sk, Hkv, Dh] with H % Hkv == 0 (GQA: the
    `groups` query heads of a KV head read it where it lies; k and v are
    never repeated). window: sliding window (q_pos - k_pos < window);
    q_offset: absolute position of q[0]. Returns [B, Sq, H, Dh] in v's
    dtype.

    Tiles whose every pair is masked are skipped. That is exact: such a
    tile leaves the running (max, sum, output) unchanged once a query has
    seen a valid key, and the reference's gradient through it is zero. A
    query that sees no valid key at all gets the reference's value: the
    average of its masked tiles, every key below Sk weighing 1 / (n_k
    k_chunk), and no gradient to q or k.

    On CUDA tensors of bfloat16 or float32 this is the hand-written
    forward and FlashAttention-2 backward of `kernels/attention` (which
    tile by 64 whatever q_chunk and k_chunk are); CPU tensors and float64
    on every device take its plain version, the eager tile loop of
    (q_chunk, k_chunk) tiles (`kernels/attention/ref.py`). Either way the
    backward recomputes each score tile from the saved output and a
    statistic per row, so no score tile is kept for it (the reference
    wraps its scanned tile step in `jax.checkpoint` to the same end).
    """
    return attention_ops.attention(q, k, v, causal=causal, window=window,
                                   q_chunk=q_chunk, k_chunk=k_chunk,
                                   q_offset=q_offset)


def decode_mask(cache_len, s: int, window: int | None,
                device) -> torch.Tensor:
    """[B, S] keys a decode step attends to: pos < cache_len and, with a
    window, pos >= cache_len - window (cache_len an int or [B] tensor)."""
    pos = torch.arange(s, device=device)
    clen = torch.as_tensor(cache_len, device=device).reshape(-1, 1)
    valid = pos[None, :] < clen
    if window is not None:
        valid = valid & (pos[None, :] >= clen - window)
    return valid


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len,
                     window: int | None = None,
                     valid: torch.Tensor | None = None) -> torch.Tensor:
    """One query token per row against a KV cache, one pass over it.

    q: [B, 1, H, Dh]; caches [B, S, Hkv, Dh]; cache_len: valid prefix
    length (int or [B] tensor); window: keys older than cache_len - window
    are masked. `valid`: `decode_mask` of these, when the caller has it.
    Returns [B, 1, H, Dh] in v's dtype.

    The cache is read in its own layout, [B, S, Hkv*Dh], without a copy:
    the query is laid out block-diagonally, row (h, g) holding q[h, g] in
    KV head h's Dh columns and zeros elsewhere, so one batched product
    gives every head's scores (the zeros add exactly nothing), and the PV
    product's diagonal blocks are the heads' outputs. Hkv times the
    minimal flops, which decode (memory-bound) does not feel.
    """
    b, _, h, dh = q.shape
    _, s, hkv, _ = k_cache.shape
    groups = h // hkv
    if valid is None:
        valid = decode_mask(cache_len, s, window, q.device)
    eye = torch.eye(hkv, dtype=q.dtype, device=q.device)
    q_bd = (q.reshape(b, hkv, groups, 1, dh)
            * eye.reshape(1, hkv, 1, hkv, 1)).reshape(b, h, hkv * dh)
    scores = matmul_f32(q_bd, k_cache.reshape(b, s, hkv * dh).transpose(1, 2))
    scores = scores * (1.0 / math.sqrt(dh))                   # [B, H, S]
    scores = torch.where(valid[:, None, :], scores, NEG)
    p = torch.softmax(scores, dim=-1)
    full = matmul_f32(p.to(v_cache.dtype), v_cache.reshape(b, s, hkv * dh))
    out = torch.diagonal(full.reshape(b, hkv, groups, hkv, dh), dim1=1,
                         dim2=3)                               # [B, G, Dh, Hkv]
    return out.permute(0, 3, 1, 2).reshape(b, 1, h, dh).to(v_cache.dtype)


# ------------------------------------------------------- tensor parallel ----

def fsdp_weight(w: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """The weight whole along `dim` (n entries) from its "data" pieces:
    the FSDP all-gather just before use (tag "fsdp"), its gradient
    reduce-scattered back over "data"."""
    return parallel.gather(w, dim, n, "data", tag="fsdp", site="weight")


def column_parallel(x: torch.Tensor, w: torch.Tensor,
                    d_in: int) -> torch.Tensor:
    """x [.., d_in] (replicated over "model", already through
    `parallel.enter`) @ this rank's column piece of a [d_in, N] weight
    whose rows are FSDP pieces over "data" -> [.., N / model]."""
    return x @ fsdp_weight(w, 0, d_in)


def row_parallel(x: torch.Tensor, w: torch.Tensor,
                 d_out: int) -> torch.Tensor:
    """x [.., K / model] (this rank's piece of the inner dimension) @ this
    rank's row piece of a [K, d_out] weight whose columns are FSDP pieces
    over "data", summed over "model" (`parallel.leave`: one all-reduce)
    -> [.., d_out] replicated."""
    return parallel.leave(x @ fsdp_weight(w, 1, d_out), "model")


def vocab_parallel_embed(embed: torch.Tensor,
                         tokens: torch.Tensor) -> torch.Tensor:
    """The rows of `tokens` from an embedding sharded over "model" by rows
    (`P("model", None)`): this rank's piece `embed` holds rows [lo, lo +
    c); a token outside them looks up 0, and the lookups are summed over
    "model" (one all-reduce)."""
    c = embed.shape[0]
    lo = parallel.index("model") * c
    local = tokens.long() - lo
    mine = (local >= 0) & (local < c)
    rows = embed[torch.where(mine, local, 0)]
    rows = torch.where(mine[..., None], rows, 0)
    return parallel.leave(rows, "model")


def vocab_parallel_logits(x: torch.Tensor, head: torch.Tensor,
                          vocab: int) -> torch.Tensor:
    """This rank's logits over its vocabulary piece of a head sharded by
    columns (`P(None, "model")`) for x already through `parallel.enter`,
    in at least f32, columns past the `vocab` rows of the whole head set
    to -inf (the split's padding)."""
    logits = x @ head
    logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
    c = head.shape[1]
    lo, hi, _ = split(vocab, parallel.size("model"), parallel.index("model"))
    if hi - lo < c:
        real = torch.arange(c, device=x.device) < hi - lo
        logits = torch.where(real, logits, float("-inf"))
    return logits


def vocab_parallel_xent(logits: torch.Tensor,
                        labels: torch.Tensor) -> torch.Tensor:
    """Per-position cross-entropy logsumexp(z) - z[label] over the whole
    vocabulary from this rank's piece of the logits (`vocab_parallel_
    logits`): the maximum (detached) all-reduced over "model", the sum of
    exp and the label's logit (from the rank that holds it) summed over
    "model" (`parallel.leave`)."""
    c = logits.shape[-1]
    lo = parallel.index("model") * c
    m = parallel.all_max(logits.amax(-1), "model", tag="tp")
    se = parallel.leave(torch.exp(logits - m[..., None]).sum(-1), "model")
    local = labels.long() - lo
    mine = (local >= 0) & (local < c)
    picked = torch.gather(logits, -1, torch.where(mine, local, 0)[..., None])
    ll = parallel.leave(torch.where(mine, picked[..., 0], 0.0), "model")
    return m + torch.log(se) - ll


def decode_attention_split(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, valid: torch.Tensor
                           ) -> torch.Tensor:
    """`decode_attention` with the cache's sequence sharded over "model"
    (`lm_cache_spec`): flash-decoding's split-K. q [B, 1, H, Dh] whole;
    the caches [B, S_loc, Hkv, Dh] this rank's positions, `valid` [B,
    S_loc] their decode mask. The local maximum of the scores is
    all-reduced (max), then the local sum of exp(s - max) (sum), then the
    normalized probabilities' product with the local values is summed over
    "model": the softmax and the PV product of the whole cache, the sums
    taken in another order. Inference only."""
    b, _, h, dh = q.shape
    _, s, hkv, _ = k_cache.shape
    groups = h // hkv
    eye = torch.eye(hkv, dtype=q.dtype, device=q.device)
    q_bd = (q.reshape(b, hkv, groups, 1, dh)
            * eye.reshape(1, hkv, 1, hkv, 1)).reshape(b, h, hkv * dh)
    scores = matmul_f32(q_bd, k_cache.reshape(b, s, hkv * dh).transpose(1, 2))
    scores = scores * (1.0 / math.sqrt(dh))                   # [B, H, S_loc]
    scores = torch.where(valid[:, None, :], scores, NEG)
    m = parallel.all_max(scores.amax(-1), "model", tag="tp")
    e = torch.exp(scores - m[..., None])
    den = parallel.all_sum(e.sum(-1), ("model",), tag="tp", site="den")
    p = e / den[..., None]
    full = matmul_f32(p.to(v_cache.dtype), v_cache.reshape(b, s, hkv * dh))
    full = parallel.all_sum(full, ("model",), tag="tp", site="pv")
    out = torch.diagonal(full.reshape(b, hkv, groups, hkv, dh), dim1=1,
                         dim2=3)                               # [B, G, Dh, Hkv]
    return out.permute(0, 3, 1, 2).reshape(b, 1, h, dh).to(v_cache.dtype)
