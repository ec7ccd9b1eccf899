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
import torch.nn.functional as F
from torch.utils import _pytree as pytree
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import parallel
from repro_torch.distributed.sharding import split

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


def _tile_masked(q_lo: int, q_hi: int, k_lo: int, k_hi: int, sk: int,
                 causal: bool, window) -> bool:
    """True when every (q, k) pair of the tile is masked: keys all past
    the sequence, all after every query (causal), or all out of window."""
    return (k_lo >= sk or (causal and k_lo > q_hi)
            or (window is not None and q_lo - k_hi >= window))


def _kv_step(m, l, o, q_tile, k_tile, v_tile, mask, scale: float):
    """One KV tile of the online softmax: the running max m, sum l and
    unnormalized output o after the tile's scores (masked to -1e30)."""
    s = matmul_f32(q_tile, k_tile.transpose(1, 2)) * scale
    s = torch.where(mask, s, NEG)
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l = l * alpha + p.sum(-1)
    o = o * alpha[..., None] + matmul_f32(p.to(v_tile.dtype), v_tile)
    return m_new, l, o


class _Tiles:
    """The tiling of one attention call: for q tile qi, `row(qi)` lists
    the KV tiles the online softmax visits, each with its [G*qc, kc] mask
    (built per q tile, so a long prefill never holds every mask)."""

    def __init__(self, q_offset, sq, sk, q_chunk, k_chunk, groups, causal,
                 window, dev):
        self.q_offset, self.sk, self.qc, self.kc = q_offset, sk, q_chunk, \
            k_chunk
        self.groups, self.causal, self.window, self.dev = groups, causal, \
            window, dev
        self.n_k = -(-sk // k_chunk)
        q_last = q_offset + sq - 1
        # some query sees no valid key: one before key 0 (causal), or one
        # past the window of the last key
        self.skip = not (causal and q_offset < 0) and \
            (window is None or q_last <= sk + window - 2)

    def row(self, qi: int) -> list:
        q_lo = self.q_offset + qi * self.qc
        qp = q_lo + torch.arange(self.qc, device=self.dev)
        out = []
        for ki in range(self.n_k):
            k_lo = ki * self.kc
            if self.skip and _tile_masked(q_lo, q_lo + self.qc - 1, k_lo,
                                          k_lo + self.kc - 1, self.sk,
                                          self.causal, self.window):
                continue
            kp = k_lo + torch.arange(self.kc, device=self.dev)
            mask = (kp < self.sk)[None, :].expand(self.qc, self.kc)
            if self.causal:
                mask = mask & (qp[:, None] >= kp[None, :])
            if self.window is not None:
                mask = mask & (qp[:, None] - kp[None, :] < self.window)
            out.append((ki, mask.repeat(self.groups, 1)))
        return out


def _attend(qt, kt, vt, tiles: _Tiles, scale: float):
    """Per q tile, the online softmax over its KV tiles: (m, l, out) with
    out = o / max(l, 1e-30), each stacked over the q tiles."""
    acc = _wide(qt.dtype)
    ms, ls, outs = [], [], []
    for qi in range(qt.shape[0]):
        m = torch.full(qt.shape[1:3], NEG, dtype=acc, device=qt.device)
        l = torch.zeros_like(m)
        o = torch.zeros(qt.shape[1:], dtype=acc, device=qt.device)
        for ki, mask in tiles.row(qi):
            m, l, o = _kv_step(m, l, o, qt[qi], kt[ki], vt[ki], mask, scale)
        l = torch.clamp(l, min=1e-30)
        ms.append(m)
        ls.append(l)
        outs.append(o / l[..., None])
    return torch.stack(ms), torch.stack(ls), torch.stack(outs)


class _Attention(torch.autograd.Function):
    """`_attend`'s output with FlashAttention-2's backward: it keeps the
    output and each row's (m, l) and recomputes one score tile at a time,
    p = exp(s - m) / l (the same weights as the forward, the averaged
    masked tiles of a query with no valid key included), then dv += p^T
    do, dp = do v^T, ds = p (dp - rowsum(do * out)), dq += ds k, dk += ds^T
    q. Exact up to rounding against autograd through the tile loop, which
    the reference takes (`jax.checkpoint` per tile recomputes each tile
    there too) without saving a score tile. Products take the f32-output
    GEMM on the operands' dtype, so bf16 rounds the cotangents first."""

    @staticmethod
    def forward(ctx, qt, kt, vt, tiles, scale):
        m, l, out = _attend(qt, kt, vt, tiles, scale)
        ctx.save_for_backward(qt, kt, vt, m, l, out)
        ctx.tiles, ctx.scale = tiles, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        qt, kt, vt, m, l, out = ctx.saved_tensors
        tiles, scale = ctx.tiles, ctx.scale
        acc = out.dtype
        rowdot = (dout * out).sum(-1)                # [nq, BH, G*qc]
        dq = torch.zeros(qt.shape, dtype=acc, device=qt.device)
        dk = torch.zeros(kt.shape, dtype=acc, device=kt.device)
        dv = torch.zeros(vt.shape, dtype=acc, device=vt.device)
        for qi in range(qt.shape[0]):
            do = dout[qi].to(vt.dtype)
            for ki, mask in tiles.row(qi):
                s = matmul_f32(qt[qi], kt[ki].transpose(1, 2)) * scale
                s = torch.where(mask, s, NEG)
                p = torch.exp(s - m[qi][..., None]) / l[qi][..., None]
                dv[ki] += matmul_f32(p.to(vt.dtype).transpose(1, 2), do)
                dp = matmul_f32(do, vt[ki].transpose(1, 2))
                ds = p * (dp - rowdot[qi][..., None])
                if not tiles.skip:   # masked scores get no gradient; p
                    ds = torch.where(mask, ds, 0.0)   # is 0 there anyway
                ds = (ds * scale).to(qt.dtype)      # once a key is valid
                dq[qi] += matmul_f32(ds, kt[ki])
                dk[ki] += matmul_f32(ds.transpose(1, 2), qt[qi])
        return dq.to(qt.dtype), dk.to(kt.dtype), dv.to(vt.dtype), None, None


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True, window: int | None = None,
                      q_chunk: int = 512, k_chunk: int = 512,
                      q_offset: int = 0) -> torch.Tensor:
    """Attention by online softmax over KV tiles (the reference's
    FlashAttention dataflow, one (q_chunk, k_chunk) score tile at a time).

    q: [B, Sq, H, Dh]; k, v: [B, Sk, Hkv, Dh] with H % Hkv == 0 (GQA: the
    `groups` query heads of a KV head are rows of one product, so k and v
    are never repeated). window: sliding window (q_pos - k_pos < window);
    q_offset: absolute position of q[0]. Returns [B, Sq, H, Dh] in v's
    dtype.

    Tiles whose every pair is masked are skipped. That is exact: such a
    tile leaves (m, l, o) unchanged once a query has seen a valid key, and
    the state it builds before then is scaled by exp(-1e30 - m) = 0 at the
    first valid key. It is turned off when some query sees no valid key at
    all (the reference then averages the masked tiles' values). Under
    autograd a skipped tile is exact too: the reference's gradient through
    it is zero.

    When autograd records, the tiles run inside `_Attention`, whose
    backward recomputes each score tile from the saved output and row
    statistics, so no score tile is kept for the backward (the reference
    wraps its scanned tile step in `jax.checkpoint` to the same end).
    """
    b, sq, h, dh = q.shape
    _, sk, hkv, _ = k.shape
    groups = h // hkv
    scale = 1.0 / math.sqrt(dh)
    n_q, n_k = -(-sq // q_chunk), -(-sk // k_chunk)
    q_pad, k_pad = n_q * q_chunk - sq, n_k * k_chunk - sk
    # [nq, B*Hkv, G*qc, Dh] and [nk, B*Hkv, kc, Dh]: each tile one bmm
    qt = F.pad(q, (0, 0, 0, 0, 0, q_pad)).reshape(
        b, n_q, q_chunk, hkv, groups, dh).permute(1, 0, 3, 4, 2, 5).reshape(
        n_q, b * hkv, groups * q_chunk, dh)
    kt, vt = (F.pad(t, (0, 0, 0, 0, 0, k_pad)).reshape(
        b, n_k, k_chunk, hkv, dh).permute(1, 0, 3, 2, 4).reshape(
        n_k, b * hkv, k_chunk, dh) for t in (k, v))
    tiles = _Tiles(q_offset, sq, sk, q_chunk, k_chunk, groups, causal,
                   window, q.device)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        o = _Attention.apply(qt, kt, vt, tiles, scale)
    else:
        o = _attend(qt, kt, vt, tiles, scale)[2]
    o = o.reshape(n_q, b, hkv, groups, q_chunk, dh)
    o = o.permute(1, 0, 4, 2, 3, 5).reshape(b, n_q * q_chunk, h, dh)
    return o[:, :sq].to(v.dtype)


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
