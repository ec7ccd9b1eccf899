"""Shared neural-net building blocks (port of `repro.models.layers`): the
dense and MLP helpers DLRM and the GNN zoo use, `layer_norm`, and the LM
layers (`rms_norm`, RoPE, chunked prefill attention and KV-cache decode
attention). Plain functions on tensors; weights keep the reference's
[d_in, d_out] layout, so parameters carry across unchanged.

The LM layers keep the reference's order of float32 upcasts and
compute-dtype downcasts (bfloat16 in serving): scores and softmax in f32,
probabilities cast to v's dtype before the PV product, products of
low-precision inputs accumulated in f32 (`matmul_f32`)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["dense_init", "embed_init", "mlp_init", "mlp_apply", "layer_norm",
           "rms_norm", "rope_freqs", "rope_tables", "apply_rope",
           "matmul_f32", "chunked_attention", "decode_mask",
           "decode_attention"]

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


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b (batched) accumulated in f32 and returned in f32, for inputs
    of any float dtype: the reference's `preferred_element_type=f32`.
    bf16/fp16 products are exact in f32, so CUDA takes the f32-output GEMM
    on the low-precision operands and the CPU upcasts them; f32 and wider
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
    all (the reference then averages the masked tiles' values).
    """
    b, sq, h, dh = q.shape
    _, sk, hkv, _ = k.shape
    groups = h // hkv
    scale = 1.0 / math.sqrt(dh)
    n_q, n_k = -(-sq // q_chunk), -(-sk // k_chunk)
    q_pad, k_pad = n_q * q_chunk - sq, n_k * k_chunk - sk
    # [nq, B, Hkv, G*qc, Dh] and [nk, B, Hkv, kc, Dh]: each tile one bmm
    qt = F.pad(q, (0, 0, 0, 0, 0, q_pad)).reshape(
        b, n_q, q_chunk, hkv, groups, dh).permute(1, 0, 3, 4, 2, 5).reshape(
        n_q, b * hkv, groups * q_chunk, dh)
    kt, vt = (F.pad(t, (0, 0, 0, 0, 0, k_pad)).reshape(
        b, n_k, k_chunk, hkv, dh).permute(1, 0, 3, 2, 4).reshape(
        n_k, b * hkv, k_chunk, dh) for t in (k, v))
    dev, acc = q.device, _wide(q.dtype)
    q_last = q_offset + sq - 1
    skip = window is None or q_last <= sk + window - 2
    out = []
    for qi in range(n_q):
        q_lo = q_offset + qi * q_chunk
        qp = q_lo + torch.arange(q_chunk, device=dev)
        m = torch.full((b * hkv, groups * q_chunk), NEG, dtype=acc,
                       device=dev)
        l = torch.zeros_like(m)
        o = torch.zeros((b * hkv, groups * q_chunk, dh), dtype=acc,
                        device=dev)
        for ki in range(n_k):
            k_lo = ki * k_chunk
            if skip and _tile_masked(q_lo, q_lo + q_chunk - 1, k_lo,
                                     k_lo + k_chunk - 1, sk, causal, window):
                continue
            kp = k_lo + torch.arange(k_chunk, device=dev)
            s = matmul_f32(qt[qi], kt[ki].transpose(1, 2)) * scale
            mask = (kp < sk)[None, :].expand(q_chunk, k_chunk)
            if causal:
                mask = mask & (qp[:, None] >= kp[None, :])
            if window is not None:
                mask = mask & (qp[:, None] - kp[None, :] < window)
            s = torch.where(mask.repeat(groups, 1), s, NEG)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            o = o * alpha[..., None] + matmul_f32(p.to(vt.dtype), vt[ki])
            m = m_new
        out.append(o / torch.clamp(l[..., None], min=1e-30))
    o = torch.stack(out).reshape(n_q, b, hkv, groups, q_chunk, dh)
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
