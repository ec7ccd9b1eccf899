"""The plain PyTorch version of the attention kernels
(`csrc/attention_fwd.cu`, `csrc/attention_bwd.cu`): the port's tile loop
of the reference's `chunked_attention` (src/repro/models/layers.py:87), one
(q_chunk, k_chunk) score tile at a time, with FlashAttention-2's backward
(`_Attention`). The CPU tests hold it against the JAX function; on the card
it is what the kernels are held to, and what float64 (the gates' oracle
dtype) runs on every device."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# the module, not its names: models.layers imports this package's wrapper
from repro_torch.models import layers

__all__ = ["chunked_attention_ref"]


def _tile_masked(q_lo: int, q_hi: int, k_lo: int, k_hi: int, sk: int,
                 causal: bool, window) -> bool:
    """True when every (q, k) pair of the tile is masked: keys all past
    the sequence, all after every query (causal), or all out of window."""
    return (k_lo >= sk or (causal and k_lo > q_hi)
            or (window is not None and q_lo - k_hi >= window))


def _kv_step(m, l, o, q_tile, k_tile, v_tile, mask, scale: float):
    """One KV tile of the online softmax: the running max m, sum l and
    unnormalized output o after the tile's scores (masked to -1e30)."""
    s = layers.matmul_f32(q_tile, k_tile.transpose(1, 2)) * scale
    s = torch.where(mask, s, layers.NEG)
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l = l * alpha + p.sum(-1)
    o = o * alpha[..., None] + layers.matmul_f32(p.to(v_tile.dtype),
                                                 v_tile)
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
    acc = layers._wide(qt.dtype)
    ms, ls, outs = [], [], []
    for qi in range(qt.shape[0]):
        m = torch.full(qt.shape[1:3], layers.NEG, dtype=acc,
                       device=qt.device)
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
        acc, mm = out.dtype, layers.matmul_f32
        rowdot = (dout * out).sum(-1)                # [nq, BH, G*qc]
        dq = torch.zeros(qt.shape, dtype=acc, device=qt.device)
        dk = torch.zeros(kt.shape, dtype=acc, device=kt.device)
        dv = torch.zeros(vt.shape, dtype=acc, device=vt.device)
        for qi in range(qt.shape[0]):
            do = dout[qi].to(vt.dtype)
            for ki, mask in tiles.row(qi):
                s = mm(qt[qi], kt[ki].transpose(1, 2)) * scale
                s = torch.where(mask, s, layers.NEG)
                p = torch.exp(s - m[qi][..., None]) / l[qi][..., None]
                dv[ki] += mm(p.to(vt.dtype).transpose(1, 2), do)
                dp = mm(do, vt[ki].transpose(1, 2))
                ds = p * (dp - rowdot[qi][..., None])
                if not tiles.skip:   # masked scores get no gradient; p
                    ds = torch.where(mask, ds, 0.0)   # is 0 there anyway
                ds = (ds * scale).to(qt.dtype)      # once a key is valid
                dq[qi] += mm(ds, kt[ki])
                dk[ki] += mm(ds.transpose(1, 2), qt[qi])
        return dq.to(qt.dtype), dk.to(kt.dtype), dv.to(vt.dtype), None, None


def chunked_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, window: int | None = None,
                          q_chunk: int = 512, k_chunk: int = 512,
                          q_offset: int = 0) -> torch.Tensor:
    """`models.layers.chunked_attention` as a loop of eager ops over
    (q_chunk, k_chunk) score tiles (its docstring states the contract).

    The tiles are built by padding q to whole q_chunks and k, v to whole
    k_chunks and permuting them to [nq, B*Hkv, G*qc, Dh] and [nk, B*Hkv,
    kc, Dh], so the `groups` query heads of a KV head are rows of one
    product. Tiles whose every pair is masked are skipped, which is exact
    once a query has seen a valid key; it is turned off when some query
    sees no valid key at all (the reference then averages the masked
    tiles' values). Under autograd the tiles run inside `_Attention`,
    whose backward recomputes each score tile from the saved output and
    row statistics."""
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
