"""Error-feedback int8 gradient compression (port of
`repro.train.grad_compress`).

Gradients are quantized to int8 with one symmetric scale per tensor; the
quantization error is fed back into the next step's gradient (error
feedback, as in 1-bit SGD / EF-SGD), so the sum of the compressed
gradients tracks the true sum. Plain tensor ops in float32; the int8
codes equal the reference's for the same inputs:

    g_hat, err = ef_compress(g, err)     # g_hat = decompress(compress(g + err))
"""
from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

__all__ = ["compress", "decompress", "ef_compress", "ef_compress_tree",
           "init_error_tree"]


def compress(g: torch.Tensor):
    """Symmetric per-tensor int8 quantization: (q int8, scale f32 0-dim)
    with scale = max(max|g|, 1e-12) / 127 and q = clip(round(g / scale),
    -127, 127), rounding half to even as the reference's `jnp.round`."""
    gf = g.to(torch.float32)
    scale = torch.clamp(gf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def ef_compress(g: torch.Tensor, err: torch.Tensor):
    """Error-feedback step: quantize (g + err); the residual becomes the new
    error state. Returns (g_hat, new_err)."""
    target = g.to(torch.float32) + err
    g_hat = decompress(*compress(target))
    return g_hat, target - g_hat


def ef_compress_tree(grads, err_tree):
    """`ef_compress` leaf by leaf: (g_hat tree, new error tree)."""
    out = pytree.tree_map(ef_compress, grads, err_tree)
    is_pair = lambda t: isinstance(t, tuple)   # noqa: E731
    return (pytree.tree_map(lambda t: t[0], out, is_leaf=is_pair),
            pytree.tree_map(lambda t: t[1], out, is_leaf=is_pair))


def init_error_tree(params):
    """Zero f32 error state beside each parameter."""
    return pytree.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params)
