"""Shared neural-net building blocks (port of `repro.models.layers`): the
dense and MLP helpers DLRM and the GNN zoo use, and `layer_norm`. Plain
functions on tensors; weights keep the reference's [d_in, d_out] layout,
so parameters carry across unchanged."""
from __future__ import annotations

import math

import torch

__all__ = ["dense_init", "mlp_init", "mlp_apply", "layer_norm"]


def dense_init(gen: torch.Generator, d_in: int, d_out: int) -> torch.Tensor:
    """[d_in, d_out] f32 ~ N(0, 1/d_in), on the generator's device."""
    w = torch.empty((d_in, d_out), device=gen.device)
    return w.normal_(0.0, 1.0 / math.sqrt(d_in), generator=gen)


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
