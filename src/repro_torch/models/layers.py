"""Shared neural-net building blocks (port of `repro.models.layers`): only
what DLRM needs so far. Plain functions on tensors; weights keep the
reference's [d_in, d_out] layout, so parameters carry across unchanged."""
from __future__ import annotations

import math

import torch

__all__ = ["dense_init", "mlp_init", "mlp_apply"]


def dense_init(gen: torch.Generator, d_in: int, d_out: int) -> torch.Tensor:
    """[d_in, d_out] f32 ~ N(0, 1/d_in), on the generator's device."""
    w = torch.empty((d_in, d_out), device=gen.device)
    return w.normal_(0.0, 1.0 / math.sqrt(d_in), generator=gen)


def mlp_init(gen: torch.Generator, dims: tuple[int, ...]) -> list[dict]:
    """[{'w': [d_i, d_{i+1}], 'b': [d_{i+1}] zeros}] for consecutive dims."""
    return [{"w": dense_init(gen, d_in, d_out),
             "b": torch.zeros(d_out, device=gen.device)}
            for d_in, d_out in zip(dims[:-1], dims[1:])]


def mlp_apply(layers, x: torch.Tensor, final_act: bool = False
              ) -> torch.Tensor:
    """x @ w + b per layer, ReLU between layers (and after the last one
    when `final_act`)."""
    for i, p in enumerate(layers):
        x = x @ p["w"] + p["b"]
        if i < len(layers) - 1 or final_act:
            x = torch.relu(x)
    return x
