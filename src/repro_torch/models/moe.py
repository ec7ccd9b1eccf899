"""Top-k routed mixture-of-experts FFN (port of `repro.models.moe`):
GShard-style capacity dispatch, the reference's dense path.

Dispatch is the one-hot/cumsum formulation: each (token, slot) assignment
takes the next position in its expert, in (token, slot) order; tokens are
added into a capacity buffer [E, C, D], the expert SwiGLU runs batched
over E, and each assignment's row is gathered back and weighted by its
gate. Assignments past the capacity are dropped (their gate contributes
nothing), so which ones drop depends on every token of the call.

`MoEConfig.impl = "a2a"` is carried over: the reference's all-to-all
dispatch runs only inside a multi-rank group and otherwise falls back to
this dense path, which is what the port serves it with.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

__all__ = ["MoEConfig", "moe_capacity", "moe_init", "moe_apply"]


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    impl: str = "dense"      # "a2a" is served by the dense path (above)


def moe_capacity(cfg: MoEConfig, n_tokens: int) -> int:
    """Slots per expert for `n_tokens` tokens, rounded up to 8 (at least 8)."""
    cap = int(cfg.capacity_factor * n_tokens * cfg.top_k / cfg.n_experts)
    return max(8, ((cap + 7) // 8) * 8)


def moe_init(gen: torch.Generator, d_model: int, d_ff: int, cfg: MoEConfig,
             n_layers: int | None = None) -> dict:
    """{'router': [D, E] f32, 'w1'/'w3': [E, D, F], 'w2': [E, F, D]} f32
    ~ N(0, 1/D) (w2: N(0, 1/F)), each with a leading [n_layers] axis when
    `n_layers` is given; on the generator's device."""
    lead = () if n_layers is None else (n_layers,)
    e = cfg.n_experts

    def normal(shape, std):
        w = torch.empty(lead + shape, device=gen.device)
        return w.normal_(0.0, std, generator=gen)
    s_in, s_out = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(d_ff)
    return {"router": normal((d_model, e), s_in),
            "w1": normal((e, d_model, d_ff), s_in),
            "w3": normal((e, d_model, d_ff), s_in),
            "w2": normal((e, d_ff, d_model), s_out)}


def moe_apply(params: dict, x: torch.Tensor, cfg: MoEConfig,
              capacity: int | None = None, stats: dict | None = None):
    """x: [T, D] -> ([T, D] in x's dtype, aux load-balance loss f32).

    Routing runs in at least f32 on x upcast and the router as given (the
    model casts it to the compute dtype first, as the reference does);
    gates are cast to x's dtype before the combine. With `stats`, adds
    the number of dropped assignments to stats["dropped"] (a tensor, so
    nothing waits for the device).
    """
    t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = capacity or moe_capacity(cfg, t)
    wide = torch.promote_types(x.dtype, torch.float32)

    logits = x.to(wide) @ params["router"].to(wide)            # [T, E]
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = torch.topk(probs, k, dim=-1)                 # [T, k]
    gates = gates / gates.sum(-1, keepdim=True)

    # load-balance aux loss (Switch): E * sum_e f_e * p_e
    me = probs.mean(0)
    experts = torch.arange(e, device=x.device)
    fe = (eidx[:, 0, None] == experts).to(wide).mean(0)
    aux = e * (fe * me).sum()

    # position of each (token, slot) assignment inside its expert; the
    # one-hot lies [E, T*k] so the scan runs along contiguous rows (a
    # scan down the columns of [T*k, E] took 6 ms at T*k = 32,768 on the
    # card)
    assign = (experts[:, None] == eidx.reshape(1, t * k)).long()  # [E, T*k]
    pos_of = ((assign.cumsum(1) - assign) * assign).sum(0)     # [T*k]
    e_of = eidx.reshape(t * k)
    in_cap = pos_of < cap
    slot = torch.where(in_cap, pos_of, cap - 1)
    if stats is not None:
        if "dropped" in stats:
            stats["dropped"] += (~in_cap).sum()     # in place: graph-safe
        else:
            stats["dropped"] = (~in_cap).sum()

    # kept rows land in their own slots; dropped rows write zeros into a
    # spare slot `cap`, past the buffer the experts read (the reference
    # adds them as zeros into slot cap - 1: the same buffer)
    x_rep = x[:, None, :].expand(t, k, d).reshape(t * k, d)   # [T*k, D]
    spare = torch.zeros((e, cap + 1, d), dtype=x.dtype, device=x.device)
    spare[e_of, torch.where(in_cap, pos_of, cap)] = torch.where(
        in_cap[:, None], x_rep, 0)
    buf = spare[:, :cap]

    h = torch.bmm(buf, params["w1"])
    g = torch.bmm(buf, params["w3"])
    out_buf = torch.bmm(F.silu(h) * g, params["w2"])           # [E, C, D]

    rows = torch.where(in_cap[:, None], out_buf[e_of, slot], 0)
    y = (rows * gates.reshape(t * k, 1).to(rows.dtype)).reshape(t, k, d)
    return y.sum(1), aux
