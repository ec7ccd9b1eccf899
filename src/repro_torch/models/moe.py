"""Top-k routed mixture-of-experts FFN (port of `repro.models.moe`):
GShard-style capacity dispatch, dense and expert-parallel.

Dense (`moe_apply`): the one-hot/cumsum formulation: each (token, slot)
assignment takes the next position in its expert, in (token, slot)
order; tokens are added into a capacity buffer [E, C, D], the expert
SwiGLU runs batched over E, and each assignment's row is gathered back
and weighted by its gate. Assignments past the capacity are dropped
(their gate contributes nothing), so which ones drop depends on every
token of the call.

All-to-all (`moe_apply_a2a`, `MoEConfig.impl = "a2a"`): the experts are
split over the ranks of a "model" process group and each rank routes
its own tokens to their owners in two capacity stages: a send buffer of
`cap_loc` rows per peer, then `cap2` rows per local expert over what
arrived. The model takes this path under a mesh whose "model" size
divides the expert count (`transformer.ffn`) and the dense path
otherwise, as the reference falls back.

Sharded dense dispatch (`moe_apply_sharded`, under `use_mesh(mesh,
sharded=True)`): the function of `moe_apply` over the whole batch, run on
this rank's tokens with its piece of the experts. Routing is replicated
over "model"; each rank's (token, slot) positions continue those of the
ranks before it on the batch axes (the per-expert counts all-gathered),
against the capacity of the whole batch, so the same assignments drop
as in one call over every token; the load statistics are averaged over
the batch axes. The rank runs the expert FFN on its piece (whole experts
[lo, lo + E_loc) when they tile "model", expert parallelism; or every
expert's d_ff piece, intra-expert tensor parallelism) and the combined
rows are summed over "model".
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core import distributed as cdist
from repro_torch.distributed import parallel

__all__ = ["MoEConfig", "moe_capacity", "moe_init", "moe_apply",
           "moe_apply_sharded", "a2a_capacities", "positions_in_groups",
           "moe_apply_a2a", "all_reduce_mean", "TRIPS"]


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    # "dense": one capacity buffer over all experts (`moe_apply`);
    # "a2a": expert-parallel all-to-all dispatch under a mesh (above)
    impl: str = "dense"


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
        _add_stat(stats, "dropped", (~in_cap).sum())

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


def _route(params: dict, x: torch.Tensor, cfg: MoEConfig):
    """(probs [T, E], gates [T, k], eidx [T, k], fe [E]) of x: the router
    in at least f32, the top-k gates renormalized, and each expert's share
    of first choices."""
    wide = torch.promote_types(x.dtype, torch.float32)
    logits = x.to(wide) @ params["router"].to(wide)            # [T, E]
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = torch.topk(probs, cfg.top_k, dim=-1)         # [T, k]
    gates = gates / gates.sum(-1, keepdim=True)
    experts = torch.arange(cfg.n_experts, device=x.device)
    fe = (eidx[:, 0, None] == experts).to(wide).mean(0)
    return probs, gates, eidx, fe


def moe_apply_sharded(params: dict, x: torch.Tensor, cfg: MoEConfig,
                      expert_lo: int, stats: dict | None = None):
    """`moe_apply` of the whole batch, from this rank's tokens x [T, D]
    (its rows of the batch axes, replicated over "model") and its piece of
    the experts: params["router"] [D, E] whole; w1/w3 [E_loc, D, F_loc]
    and w2 [E_loc, F_loc, D] for experts [expert_lo, expert_lo + E_loc)
    (padding past E is zero), with F_loc = F or this rank's d_ff piece.
    Returns ([T, D] replicated over "model", the whole batch's aux).

    Collectives: the per-expert counts all-gathered over each batch axis
    (tag "moe"), the statistics of the aux averaged over the batch axes,
    x and the gates entering the "model" region (`parallel.enter`) and the
    combined rows leaving it (`parallel.leave`)."""
    t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    e_loc = params["w1"].shape[0]
    axes = parallel.batch_axes_of()
    probs, gates, eidx, fe = _route(params, x, cfg)
    me = parallel.mean_over(probs.mean(0), axes, tag=TRIPS)
    fe = parallel.mean_over(fe, axes, tag=TRIPS)
    aux = e * (fe * me).sum()

    # positions: this rank's continue the counts of the ranks before it
    experts = torch.arange(e, device=x.device)
    assign = (experts[:, None] == eidx.reshape(1, t * k)).long()  # [E, T*k]
    pos_local = ((assign.cumsum(1) - assign) * assign).sum(0)    # [T*k]
    # inner axis first: the counts of the ranks before this one in its
    # block of the axis, then those of the blocks before its block
    block = assign.sum(1)                                        # [E]
    n_ranks, before = 1, torch.zeros_like(block)
    for a in reversed(axes):
        size = parallel.size(a)
        if size == 1:
            continue
        every = parallel.gather(block[None], 0, size, a, tag=TRIPS,
                                site="counts")                   # [size, E]
        before = before + every[:parallel.index(a)].sum(0)
        block = every.sum(0)
        n_ranks *= size
    cap = moe_capacity(cfg, t * n_ranks)
    e_of = eidx.reshape(t * k)
    in_cap = pos_local + before[e_of] < cap
    if stats is not None:
        _add_stat(stats, "dropped", (~in_cap).sum())

    # this rank's experts: a buffer of their kept rows only
    local_e = e_of - expert_lo
    mine = in_cap & (local_e >= 0) & (local_e < e_loc)
    slot = torch.where(mine, pos_local, cap)
    le = torch.where(mine, local_e, 0)
    xin = parallel.enter(x, "model")
    x_rep = xin[:, None, :].expand(t, k, d).reshape(t * k, d)
    spare = torch.zeros((e_loc, cap + 1, d), dtype=x.dtype, device=x.device)
    spare[le, slot] = torch.where(mine[:, None], x_rep, 0)
    buf = spare[:, :cap]
    h = torch.bmm(buf, params["w1"])
    g = torch.bmm(buf, params["w3"])
    out_buf = torch.bmm(F.silu(h) * g, params["w2"])           # [E_loc, C, D]
    rows = torch.where(mine[:, None], out_buf[le, slot.clamp(max=cap - 1)],
                       0)
    gin = parallel.enter(gates, "model")
    y = (rows * gin.reshape(t * k, 1).to(rows.dtype)).reshape(t, k, d)
    return parallel.leave(y.sum(1), "model"), aux


def _add_stat(stats: dict, key: str, value: torch.Tensor) -> None:
    if key in stats:
        stats[key] += value         # in place: graph-safe
    else:
        stats[key] = value


# ----------------------------------------------------- all-to-all variant --

TRIPS = "moe"   # collective_counts tag of the all-to-all MoE's collectives


class _AllToAll(torch.autograd.Function):
    """`all_to_all` of equal chunks over `group`, counted under TRIPS at
    `site`. An exchange of equal chunks is its own transpose (rank r's
    chunk j came from rank j's chunk r), so the backward is the same trip
    for the gradients, counted at `site` + "_grad". A Function of the
    port's own rather than `torch.distributed.nn.functional`'s: each trip
    of the backward is counted beside the forward's, and its gradient
    rule is fixed here, whatever the torch release."""

    @staticmethod
    def forward(ctx, x, group, site):
        ctx.group, ctx.site = group, site
        return cdist.all_to_all(x, group, tag=TRIPS, site=site, dim="model")

    @staticmethod
    def backward(ctx, g):
        return cdist.all_to_all(g, ctx.group, tag=TRIPS,
                                site=ctx.site + "_grad", dim="model"), \
            None, None


class _AllReduceSum(torch.autograd.Function):
    """Sum of x over `group` on every rank; its backward sums the
    gradients the same way (each rank's input reaches every rank's
    output)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return cdist.all_reduce(x.clone(), group, dist.ReduceOp.SUM,
                                tag=TRIPS, site="aux")

    @staticmethod
    def backward(ctx, g):
        return cdist.all_reduce(g.clone(), ctx.group, dist.ReduceOp.SUM,
                                tag=TRIPS, site="aux_grad"), None


def all_reduce_mean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of x over the ranks of `group`, with autograd (the
    reference's `pmean`)."""
    return _AllReduceSum.apply(x, group) / dist.get_world_size(group)


class _PlaceRows(torch.autograd.Function):
    """out[slot[i]] = values[i] in n zero rows, where slot n is a spare row
    that is dropped. The kept slots are unique, so this only moves rows:
    no sum, no atomics, the same bits every call. Its backward gathers the
    gradient rows back (zero for a row sent to the spare)."""

    @staticmethod
    def forward(ctx, values, slot, n):
        out = values.new_zeros((n + 1, values.shape[1]))
        out[slot] = values
        ctx.save_for_backward(slot)
        ctx.n = n
        return out[:n]

    @staticmethod
    def backward(ctx, g):
        slot, = ctx.saved_tensors
        return _TakeRows.apply(g, slot), None, None


class _TakeRows(torch.autograd.Function):
    """table[slot[i]], a zero row where slot[i] = len(table) (the spare).
    The kept slots are unique, so the backward places the gradient rows
    back without a sum (`_PlaceRows`)."""

    @staticmethod
    def forward(ctx, table, slot):
        n = table.shape[0]
        ctx.save_for_backward(slot)
        ctx.n = n
        keep = (slot < n)[:, None]
        return torch.where(keep, table[slot.clamp(max=n - 1)], 0)

    @staticmethod
    def backward(ctx, g):
        slot, = ctx.saved_tensors
        return _PlaceRows.apply(g, slot, ctx.n), None


def positions_in_groups(group_of: torch.Tensor, n_groups: int, cap: int,
                        valid: torch.Tensor | None = None):
    """(pos_of, in_cap) for flat assignments `group_of` [N]: each one's
    slot in its group, in row order, and whether that slot is below `cap`.
    Rows where `valid` is False take no slot and are never in capacity.
    The reference's `_positions_in_groups`, with the one-hot laid out
    [G, N] so the scan runs along contiguous rows."""
    groups = torch.arange(n_groups, device=group_of.device)
    onehot = groups[:, None] == group_of[None, :]
    if valid is not None:
        onehot = onehot & valid[None, :]
    onehot = onehot.long()
    pos_of = ((onehot.cumsum(1) - onehot) * onehot).sum(0)
    in_cap = pos_of < cap
    if valid is not None:
        in_cap = in_cap & valid
    return pos_of, in_cap


def a2a_capacities(cfg: MoEConfig, n_tokens: int, ep: int,
                   capacity_factor: float | None = None) -> tuple[int, int]:
    """(cap_loc, cap2) of `moe_apply_a2a` for `n_tokens` tokens on each of
    ep ranks: send rows per peer, cf * T * k / ep, and rows per local
    expert over what can arrive, cf * ep * cap_loc / (E / ep); the
    reference's formulas, each rounded down to a multiple of 8 and at
    least 8 (the dense `moe_capacity` rounds up)."""
    cf = capacity_factor or cfg.capacity_factor
    cap_loc = max(8, int(cf * n_tokens * cfg.top_k / ep / 8) * 8)
    cap2 = max(8, int(cf * ep * cap_loc / (cfg.n_experts // ep) / 8) * 8)
    return cap_loc, cap2


def moe_apply_a2a(params: dict, x: torch.Tensor, cfg: MoEConfig, ep: int,
                  group, capacity_factor: float | None = None,
                  stats: dict | None = None):
    """Expert-parallel MoE with explicit all-to-all dispatch over the ep
    ranks of `group` (the mesh's "model" group). x: this rank's tokens
    [T, D]; params["w1"/"w3"/"w2"]: this rank's experts [E/ep, D, F] etc.
    (group rank i owns experts [i E/ep, (i+1) E/ep)); params["router"]:
    all experts [D, E]. Returns ([T, D] in x's dtype, aux f32): aux is
    this rank's own estimate of the load-balance loss, which the caller
    averages over the mesh.

    The capacities are `a2a_capacities`: cap_loc send rows per peer and cap2
    rows per local expert. Positions go in (token, slot) order at stage 1 and
    in arrival order (peer 0's chunk first) at stage 2, where empty send slots
    take none. A dropped assignment adds nothing. Four trips per call: the
    tokens, their local expert ids and their valid flags out, the expert rows
    back (`collective_counts()` under TRIPS); the backward makes two, the
    gradients of the token and row trips. Every row is placed and taken
    back by a slot of its own, so the call is bitwise repeatable.

    With `stats`, adds the assignments dropped at stage 1 (this rank's
    tokens the send buffer had no room for) to stats["dropped_stage1"],
    those dropped at stage 2 (rows that reached this rank's experts past
    cap2) to stats["dropped_stage2"], and both to stats["dropped"]
    (tensors, so nothing waits for the device).
    """
    t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    e_loc = e // ep
    cap_loc, cap2 = a2a_capacities(cfg, t, ep, capacity_factor)
    wide = torch.promote_types(x.dtype, torch.float32)

    logits = x.to(wide) @ params["router"].to(wide)            # [T, E]
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = torch.topk(probs, k, dim=-1)                 # [T, k]
    gates = gates / gates.sum(-1, keepdim=True)

    me = probs.mean(0)
    experts = torch.arange(e, device=x.device)
    fe = (eidx[:, 0, None] == experts).to(wide).mean(0)
    aux = e * (fe * me).sum()                                  # local estimate

    flat_e = eidx.reshape(t * k)
    tgt = flat_e // e_loc                                      # owner rank
    pos, in_cap = positions_in_groups(tgt, ep, cap_loc)
    n_send = ep * cap_loc
    slot = torch.where(in_cap, tgt * cap_loc + pos, n_send)    # spare: n_send

    # pack the send buffers [ep * cap_loc, ...], peer-major
    x_rep = x[:, None, :].expand(t, k, d).reshape(t * k, d)
    send_x = _PlaceRows.apply(x_rep, slot, n_send)
    send_el = torch.zeros(n_send + 1, dtype=torch.int32, device=x.device)
    send_el[slot] = torch.where(in_cap, flat_e % e_loc, 0).to(torch.int32)
    send_valid = torch.zeros(n_send + 1, dtype=torch.float32,
                             device=x.device)
    send_valid[slot] = in_cap.to(torch.float32)

    # chunk i of each result came from peer i
    recv_x = _AllToAll.apply(send_x, group, "dispatch")
    recv_el = cdist.all_to_all(send_el[:n_send], group, tag=TRIPS,
                               site="dispatch", dim="model").long()
    recv_valid = cdist.all_to_all(send_valid[:n_send], group, tag=TRIPS,
                                  site="dispatch", dim="model") > 0

    # the local experts over a compact buffer: cap2 is the dense path's
    # per-expert budget over what can arrive, not the ep * cap_loc bound
    pos2, in_cap2 = positions_in_groups(recv_el, e_loc, cap2,
                                        valid=recv_valid)
    slot2 = torch.where(in_cap2, recv_el * cap2 + pos2, e_loc * cap2)
    buf = _PlaceRows.apply(recv_x, slot2, e_loc * cap2).reshape(e_loc, cap2,
                                                                 d)
    h = torch.bmm(buf, params["w1"])
    g = torch.bmm(buf, params["w3"])
    out_buf = torch.bmm(F.silu(h) * g, params["w2"])           # [E_loc, C2, D]
    back = _TakeRows.apply(out_buf.reshape(e_loc * cap2, d), slot2)

    # the return trip, and the combine at the source
    ret = _AllToAll.apply(back, group, "return")
    rows = _TakeRows.apply(ret, slot)                          # [T*k, D]
    if stats is not None:
        drop1, drop2 = (~in_cap).sum(), (recv_valid & ~in_cap2).sum()
        _add_stat(stats, "dropped_stage1", drop1)
        _add_stat(stats, "dropped_stage2", drop2)
        _add_stat(stats, "dropped", drop1 + drop2)
    y = (rows * gates.reshape(t * k, 1).to(rows.dtype)).reshape(t, k, d)
    return y.sum(1), aux
