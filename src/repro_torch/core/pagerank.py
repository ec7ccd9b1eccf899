"""CPAA PageRank solvers in PyTorch (port of `repro.core.pagerank`).

* cpaa          — the paper's Chebyshev Polynomial Approximation Algorithm
                  (Algorithm 1), via the three-term recurrence
                  T_{k+1}(P)p = 2 P T_k(P)p - T_{k-1}(P)p.
* cpaa_adaptive — residual-controlled CPAA: the same recurrence in chunks,
                  with an a-posteriori exit once the normalized L1 residual
                  between accumulator snapshots drops under tol (never past
                  the Formula 8 round bound). Batched [n, B] solves carry a
                  per-column convergence mask: converged columns feed zeros
                  to the SpMM and stay frozen.

PyTorch runs eagerly, so the reference's `lax.scan` is a Python loop and its
`lax.while_loop` a host loop that syncs once per chunk (on `any(active)`),
never once per round: the round counter is known on the host, and c_k
stays on the device.

Every solver takes a DeviceGraph or an engine (`core.engine`); the entry
points `cpaa` and `cpaa_adaptive` also take a host `Graph` plus `device`
(None = cuda). They return column-normalized PageRank in original vertex
ids. The default personalization is uniform with unit mass.

* power_refine  — warm-started power rounds x <- c P x + (1-c) p from a
                  cached score vector (the serve tier's refresh tick).
* degree_prior  — deg / 2m, the exact stationary vector of P on an
                  undirected graph: an analytic oracle at any scale.

The baseline solvers (power, forward push, Monte Carlo) come with a later
slice.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.chebyshev import ChebSchedule, default_chunk, \
    make_schedule
from repro_torch.core.engine import as_engine
from repro_torch.graph.ops import device_graph
from repro_torch.graph.structure import Graph

__all__ = ["PageRankResult", "cpaa", "cpaa_adaptive", "cpaa_fixed",
           "cpaa_adaptive_fixed", "power_refine", "degree_prior"]


@dataclass
class PageRankResult:
    pi: torch.Tensor         # [n] or [n, B], column-normalized
    iterations: int          # rounds actually run (max over columns)
    history: torch.Tensor | None = None  # [M, ...] per-round accumulators
    # adaptive-solve telemetry (None on the fixed-round paths):
    rounds_bound: int | None = None        # a-priori Formula 8 round count
    column_rounds: np.ndarray | None = None  # [] or [B] rounds per column
    residual: np.ndarray | None = None     # [] or [B] last chunk L1 residual

    @property
    def rounds_saved(self) -> int | None:
        """Rounds the residual exit saved vs the a-priori bound."""
        if self.rounds_bound is None:
            return None
        return self.rounds_bound - self.iterations


def _normalize(acc: torch.Tensor) -> torch.Tensor:
    # tiny guard: an all-zero column (empty seed set) comes back as zeros
    # instead of 0/0 NaNs that would poison result caches
    s = acc.sum(dim=0, keepdim=acc.ndim > 1)
    tiny = torch.finfo(acc.dtype).tiny
    return acc / torch.where(s.abs() < tiny, torch.full_like(s, tiny), s)


def _solve_engine(dg, device):
    """Engine for an entry point's first argument: a host `Graph` is put on
    `device` (None = cuda, raising without a GPU); a DeviceGraph or engine
    is used where it lives, and `device`, if given, must match it."""
    if isinstance(dg, Graph):
        return as_engine(device_graph(dg, device=device))
    eng = as_engine(dg)
    if device is not None and torch.device(device) != eng.device:
        raise ValueError(f"engine lives on {eng.device}, device={device!r}")
    return eng


def degree_prior(g: Graph) -> np.ndarray:
    """deg / 2m — the stationary distribution of P on an undirected graph.

    P = A D^{-1} with a symmetric A gives P x = x for x = deg/2m exactly, so
    PageRank personalized AT the prior returns the prior for every damping
    factor. That makes it an oracle where a dense solve is unaffordable.
    Host float numpy; takes a `Graph`.
    """
    deg = g.deg.astype(float)
    return deg / max(deg.sum(), 1.0)


def _uniform_p(eng) -> torch.Tensor:
    """Uniform UNIT-mass personalization."""
    return torch.full((eng.n,), 1.0 / eng.n, dtype=eng.dtype,
                      device=eng.device)


def cpaa_fixed(dg, coeffs: torch.Tensor, p: torch.Tensor, rounds: int,
               keep_history: bool = False):
    """CPAA with a fixed round count.

    dg:     DeviceGraph or engine.
    coeffs: [rounds+1] on the engine's device, coeffs[0] already halved.
    p:      [n] or [n, B] personalization (any scaling; the final
            normalization absorbs it).
    Returns (pi, history) — history is [rounds-1, ...] when kept, else None.
    """
    eng = as_engine(dg)
    t_prev = eng.to_internal(p)     # T_0(P) p
    acc = coeffs[0] * t_prev        # (c0/2) T_0 p
    t_cur = eng.apply(t_prev)       # T_1(P) p = P p
    acc = acc + coeffs[1] * t_cur
    hist = []
    for k in range(2, rounds + 1):
        y = eng.apply(t_cur)        # the round's only graph work
        t_next, acc = eng.cheb_round(y, t_prev, acc, coeffs[k])
        t_prev, t_cur = t_cur, t_next
        if keep_history:
            hist.append(eng.from_internal(acc))
    history = None
    if keep_history:
        history = torch.stack(hist) if hist else \
            acc.new_zeros((0,) + (eng.n,) + tuple(acc.shape[1:]))
    return _normalize(eng.from_internal(acc)), history


def cpaa(dg, c: float = 0.85, tol: float = 1e-6,
         p: torch.Tensor | None = None,
         schedule: ChebSchedule | None = None,
         keep_history: bool = False, device=None) -> PageRankResult:
    """The paper's Algorithm 1. Rounds chosen from ERR_M < tol (Formula 8).

    dg: a host `Graph` (put on `device`, None = cuda), a DeviceGraph or an
    engine."""
    eng = _solve_engine(dg, device)
    sched = schedule or make_schedule(c, tol)
    if p is None:
        p = _uniform_p(eng)
    coeffs = torch.as_tensor(sched.coeffs, dtype=p.dtype).to(p.device)
    pi, hist = cpaa_fixed(eng, coeffs, p, rounds=sched.rounds,
                          keep_history=keep_history)
    return PageRankResult(pi=pi, iterations=sched.rounds,
                          history=hist if keep_history else None)


def cpaa_adaptive_fixed(dg, p: torch.Tensor, c, tol, max_rounds: int,
                        chunk: int = 4):
    """Residual-controlled CPAA core.

    Runs the recurrence in chunks of `chunk` rounds; after each chunk the
    normalized accumulator is snapshotted and the per-column L1 residual
    against the previous snapshot decides which columns keep iterating.
    Converged columns freeze and feed ZEROS into the SpMM; the loop exits
    when every column has converged or `max_rounds` is reached.

    sq, beta, c0 and every c_k are float32 tensors on the device, computed
    exactly as the reference computes them (c_k = c_{k-1} * beta), so the
    round counts match it. The host syncs once per chunk, on any(active).

    Returns (pi, rounds_used, column_rounds, residual):
      pi            [n] / [n, B] column-normalized PageRank.
      rounds_used   int — rounds actually run (max over columns).
      column_rounds [] / [B] int32 tensor — rounds until each column
                    converged.
      residual      [] / [B] tensor — last chunk's normalized L1 residual.
    """
    eng = as_engine(dg)
    t_prev = eng.to_internal(p)         # T_0(P) p
    dtype, dev = t_prev.dtype, t_prev.device
    c = torch.tensor(c, dtype=dtype, device=dev)
    tol = torch.tensor(tol, dtype=dtype, device=dev)
    tiny = torch.tensor(torch.finfo(dtype).tiny, dtype=dtype, device=dev)
    sq = torch.sqrt(1.0 - c * c)
    beta = (1.0 - sq) / c
    c0 = 2.0 / sq

    cols = () if t_prev.ndim == 1 else (t_prev.shape[1],)

    def colnorm(a):
        s = a.sum(dim=0)
        return a / torch.where(s.abs() < tiny, tiny, s)

    acc = (0.5 * c0) * t_prev           # (c0/2) T_0 p
    t_cur = eng.apply(t_prev)           # T_1(P) p = P p
    ck = c0 * beta                      # c_1
    acc = acc + ck * t_cur

    active = torch.ones(cols, dtype=torch.bool, device=dev)
    col_rounds = torch.ones(cols, dtype=torch.int32, device=dev)
    resid = torch.full(cols, float("inf"), dtype=dtype, device=dev)
    snap = colnorm(acc)
    zero = torch.zeros((), dtype=dtype, device=dev)
    k = 1
    # one host sync per chunk: the while condition's any(active)
    while k < max_rounds and bool(active.any()):
        mask = active if t_prev.ndim == 1 else active[None, :]
        for _ in range(chunk):
            if k >= max_rounds:         # stay within the a-priori bound
                break
            ck = ck * beta
            y = eng.apply(torch.where(mask, t_cur, zero))
            t_next, acc_next = eng.cheb_round(
                y, torch.where(mask, t_prev, zero), acc, ck)
            t_prev = torch.where(mask, t_cur, t_prev)
            t_cur = torch.where(mask, t_next, t_cur)
            acc = torch.where(mask, acc_next, acc)
            k += 1
        norm = colnorm(acc)
        resid = (norm - snap).abs().sum(dim=0)
        col_rounds = torch.where(active, torch.full_like(col_rounds, k),
                                 col_rounds)
        active = active & (resid > tol)
        snap = norm
    return _normalize(eng.from_internal(acc)), k, col_rounds, resid


def cpaa_adaptive(dg, c: float = 0.85, tol: float | None = None,
                  p: torch.Tensor | None = None,
                  schedule: ChebSchedule | None = None,
                  chunk: int | None = None, device=None) -> PageRankResult:
    """Algorithm 1 with runtime residual control (a-posteriori early exit).

    The schedule's round count is the hard cap, so `result.iterations <=
    result.rounds_bound` always holds. `tol` defaults to 1e-6, or to an
    explicit schedule's err_bound; `chunk` to `default_chunk(c, tol)`.
    dg: a host `Graph` (put on `device`, None = cuda), a DeviceGraph or an
    engine.
    """
    eng = _solve_engine(dg, device)
    sched = schedule or make_schedule(c, tol if tol is not None else 1e-6)
    if tol is None:
        tol = float(sched.err_bound) if schedule is not None else 1e-6
    if p is None:
        p = _uniform_p(eng)
    if chunk is None:
        chunk = default_chunk(sched.c, tol)
    pi, k, col_rounds, resid = cpaa_adaptive_fixed(
        eng, p, sched.c, tol, max_rounds=sched.rounds, chunk=chunk)
    return PageRankResult(pi=pi, iterations=k, rounds_bound=sched.rounds,
                          column_rounds=col_rounds.cpu().numpy(),
                          residual=resid.cpu().numpy())


def power_refine(dg, x0: torch.Tensor, p: torch.Tensor, c,
                 rounds: int) -> torch.Tensor:
    """Warm-started refinement: `rounds` of x <- c P x + (1-c) p from x0.

    CPAA's Chebyshev series cannot be resumed from a cached result, but the
    power recurrence converges to the same fixed point and contracts the
    L1 error by c per round from ANY start, so a cached score vector that
    is already close needs only the rounds that bring c^rounds |x0 - pi|
    under tol. x0/p: [n] or [n, B] (x0 need not be normalized; p is
    normalized to unit restart mass). A host loop over `eng.apply`, with c
    a tensor of the solve dtype. Returns column-normalized PageRank.
    """
    eng = as_engine(dg)
    x = eng.to_internal(x0)
    pp = _normalize(eng.to_internal(p))   # unit restart mass
    c = torch.tensor(c, dtype=x.dtype, device=x.device)
    for _ in range(rounds):
        x = (c * eng.apply(x) + (1.0 - c) * pp).to(x.dtype)
    return _normalize(eng.from_internal(x))
