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

Every reduction over an internal-layout array (a column sum, a residual, a
max) goes through the engine's `colsum` / `amax` hooks: local on one
device, all-reduced across ranks on the sharded engines, whose ranks each
hold a slice of the vector. So every rank reads the same residuals and
stops at the same round.

Every solver takes a DeviceGraph or an engine (`core.engine`); the entry
points `cpaa` and `cpaa_adaptive` also take a host `Graph` plus `device`
(None = cuda). They return column-normalized PageRank in original vertex
ids. The default personalization is uniform with unit mass.

* power_refine  — warm-started power rounds x <- c P x + (1-c) p from a
                  cached score vector (the serve tier's refresh tick).
* degree_prior  — deg / 2m, the exact stationary vector of P on an
                  undirected graph: an analytic oracle at any scale.

The paper's baselines:

* power         — the Power method (SPI/MPI in the paper): a host loop over
                  `eng.apply` that checks the relative max residual once
                  per chunk of rounds, and stops at the round the
                  reference's `while_loop` stops at.
* forward_push  — truncated geometric series sum_{k<=M} (cP)^k p (the
                  algebraic Forward Push / IFP1 analogue).
* monte_carlo   — terminating random walks over the COO graph's CSR view,
                  drawn from an explicit `torch.Generator`.
* true_pagerank_dense — the O(n^3) float64 numpy oracle (test ground
                  truth for small graphs), copied.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.chebyshev import ChebSchedule, default_chunk, \
    make_schedule
from repro_torch.core.engine import CooEngine, as_engine
from repro_torch.graph.ops import device_graph
from repro_torch.graph.structure import Graph

__all__ = ["PageRankResult", "cpaa", "cpaa_adaptive", "cpaa_fixed",
           "cpaa_adaptive_fixed", "cpaa_adaptive_loop", "power_refine",
           "degree_prior", "power", "forward_push", "monte_carlo",
           "true_pagerank_dense"]


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


def _normalize(acc: torch.Tensor, colsum=None) -> torch.Tensor:
    """Columns of acc scaled to unit sum. `colsum` is the engine's hook for
    an internal-layout acc (None = a whole vector, summed locally)."""
    # tiny guard: an all-zero column (empty seed set) comes back as zeros
    # instead of 0/0 NaNs that would poison result caches
    s = acc.sum(dim=0) if colsum is None else colsum(acc)
    if acc.ndim > 1:
        s = s[None, :]
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


def _cheb_sum(eng, coeffs: torch.Tensor, t_prev: torch.Tensor, rounds: int,
              hist: list | None = None) -> torch.Tensor:
    """The Chebyshev sum acc = sum_k coeffs[k] T_k(P) p of the internal-
    layout T_0(P) p = t_prev; with `hist`, each round's acc is appended
    to it in the original layout."""
    acc = coeffs[0] * t_prev        # (c0/2) T_0 p
    t_cur = eng.apply(t_prev)       # T_1(P) p = P p
    acc = acc + coeffs[1] * t_cur
    for k in range(2, rounds + 1):
        y = eng.apply(t_cur)        # the round's only graph work
        t_next, acc = eng.cheb_round(y, t_prev, acc, coeffs[k])
        t_prev, t_cur = t_cur, t_next
        if hist is not None:
            hist.append(eng.from_internal(acc))
    return acc


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
    hist = [] if keep_history else None
    acc = _cheb_sum(eng, coeffs, eng.to_internal(p), rounds, hist)
    history = None
    if keep_history:
        history = torch.stack(hist) if hist else \
            acc.new_zeros((0,) + (eng.n,) + tuple(acc.shape[1:]))
    return _normalize(eng.from_internal(acc)), history


def cpaa_fixed_local(eng, coeffs: torch.Tensor, p: torch.Tensor,
                     rounds: int) -> torch.Tensor:
    """`cpaa_fixed` on a sharded engine in the reference's production
    layout: p is this rank's slice of the engine's internal layout, and
    so is the returned pi, normalized over every rank's rows (the
    engine's `colsum`). No layout trip at either end."""
    return _normalize(_cheb_sum(eng, coeffs, p, rounds), eng.colsum)


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
    """Residual-controlled CPAA core: `cpaa_adaptive_loop`, then the
    accumulator in vertex order, column-normalized.

    Returns (pi, rounds_used, column_rounds, residual):
      pi            [n] / [n, B] column-normalized PageRank.
      rounds_used   int — rounds actually run (max over columns).
      column_rounds [] / [B] int32 tensor — rounds until each column
                    converged.
      residual      [] / [B] tensor — last chunk's normalized L1 residual.
    """
    acc, _, k, col_rounds, resid = cpaa_adaptive_loop(dg, p, c, tol,
                                                      max_rounds, chunk)
    return _normalize(as_engine(dg).from_internal(acc)), k, col_rounds, \
        resid


def cpaa_adaptive_loop(dg, p: torch.Tensor, c, tol, max_rounds: int,
                       chunk: int = 4):
    """The residual-controlled CPAA loop, in the engine's internal layout.

    Runs the recurrence in chunks of `chunk` rounds; after each chunk the
    normalized accumulator is snapshotted and the per-column L1 residual
    against the previous snapshot decides which columns keep iterating.
    Converged columns freeze and feed ZEROS into the SpMM; the loop exits
    when every column has converged or `max_rounds` is reached.

    sq, beta, c0 and every c_k are float32 tensors on the device, computed
    exactly as the reference computes them (c_k = c_{k-1} * beta), so the
    round counts match it. The host syncs once per chunk, on any(active).

    The reference masks every round's inputs and outputs with jnp.where.
    Here a round is the engine's `cheb_round_masked` (one pass, in place:
    t'' over the SpMM's output y, acc' over acc), which writes t'' = 0 in
    a frozen column and leaves its acc alone; (t_prev, t_cur) rotate by
    name and t_cur goes to the SpMM unmasked. A frozen column's t is never
    read again: one round after the freeze the SpMM sees its zeros, and
    the SpMM column of the freeze round itself is dropped by the mask.
    Each SpMM column depends only on the same input column, so acc, the
    column rounds and the residuals are those of the reference's masked
    loop. The chunk's snapshot and residual are the engine's
    `chunk_residual` (one kernel on the card, the snapshot in place).

    Returns (acc, snap, rounds_used, column_rounds, residual):
      acc           the accumulator, internal layout, not normalized.
      snap          acc column-normalized over every rank's rows (the
                    engine's colsum), internal layout: the last chunk's
                    snapshot, which always follows the last round, or the
                    first normalization when no chunk ran. The service's
                    tick ranks it in place (`_solve_topk_adaptive`).
      rounds_used   int — rounds actually run (max over columns).
      column_rounds [] / [B] int32 tensor — rounds until each column
                    converged.
      residual      [] / [B] tensor — last chunk's normalized L1 residual.
    """
    eng = as_engine(dg)
    t_prev = eng.to_internal(p)         # T_0(P) p; may be p itself: read only
    dtype, dev = t_prev.dtype, t_prev.device
    # device scalars by a fill, not torch.tensor: a copy from host memory
    # would wait for the stream (under async dispatch, the batch in flight)
    c = torch.full((), c, dtype=dtype, device=dev)
    tol = torch.full((), tol, dtype=dtype, device=dev)
    sq = torch.sqrt(1.0 - c * c)
    beta = (1.0 - sq) / c
    c0 = 2.0 / sq

    cols = () if t_prev.ndim == 1 else (t_prev.shape[1],)

    acc = (0.5 * c0) * t_prev           # (c0/2) T_0 p
    t_cur = eng.apply(t_prev)           # T_1(P) p = P p
    ck = c0 * beta                      # c_1
    acc = acc + ck * t_cur              # the loop's own buffer from here on

    active = torch.ones(cols, dtype=torch.bool, device=dev)
    col_rounds = torch.ones(cols, dtype=torch.int32, device=dev)
    resid = torch.full(cols, float("inf"), dtype=dtype, device=dev)
    snap = _normalize(acc, eng.colsum)
    k = 1
    # one host sync per chunk: the while condition's any(active), the
    # counterpart of the reference's lax.while_loop condition
    # torchlint: disable=TL001 -- the loop's one host read per chunk
    while k < max_rounds and bool(active.any()):
        for _ in range(chunk):
            if k >= max_rounds:         # stay within the a-priori bound
                break
            ck = ck * beta
            t_next, acc = eng.cheb_round_masked(eng.apply(t_cur), t_prev,
                                                acc, ck, active)
            t_prev, t_cur = t_cur, t_next
            k += 1
        resid = eng.chunk_residual(acc, snap)   # snap <- normalized acc
        col_rounds = torch.where(active, torch.full_like(col_rounds, k),
                                 col_rounds)
        active = active & (resid > tol)
    return acc, snap, k, col_rounds, resid


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
    pp = _normalize(eng.to_internal(p), eng.colsum)   # unit restart mass
    c = torch.full((), c, dtype=x.dtype, device=x.device)   # no host copy
    for _ in range(rounds):
        x = (c * eng.apply(x) + (1.0 - c) * pp).to(x.dtype)
    return _normalize(eng.from_internal(x))


# rounds between `power`'s host reads of its stop flag
POWER_CHECK_EVERY = 8


def power(dg, c: float = 0.85, tol: float = 1e-10,
          p: torch.Tensor | None = None, max_iter: int = 500,
          device=None) -> PageRankResult:
    """Power iteration x <- c P x + (1-c) p (the paper's SPI/MPI baseline).

    Runs until the relative max residual max|x' - x| / max|x'| (over all
    entries, in p's dtype) drops under `tol`, or `max_iter` rounds. The
    reference's `while_loop` tests the residual before every round; here
    the test runs on the device (a done flag and the round count are
    tensors, and a round after the stop is masked off), and the host reads
    the flag back once per POWER_CHECK_EVERY rounds. So the result and the
    iteration count are the reference's, and the card syncs once per
    chunk; at most POWER_CHECK_EVERY - 1 masked rounds run past the stop.

    dg: a host `Graph` (put on `device`, None = cuda), a DeviceGraph or an
    engine. x starts at p (default uniform, unit mass).
    """
    eng = _solve_engine(dg, device)
    if p is None:
        p = _uniform_p(eng)
    x0 = eng.to_internal(p)
    dtype, dev = x0.dtype, x0.device
    ct = torch.tensor(c, dtype=dtype, device=dev)
    tol_t = torch.tensor(tol, dtype=dtype, device=dev)
    tiny = torch.tensor(torch.finfo(dtype).tiny, dtype=dtype, device=dev)
    restart = (1.0 - ct) * x0
    x = x0
    k = torch.zeros((), dtype=torch.int32, device=dev)
    active = torch.ones((), dtype=torch.bool, device=dev)
    rounds = 0
    while rounds < max_iter:
        for _ in range(min(POWER_CHECK_EVERY, max_iter - rounds)):
            x_new = (ct * eng.apply(x) + restart).to(dtype)
            resid = eng.amax((x_new - x).abs()) / \
                torch.maximum(eng.amax(x_new.abs()), tiny)
            x = torch.where(active, x_new, x)
            k = k + active.to(torch.int32)
            active = active & (resid >= tol_t)
            rounds += 1
        if not bool(active):            # the chunk's one host sync
            break
    return PageRankResult(pi=_normalize(eng.from_internal(x)),
                          iterations=int(k))


def forward_push(dg, c: float = 0.85, rounds: int = 50,
                 p: torch.Tensor | None = None,
                 device=None) -> PageRankResult:
    """Truncated geometric series sum_{k<=M} (cP)^k p — the monomial-basis
    baseline CPAA is compared against (paper §1, §3). `rounds` SpMMs, no
    host sync. dg: a host `Graph` (put on `device`, None = cuda), a
    DeviceGraph or an engine."""
    eng = _solve_engine(dg, device)
    if p is None:
        p = _uniform_p(eng)
    r = eng.to_internal(p)
    acc = r
    ct = torch.tensor(c, dtype=r.dtype, device=r.device)
    for _ in range(rounds):
        r = ct * eng.apply(r)       # residual mass pushed one hop
        acc = acc + r
    return PageRankResult(pi=_normalize(eng.from_internal(acc)),
                          iterations=rounds)


def monte_carlo(dg, c: float = 0.85, walks_per_node: int = 16,
                max_len: int = 64, seed: int = 0,
                device=None) -> PageRankResult:
    """Terminating random walks; pi_i ∝ #walks that stop at i (paper §1
    [6]). COO only (a DeviceGraph or CooEngine; a host `Graph` goes on
    `device`, None = cuda): walks step through the graph's sorted-src CSR
    view. A walk stops with probability 1 - c per step, and at a degree-0
    vertex, whose CSR range is empty. Random numbers come from a
    `torch.Generator` on the graph's device seeded with `seed`, so a run is
    reproducible on one device (not across devices, nor equal to the
    reference's JAX stream)."""
    eng = _solve_engine(dg, device)
    if not isinstance(eng, CooEngine):
        raise TypeError("monte_carlo samples the COO edge list; pass a "
                        "DeviceGraph or CooEngine")
    n = eng.dg.n
    deg, row_start, dst_sorted = eng.dg.csr()   # host-built once, cached
    dev = deg.device
    if dst_sorted.shape[0] == 0:
        # edgeless graph: every walk stops at its start
        return PageRankResult(pi=torch.full((n,), 1.0 / n, device=dev),
                              iterations=0)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    walkers = torch.arange(n, dtype=torch.int64,
                           device=dev).repeat(walks_per_node)
    alive = torch.ones_like(walkers, dtype=torch.bool)
    counts = torch.zeros(n, dtype=torch.float32, device=dev)
    last = dst_sorted.shape[0] - 1
    for _ in range(max_len):
        d = deg[walkers]
        stop = (torch.rand(walkers.shape, generator=gen, device=dev) > c) \
            | (d == 0)
        counts.index_add_(0, walkers, (alive & stop).to(torch.float32))
        alive = alive & ~stop
        u = torch.rand(walkers.shape, generator=gen, device=dev)
        pick = (row_start[walkers] + (u * d).to(torch.int32)).clamp(0, last)
        walkers = torch.where(alive, dst_sorted[pick.long()].long(), walkers)
    counts.index_add_(0, walkers, alive.to(torch.float32))
    return PageRankResult(pi=counts / counts.sum(), iterations=max_len)


def true_pagerank_dense(g: Graph, c: float = 0.85, p=None) -> np.ndarray:
    """O(n^3) direct solve (1-c)(I - cP)^{-1} p in float64 numpy — the test
    oracle for small graphs (a copy of the reference's).

    p: optional [n] or [n, B] personalization (default uniform). Columns are
    normalized like the solvers' output (each sums to 1).
    """
    n = g.n
    a = np.zeros((n, n), float)
    a[g.dst, g.src] = 1.0
    deg = a.sum(axis=0)
    p_mat = a / np.maximum(deg, 1.0)[None, :]
    if p is None:
        p = np.ones(n) / n
    p = np.asarray(p, float)
    pi = np.linalg.solve(np.eye(n) - c * p_mat, (1.0 - c) * p)
    return pi / pi.sum(axis=0, keepdims=p.ndim > 1)
