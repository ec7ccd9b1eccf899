"""Online Personalized-PageRank query service with micro-batching (port of
`repro.serve.pagerank_service`).

  * queries (graph name, seed set, c, tol, top_k) pass admission control
    and queue in the FIFO scheduler (`serve/scheduler.py`);
  * every `tick()` packs one released compatible group — same graph and
    same (c, tol) — into an [n, B] personalization matrix built on the
    device and solves it in ONE call on the graph's cached engine (COO
    `index_add_` or the block-ELL CUDA kernels, picked by the registry);
    identical queries in a group share one column;
  * with `adaptive=True` (the config default) the tick solves through the
    residual-controlled `cpaa_adaptive_fixed`: converged columns stop
    feeding the SpMM, and the tick ends when every live column reaches tol,
    never past the Formula 8 round bound;
  * batch widths are padded to power-of-two buckets (pad columns carry
    uniform mass and are discarded);
  * results come back as ranked top-k lists with ties broken lower index
    first, as `lax.top_k` breaks them in the reference;
  * an LRU cache keyed by (graph, epoch, seeds, c, tol) serves repeats.

Dispatch is synchronous: a tick solves and harvests its batch before it
returns. `stats` holds the reference's counter keys as plain counters;
keys of paths not ported yet stay 0. Edge updates (`update_graph`), the
background refresh tick, async dispatch, the deadline scheduler and the
observability layer come with later slices and raise NotImplementedError
until then.
"""
from __future__ import annotations

import math
import time
import warnings
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.pagerank import cpaa_adaptive_fixed, cpaa_fixed
from repro_torch.serve.graph_registry import GraphRegistry
from repro_torch.serve.result_cache import ResultCache
from repro_torch.serve.scheduler import (AdmissionRejected, FifoScheduler,
                                         QueueEntry, TenantSpec)

__all__ = ["PPRQuery", "PPRResult", "PageRankService",
           "topk_lower_index_first", "check_ported", "STATS_KEYS"]

STATS_KEYS = ("queries", "cache_hits", "solves", "solved_queries",
              "dropped_queries", "rejected_queries", "deadline_misses",
              "ticks", "held_ticks", "padded_columns", "updates",
              "rounds_used", "rounds_bound", "noop_updates",
              "incremental_updates", "cache_dropped", "cache_retained",
              "refreshes", "refresh_deferred")


@dataclass(frozen=True)
class PPRQuery:
    """One personalized-PageRank request: restart mass uniform over `seeds`.

    Seeds are canonicalized (deduped + sorted) at construction, so the
    cache key and the personalization column always agree. `tenant` and
    `deadline_s` are scheduling attributes, not part of the cache key.
    """

    qid: int
    graph: str
    seeds: tuple[int, ...]
    c: float = 0.85
    tol: float = 1e-4
    top_k: int = 8
    tenant: str = "default"
    deadline_s: float | None = None

    def __post_init__(self):
        object.__setattr__(
            self, "seeds", tuple(sorted({int(s) for s in self.seeds})))

    def key(self, epoch: int) -> tuple:
        """Cache key (graph, epoch, seeds, c, tol) of this query."""
        return (self.graph, epoch, self.seeds, float(self.c), float(self.tol))


@dataclass
class PPRResult:
    """Ranked answer to one `PPRQuery`: parallel `indices`/`scores` of
    length top_k, by descending score."""

    qid: int
    graph: str
    epoch: int
    indices: np.ndarray      # [top_k] int32, ranked by descending score
    scores: np.ndarray       # [top_k] float32, normalized PPR mass
    cached: bool = False
    batch_size: int = 0      # distinct columns in the solve that produced this


def topk_lower_index_first(x: torch.Tensor, k: int):
    """Top-k along dim 1 of [B, n], ties broken lower index first.

    `torch.topk` does not fix the order (or, at the k-th value, the choice)
    of tied entries; `lax.top_k` takes the lower index first. So: take the
    k-th largest value, keep every entry above it plus the lowest-index
    entries equal to it until k are kept, and order those by descending
    value with a stable sort over ascending indices.
    Returns ([B, k] int32 indices, [B, k] values).
    """
    kth = torch.topk(x, k, dim=1).values[:, k - 1:k]
    gt = x > kth
    eq = x == kth
    need = k - gt.sum(dim=1, keepdim=True, dtype=torch.int32)
    take = gt | (eq & (eq.cumsum(dim=1, dtype=torch.int32) <= need))
    idx = take.nonzero()[:, 1].reshape(x.shape[0], k)
    vals = x.gather(1, idx)
    order = torch.sort(vals, dim=1, descending=True, stable=True).indices
    return idx.gather(1, order).to(torch.int32), vals.gather(1, order)


def _solve_topk(engine, coeffs: torch.Tensor, p: torch.Tensor, rounds: int,
                k: int):
    """One micro-batch: [n, B] personalization -> ([B, k] ids, [B, k] mass).
    The engine owns any vertex reordering, so ids are original ids."""
    pi, _ = cpaa_fixed(engine, coeffs, p, rounds=rounds)
    return topk_lower_index_first(pi.T, k)


def _solve_topk_adaptive(engine, p: torch.Tensor, c, tol, max_rounds: int,
                         chunk: int, k: int):
    """Adaptive micro-batch: like _solve_topk with residual-controlled round
    counts; also returns rounds run, per-column rounds and residuals."""
    pi, rounds_used, col_rounds, resid = cpaa_adaptive_fixed(
        engine, p, c, tol, max_rounds=max_rounds, chunk=chunk)
    idx, scores = topk_lower_index_first(pi.T, k)
    return idx, scores, rounds_used, col_rounds, resid


def check_ported(scheduler: str = "fifo", async_dispatch: bool = False):
    """Raise NotImplementedError for service knobs not ported yet."""
    if scheduler != "fifo":
        raise NotImplementedError(
            f"scheduler {scheduler!r} is not ported to repro_torch yet "
            "(ROADMAP A5: deadline scheduler); use 'fifo'")
    if async_dispatch:
        raise NotImplementedError(
            "async_dispatch is not ported to repro_torch yet (ROADMAP A5: "
            "CUDA stream + event fenced at harvest)")


@dataclass
class _Batch:
    """One dispatched batch solve and the host-side context to materialize
    its results."""

    graph: str
    epoch: int
    live: list                  # [QueueEntry] riding this solve
    cols: dict                  # cache key -> column index
    col_of: list                # per live entry: its column index
    n_reps: int                 # distinct columns (pre-padding)
    b_pad: int
    rounds_used: int
    rounds_bound: int
    idx: torch.Tensor           # [B, k] on the device
    scores: torch.Tensor        # [B, k] on the device


class PageRankService:
    """Admission control + FIFO scheduler + micro-batcher + result cache
    over a `GraphRegistry`.

    Args mirror the reference. Ported: max_batch, cache_capacity,
    max_top_k, adaptive, adaptive_chunk, tenants, default_deadline_s,
    admission_depth, clock. `invalidation_radius`, `refresh_batch`,
    `refresh_rounds` and `refresh_margin` are stored (they act only on
    edge updates). `scheduler="deadline"` and `async_dispatch=True` raise
    NotImplementedError.

    Invariant: every accepted query is answered under exactly one
    disposition, so `queries == cache_hits + solved_queries +
    dropped_queries` at any quiescent point.
    """

    def __init__(self, registry: GraphRegistry, max_batch: int = 32,
                 cache_capacity: int = 4096, max_top_k: int = 16,
                 adaptive: bool = False, adaptive_chunk: int | None = None,
                 invalidation_radius: int | None = None,
                 refresh_batch: int = 0, refresh_rounds: int = 8,
                 refresh_margin: int = 1,
                 scheduler: str = "fifo",
                 tenants=None,
                 default_deadline_s: float | None = None,
                 admission_depth: int | None = None,
                 async_dispatch: bool = False,
                 clock=None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        check_ported(scheduler, async_dispatch)
        self.registry = registry
        self.max_batch = max_batch
        self.max_top_k = max_top_k
        self.adaptive = adaptive
        self.adaptive_chunk = adaptive_chunk
        self.invalidation_radius = invalidation_radius
        self.refresh_batch = refresh_batch
        self.refresh_rounds = refresh_rounds
        self.refresh_margin = refresh_margin
        self.cache = ResultCache(cache_capacity)
        self._clock = clock if clock is not None else time.perf_counter
        self._results: dict[int, PPRResult] = {}
        # power-of-two batch buckets
        self._buckets = []
        b = 1
        while b < max_batch:
            self._buckets.append(b)
            b *= 2
        self._buckets.append(max_batch)
        self.default_deadline_s = default_deadline_s
        if tenants is None:
            tenants = {}
        elif not isinstance(tenants, dict):
            tenants = {t.name: t for t in tenants}
        self.tenants: dict[str, TenantSpec] = dict(tenants)
        self._default_spec = TenantSpec(
            deadline_s=math.inf if default_deadline_s is None
            else float(default_deadline_s),
            max_depth=admission_depth)
        self.scheduler = FifoScheduler(max_batch, max_depth=admission_depth)
        self._counts = dict.fromkeys(STATS_KEYS, 0)
        self._submitted = 0     # total accepted queries (qid autogeneration)

    @property
    def stats(self) -> dict:
        """Counter dict with the reference's keys (paths not ported yet
        stay 0)."""
        return dict(self._counts)

    # ---- submission -------------------------------------------------------
    def _tenant_spec(self, tenant: str) -> TenantSpec:
        return self.tenants.get(tenant, self._default_spec)

    def _deadline_budget(self, q: PPRQuery, spec: TenantSpec) -> float:
        """The query's own `deadline_s`, else the tenant's, else the service
        default, else unbounded."""
        if q.deadline_s is not None:
            return float(q.deadline_s)
        if spec.deadline_s != math.inf:
            return float(spec.deadline_s)
        if self.default_deadline_s is not None:
            return float(self.default_deadline_s)
        return math.inf

    def submit(self, q: PPRQuery) -> PPRResult | None:
        """Validate, admit and enqueue a query.

        Returns: the `PPRResult` immediately on a cache hit, else None
        (collect it from `tick()` / `run_until_drained()` by qid).

        Raises:
            ValueError: empty seeds, out-of-range seed, or top_k over the
                service bound.
            KeyError: unknown graph name.
            AdmissionRejected: the queue is at its admission bound.
        """
        if not q.seeds:
            raise ValueError("query needs at least one seed vertex")
        rg = self.registry.get(q.graph)
        if min(q.seeds) < 0 or max(q.seeds) >= rg.n:
            raise ValueError(f"seed out of range [0, {rg.n})")
        if q.top_k > self.max_top_k:
            raise ValueError(f"top_k {q.top_k} exceeds service max_top_k "
                             f"{self.max_top_k}")
        t0 = self._clock()
        hit = self.cache.lookup(q.key(rg.epoch))
        if hit is not None:
            self._counts["queries"] += 1
            self._counts["cache_hits"] += 1
            self._submitted += 1
            self.cache.count_hit()
            res = self._materialize(q, rg.epoch, *hit, cached=True)
            self._results[q.qid] = res
            return res
        spec = self._tenant_spec(q.tenant)
        entry = QueueEntry(q=q, t0=t0, tr=None,
                           deadline=t0 + self._deadline_budget(q, spec),
                           tenant=q.tenant, priority=spec.priority)
        try:
            self.scheduler.admit(entry, now=t0)
        except AdmissionRejected:
            self._counts["rejected_queries"] += 1
            raise
        self._counts["queries"] += 1
        self._submitted += 1
        return None

    def submit_many(self, queries) -> list[PPRResult]:
        """Submit a sequence of queries; returns the cache hits answered
        synchronously, in submission order."""
        return [r for r in (self.submit(q) for q in queries) if r is not None]

    # ---- not ported yet ---------------------------------------------------
    def update_graph(self, name: str, insert=(), delete=()) -> int:
        raise NotImplementedError(
            "edge updates are not ported to repro_torch yet (ROADMAP A6)")

    def refresh_tick(self, max_entries: int | None = None) -> int:
        raise NotImplementedError(
            "the background refresh tick is not ported to repro_torch yet "
            "(ROADMAP A2 power_refine + A6 updates)")

    # ---- the micro-batcher ------------------------------------------------
    def _bucket(self, b: int) -> int:
        """Smallest batch bucket holding `b` columns."""
        for cap in self._buckets:
            if b <= cap:
                return cap
        return self.max_batch

    def tick(self, now: float | None = None, force: bool = False
             ) -> list[PPRResult]:
        """Run one scheduling step: dispatch and harvest at most one
        micro-batch. Returns the results completed this call (twin cache
        hits resolved at batch formation plus the solved batch)."""
        now = self._clock() if now is None else now
        out: list[PPRResult] = []
        if self.scheduler.depth():
            group = self.scheduler.next_group(now, force=force)
            if group is None:
                self._counts["held_ticks"] += 1
            else:
                self._counts["ticks"] += 1
                hits, batch = self._form_and_dispatch(group)
                out.extend(hits)
                if batch is not None:
                    out.extend(self._harvest(batch))
        for r in out:
            self._results[r.qid] = r
        return out

    def _form_and_dispatch(self, group: list[QueueEntry]
                           ) -> tuple[list[PPRResult], _Batch | None]:
        """Batch formation + solve for one released group. Returns (twin
        cache-hit results, the solved batch — None when every query of the
        group was answered from cache)."""
        graph = group[0].q.graph
        rg = self.registry.get(graph)
        epoch = rg.epoch
        out: list[PPRResult] = []
        live: list[QueueEntry] = []
        for e in group:
            # a twin may have filled the cache since submission: that is
            # this query's disposition (a cache hit), counted here only
            hit = self.cache.lookup(e.q.key(epoch))
            if hit is not None:
                self.cache.count_hit()
                self._counts["cache_hits"] += 1
                out.append(self._materialize(e.q, epoch, *hit, cached=True))
            else:
                live.append(e)
        if not live:
            return out, None

        # identical queries share a column
        cols: dict[tuple, int] = {}
        col_of: list[int] = []
        reps: list[PPRQuery] = []
        for e in live:
            key = e.q.key(epoch)
            j = cols.get(key)
            if j is None:
                j = len(reps)
                cols[key] = j
                reps.append(e.q)
            col_of.append(j)

        sched, coeffs = self.registry.schedule(live[0].q.c, live[0].q.tol)
        n = rg.n
        dev = self.registry.device
        b_pad = self._bucket(len(reps))
        self._counts["padded_columns"] += b_pad - len(reps)
        # the personalization matrix is built on the device: only the seed
        # coordinates cross from the host
        rows = np.concatenate([np.asarray(q.seeds, np.int64) for q in reps])
        cidx = np.repeat(np.arange(len(reps), dtype=np.int64),
                         [len(q.seeds) for q in reps])
        p = torch.zeros((n, b_pad), dtype=self.registry.dtype, device=dev)
        p[torch.from_numpy(rows).to(dev), torch.from_numpy(cidx).to(dev)] = 1.0
        p[:, len(reps):] = 1.0  # pad columns: uniform mass, discarded

        k = min(self.max_top_k, n)
        if self.adaptive:
            plan = self.registry.adaptive_schedule(live[0].q.c, live[0].q.tol,
                                                   chunk=self.adaptive_chunk)
            idx, scores, used, _, _ = _solve_topk_adaptive(
                rg.engine, p, plan.c, plan.tol, max_rounds=plan.max_rounds,
                chunk=plan.chunk, k=k)
        else:
            idx, scores = _solve_topk(rg.engine, coeffs, p,
                                      rounds=sched.rounds, k=k)
            used = sched.rounds
        return out, _Batch(graph=graph, epoch=epoch, live=live, cols=cols,
                           col_of=col_of, n_reps=len(reps), b_pad=b_pad,
                           rounds_used=int(used), rounds_bound=sched.rounds,
                           idx=idx, scores=scores)

    def _harvest(self, b: _Batch) -> list[PPRResult]:
        """Copy one solved batch to the host (the tick's device fence),
        fill the cache and settle each rider's disposition."""
        self._counts["solves"] += 1
        self._counts["rounds_used"] += b.rounds_used
        self._counts["rounds_bound"] += b.rounds_bound
        idx = b.idx.cpu().numpy()
        scores = b.scores.cpu().numpy()
        for key, j in b.cols.items():
            self.cache.put(key, (idx[j], scores[j]))
        out: list[PPRResult] = []
        for i, e in enumerate(b.live):
            self.cache.count_miss()
            self._counts["solved_queries"] += 1
            j = b.col_of[i]
            out.append(self._materialize(e.q, b.epoch, idx[j], scores[j],
                                         cached=False,
                                         batch_size=b.n_reps))
            if self._clock() > e.deadline:
                self._counts["deadline_misses"] += 1
        return out

    def _materialize(self, q: PPRQuery, epoch: int, idx: np.ndarray,
                     scores: np.ndarray, cached: bool,
                     batch_size: int = 0) -> PPRResult:
        return PPRResult(qid=q.qid, graph=q.graph, epoch=epoch,
                         indices=idx[:q.top_k].copy(),
                         scores=scores[:q.top_k].copy(),
                         cached=cached, batch_size=batch_size)

    # ---- drain loop -------------------------------------------------------
    def pending(self) -> int:
        """Accepted queries not yet answered."""
        return self.scheduler.depth()

    def _drop_pending(self, max_ticks: int) -> None:
        """Overrun policy "drop": discard the undrained queue, counting and
        warning instead of raising."""
        n_drop = len(self.scheduler.drain())
        self._counts["dropped_queries"] += n_drop
        warnings.warn(
            f"PPR serve loop dropped {n_drop} undrained queries after "
            f"{max_ticks} ticks", RuntimeWarning, stacklevel=3)

    def run_until_drained(self, max_ticks: int = 10_000,
                          on_overrun: str = "raise") -> dict[int, PPRResult]:
        """Tick until the queue is empty; returns (and clears) the delivery
        buffer of results since the last drain, keyed by qid.

        Raises:
            ValueError: unknown `on_overrun` policy.
            RuntimeError: overrun with on_overrun="raise".
        """
        if on_overrun not in ("raise", "drop"):
            raise ValueError(f"on_overrun {on_overrun!r} not in "
                             "('raise', 'drop')")
        ticks = 0
        while self.scheduler.depth():
            if ticks >= max_ticks:
                if on_overrun == "raise":
                    raise RuntimeError(
                        f"PPR serve loop did not drain: {self.pending()} "
                        f"queries still queued after {max_ticks} ticks")
                self._drop_pending(max_ticks)
                break
            self.tick(force=True)
            ticks += 1
        out, self._results = self._results, {}
        return out

    def query(self, graph: str, seeds, c: float = 0.85, tol: float = 1e-4,
              top_k: int = 8, qid: int | None = None) -> PPRResult:
        """Submit one query and drain it."""
        qid = qid if qid is not None else -1 - self._submitted
        res = self.submit(PPRQuery(qid=qid, graph=graph,
                                   seeds=tuple(int(s) for s in seeds),
                                   c=c, tol=tol, top_k=top_k))
        if res is not None:
            self._results.pop(qid, None)  # delivered here, not via drain
            return res
        return self.run_until_drained()[qid]
