"""Online Personalized-PageRank query service with micro-batching (port of
`repro.serve.pagerank_service`).

  * queries (graph name, seed set, c, tol, top_k, plus a tenant class and
    an optional latency budget) pass admission control and queue in the
    service's scheduler (`serve/scheduler.py`): the FIFO policy, or
    per-tenant/per-graph EDF queues with deadline-aware batch closing
    (`scheduler="deadline"`);
  * every `tick()` packs one released compatible group — same graph and
    same (c, tol) — into an [n, B] personalization matrix built on the
    device and solves it in ONE call on the graph's cached engine (COO or
    hub/tail `index_add_`, or the block-ELL CUDA kernels, picked by the
    registry); identical queries in a group share one column;
  * with `adaptive=True` (the config default) the tick solves through the
    residual-controlled `cpaa_adaptive_fixed`: converged columns stop
    feeding the SpMM, and the tick ends when every live column reaches tol,
    never past the Formula 8 round bound;
  * with `async_dispatch=True` at most one batch is in flight: a tick
    enqueues its solve, the top-k and the copy of the answers into pinned
    host memory, records a CUDA event on the stream that ran them, and
    returns; the NEXT tick forms its batch on the host while the card
    finishes, and harvests the previous batch by synchronizing on that
    event. The adaptive solve reads any(active) back once per chunk, so
    there the overlap is only the solve's tail (top-k, copy);
  * batch widths are padded to power-of-two buckets (pad columns carry
    uniform mass and are discarded);
  * results come back as ranked top-k lists with ties broken lower index
    first, as `lax.top_k` breaks them in the reference;
  * an LRU cache keyed by (graph, epoch, seeds, c, tol) serves repeats; an
    effective edge-update batch bumps the epoch and invalidates, blanket
    or selectively (`invalidation_radius`): entries seeded within the hop
    radius of the delta are dropped, the rest re-stamped, and near-boundary
    survivors are refreshed by the background `refresh_tick` through a
    warm-started `power_refine`. The refresh tick yields (defers, counted)
    while foreground queries are queued or in flight.

`stats` holds the reference's counter keys as plain counters. The
observability layer (metrics, traces, convergence telemetry) comes with a
later slice.
"""
from __future__ import annotations

import math
import time
import warnings
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.pagerank import cpaa_adaptive_fixed, cpaa_fixed, \
    power_refine
from repro_torch.serve.graph_registry import GraphRegistry
from repro_torch.serve.result_cache import ResultCache
from repro_torch.serve.scheduler import (AdmissionRejected, DeadlineScheduler,
                                         FifoScheduler, QueueEntry,
                                         SolveTimeEstimator, TenantSpec)
from repro_torch.topk import topk_lower_index_first

__all__ = ["PPRQuery", "PPRResult", "PageRankService",
           "topk_lower_index_first", "STATS_KEYS"]

# Nominal round count that scales a tuner's per-round measurement into a
# whole-batch-solve seed for the deadline estimator (the reference's).
_SEED_ROUNDS = 12

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


def _solve_topk(engine, coeffs: torch.Tensor, p: torch.Tensor, rounds: int,
                k: int):
    """One micro-batch: [n, B] personalization -> ([B, k] ids, [B, k] mass).
    The engine owns any vertex reordering, so ids are original ids."""
    pi, _ = cpaa_fixed(engine, coeffs, p, rounds=rounds)
    return topk_lower_index_first(pi.T, k)


def _refine_topk(engine, x0: torch.Tensor, p: torch.Tensor, c, rounds: int,
                 k: int):
    """Warm-started single-column refresh: `rounds` of `power_refine` from a
    cached score vector, then the re-ranked top-k."""
    pi = power_refine(engine, x0, p, c, rounds)
    idx, scores = topk_lower_index_first(pi[None, :], k)
    return idx[0], scores[0]


def _solve_topk_adaptive(engine, p: torch.Tensor, c, tol, max_rounds: int,
                         chunk: int, k: int):
    """Adaptive micro-batch: like _solve_topk with residual-controlled round
    counts; also returns rounds run, per-column rounds and residuals."""
    pi, rounds_used, col_rounds, resid = cpaa_adaptive_fixed(
        engine, p, c, tol, max_rounds=max_rounds, chunk=chunk)
    idx, scores = topk_lower_index_first(pi.T, k)
    return idx, scores, rounds_used, col_rounds, resid


def _start_copy_to_host(t: torch.Tensor) -> torch.Tensor:
    """Enqueue t's copy to the host: into pinned memory without waiting on
    CUDA (the harvest's event fence covers it), as-is on the CPU."""
    if t.device.type != "cuda":
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return host.copy_(t, non_blocking=True)


def _to_device_async(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Small host index array -> `dev` without a stream sync on CUDA (a
    pageable copy would wait for the batch still solving there)."""
    t = torch.from_numpy(arr)
    if dev.type != "cuda":
        return t
    return t.pin_memory().to(dev, non_blocking=True)


@dataclass
class _InFlight:
    """One dispatched batch solve, harvested later.

    On CUDA the solve, its top-k and the copy of the answers into pinned
    host memory may still be running; `event` was recorded after them on
    the stream that ran them, and `_harvest` synchronizes on it. The rest
    is the host context that materializes the results: which queries ride
    which column, the epoch the solve is valid at, and the dispatch
    timestamp the solve-time EWMA feeds on.
    """

    graph: str
    epoch: int
    rg: object
    live: list                  # [QueueEntry] riding this solve
    cols: dict                  # cache key -> column index
    col_of: list                # per live entry: its column index
    n_reps: int                 # distinct columns (pre-padding)
    b_pad: int
    rounds_used: int
    rounds_bound: int
    idx: torch.Tensor           # [B, k] on the host (pinned on CUDA)
    scores: torch.Tensor        # [B, k] on the host (pinned on CUDA)
    event: object = None        # torch.cuda.Event, None on the CPU
    t_dispatch0: float = 0.0    # when the host started dispatching


class PageRankService:
    """Admission control + scheduler + micro-batcher + result cache over a
    `GraphRegistry`.

    Args mirror the reference: max_batch, cache_capacity, max_top_k,
    adaptive, adaptive_chunk, invalidation_radius (None = blanket flush on
    an update; an int drops only entries seeded within that many hops of
    the delta and re-stamps the rest), refresh_batch (> 0 arms the
    background refresh of retained entries within `refresh_margin` hops
    outside the drop radius, up to this many per `refresh_tick`),
    refresh_rounds (the floor on power_refine rounds per refresh),
    refresh_margin, scheduler ("fifo", "deadline" or a scheduler
    instance), tenants, default_deadline_s, admission_depth,
    slack_margin_s (a deadline batch releases once its slack falls to
    this), async_dispatch (depth-1 pipelining, see the module note) and
    clock (injectable for tests).

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
                 scheduler: str | object = "fifo",
                 tenants=None,
                 default_deadline_s: float | None = None,
                 admission_depth: int | None = None,
                 slack_margin_s: float = 0.0,
                 async_dispatch: bool = False,
                 clock=None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.registry = registry
        self.max_batch = max_batch
        self.max_top_k = max_top_k
        self.adaptive = adaptive
        self.adaptive_chunk = adaptive_chunk
        self.invalidation_radius = invalidation_radius
        self.refresh_batch = refresh_batch
        self.refresh_rounds = refresh_rounds
        self.refresh_margin = refresh_margin
        # bounded: an update-only stream must not grow the queue without
        # limit; when full, the OLDEST keys drop first
        self._refresh: deque[tuple] = deque(maxlen=4096)
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
        self.async_dispatch = async_dispatch
        self._inflight: deque[_InFlight] = deque()
        if tenants is None:
            tenants = {}
        elif not isinstance(tenants, dict):
            tenants = {t.name: t for t in tenants}
        self.tenants: dict[str, TenantSpec] = dict(tenants)
        self._default_spec = TenantSpec(
            deadline_s=math.inf if default_deadline_s is None
            else float(default_deadline_s),
            max_depth=admission_depth)
        self.estimator = SolveTimeEstimator()
        if isinstance(scheduler, str):
            if scheduler == "fifo":
                self.scheduler = FifoScheduler(max_batch,
                                               max_depth=admission_depth)
            elif scheduler == "deadline":
                self.scheduler = DeadlineScheduler(
                    max_batch, self.estimator, tenants=self.tenants,
                    default_spec=self._default_spec,
                    max_depth=admission_depth,
                    slack_margin_s=slack_margin_s, bucket=self._bucket)
            else:
                raise ValueError(f"scheduler {scheduler!r} not in "
                                 "('fifo', 'deadline')")
        else:
            self.scheduler = scheduler
        self.policy = getattr(self.scheduler, "name",
                              type(self.scheduler).__name__)
        self._counts = dict.fromkeys(STATS_KEYS, 0)
        for gname in registry.names():
            self._seed_estimator(gname)
        self._submitted = 0     # total accepted queries (qid autogeneration)

    def _seed_estimator(self, name: str) -> None:
        """Prime the solve-time estimator from a tuner's per-round time.
        No registry of the port records one until the autotuner is ported
        (ROADMAP A7), so this is a no-op today."""
        us = getattr(self.registry.get(name), "tune_us_per_iter", None)
        if us is not None:
            self.estimator.seed(name, us * 1e-6 * _SEED_ROUNDS)

    @property
    def stats(self) -> dict:
        """Counter dict with the reference's keys."""
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
            AdmissionRejected: the tenant's queue is at its admission bound
                (counted in `rejected_queries`, never accepted).
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

    # ---- graph updates ----------------------------------------------------
    def update_graph(self, name: str, insert=(), delete=()) -> int:
        """Apply an edge-update batch; returns the graph epoch after it.

        A batch whose effective delta is empty is a no-op: no epoch bump,
        every cached entry survives (still counted in `updates`).
        Otherwise the epoch bumps and the cache is invalidated — every
        entry of the graph when `invalidation_radius` is None, else only
        entries seeded within the radius of the delta's touched vertices,
        the rest re-stamped under the new epoch and (with `refresh_batch`
        > 0) those in the near-boundary ring queued for a refresh.

        Raises:
            KeyError: unknown graph.
            ValueError: an endpoint out of range or a self loop.

        Invariant: any in-flight batch is harvested FIRST, so every result
        is materialized under the epoch it was solved at.
        """
        self._flush_inflight()
        prev_engine = type(self.registry.get(name).engine)
        rg = self.registry.apply_updates(name, insert=insert, delete=delete)
        if type(rg.engine) is not prev_engine:
            # a rebuild picked another engine: the old EWMAs time a layout
            # that no longer runs
            self.estimator.reset(graph=name)
            self._seed_estimator(name)
        self._counts["updates"] += 1
        delta = rg.last_delta
        if delta.is_noop:
            self._counts["noop_updates"] += 1
            return rg.epoch
        if rg.last_update_incremental:
            self._counts["incremental_updates"] += 1
        if self.invalidation_radius is None:
            self._counts["cache_dropped"] += self.cache.invalidate_graph(name)
        elif self.cache.count_for(name) > 0:
            # one BFS yields both rings: the drop mask and (with the refresh
            # tick armed) the ring refresh_margin hops further out
            extra = self.refresh_margin if self.refresh_batch > 0 else 0
            masks = self.registry.hop_neighborhood(
                name, delta.touched, self.invalidation_radius, extra=extra)
            near, ring = masks if extra else (masks, None)

            def drop(key):
                return any(near[s] for s in key[2])

            dropped, retained_keys = self.cache.invalidate_selective(
                name, rg.epoch, drop)
            self._counts["cache_dropped"] += dropped
            self._counts["cache_retained"] += len(retained_keys)
            if ring is not None:
                for key in retained_keys:
                    if any(ring[s] for s in key[2]):
                        self._refresh.append(key)
        return rg.epoch

    # ---- the background refresh tick --------------------------------------
    def _refresh_round_count(self, coverage_gap: float, c: float,
                             tol: float) -> int:
        """Rounds so the refreshed entry is within tol of the new graph's
        PPR. The cache holds only the top-k scores, so the warm start
        carries a truncation error of `coverage_gap` (the mass outside the
        top k); the power recurrence contracts L1 error by c per round, so
        c^rounds * coverage_gap <= tol picks the count. refresh_rounds is
        the floor; the count is rounded up to a power of two, as in the
        reference."""
        rounds = self.refresh_rounds
        if coverage_gap > tol:
            rounds = max(rounds, int(np.ceil(np.log(tol / coverage_gap)
                                             / np.log(c))))
        return 1 << max(rounds - 1, 0).bit_length()

    def refresh_tick(self, max_entries: int | None = None) -> int:
        """Refresh queued near-boundary cache entries — BACKGROUND work.

        Warm-starts up to `max_entries` (default `refresh_batch`) entries
        from their cached scores through `power_refine` on the current
        engine, re-ranks and re-caches them in place. Entries whose epoch
        was superseded by a later update, or that were evicted, are
        skipped. Returns the number refreshed.

        Invariant (foreground yield): while any foreground query is queued
        or in flight the tick returns 0 at once, counted in
        `refresh_deferred`, and the queued keys stay for the next idle tick.
        """
        if self.scheduler.depth() or self._inflight:
            if self._refresh:
                self._counts["refresh_deferred"] += 1
            return 0      # yield: foreground queries own the device
        budget = self.refresh_batch if max_entries is None else max_entries
        done = 0
        dev = self.registry.device
        while self._refresh and done < budget:
            key = self._refresh.popleft()
            graph, epoch, seeds, c, tol = key
            rg = self.registry.get(graph)
            if epoch != rg.epoch:
                continue      # a later update superseded this refresh
            hit = self.cache.lookup(key)
            if hit is None:
                continue      # evicted before we got to it
            idx, scores = hit
            n = rg.n
            k = min(self.max_top_k, n)
            # warm start: cached top-k mass in place, the unseen remainder
            # spread uniformly (power_refine normalizes)
            gap = max(0.0, 1.0 - float(scores.sum()))
            x0 = np.full(n, gap / n, np.float32)
            x0[idx] += scores
            p = np.zeros(n, np.float32)
            p[list(seeds)] = 1.0
            new_idx, new_scores = _refine_topk(
                rg.engine, torch.from_numpy(x0).to(dev),
                torch.from_numpy(p).to(dev), c,
                rounds=self._refresh_round_count(gap, c, tol), k=k)
            self.cache.put(key, (new_idx.cpu().numpy(),
                                 new_scores.cpu().numpy()))
            self._counts["refreshes"] += 1
            done += 1
        return done

    # ---- the micro-batcher ------------------------------------------------
    def _bucket(self, b: int) -> int:
        """Smallest batch bucket holding `b` columns."""
        for cap in self._buckets:
            if b <= cap:
                return cap
        return self.max_batch

    def tick(self, now: float | None = None, force: bool = False
             ) -> list[PPRResult]:
        """Run one scheduling step: possibly dispatch one micro-batch,
        possibly harvest a previously dispatched one.

        Args:
            now: scheduler time (default: the service clock).
            force: release the most urgent group even if the deadline
                scheduler would hold it for more arrivals (drain mode).

        Returns: the results completed THIS call — twin cache hits resolved
        at batch formation, plus every query of the batch harvested this
        tick (sync: the batch just dispatched; async: the PREVIOUS one).

        Invariant: with `async_dispatch` at most one batch is in flight; a
        tick that dispatches batch k+1 harvests batch k before returning.
        """
        now = self._clock() if now is None else now
        out: list[PPRResult] = []
        rec = None
        if self.scheduler.depth():
            group = self.scheduler.next_group(now, force=force)
            if group is None:
                self._counts["held_ticks"] += 1
            else:
                self._counts["ticks"] += 1
                hits, rec = self._form_and_dispatch(group)
                out.extend(hits)
        if rec is not None:
            if self.async_dispatch:
                self._inflight.append(rec)
                if len(self._inflight) > 1:
                    out.extend(self._harvest(self._inflight.popleft()))
            else:
                out.extend(self._harvest(rec))
        elif self._inflight:
            # nothing dispatched this tick: harvest the in-flight batch so
            # drains make progress
            out.extend(self._harvest(self._inflight.popleft()))
        for r in out:
            self._results[r.qid] = r
        return out

    def _form_and_dispatch(self, group: list[QueueEntry]
                           ) -> tuple[list[PPRResult], _InFlight | None]:
        """Batch formation + dispatch for one released group. Returns (twin
        cache-hit results, the dispatched batch — None when every query of
        the group was answered from cache). On CUDA the returned batch may
        still be running; `_harvest` fences it."""
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
        p[_to_device_async(rows, dev), _to_device_async(cidx, dev)] = 1.0
        p[:, len(reps):] = 1.0  # pad columns: uniform mass, discarded

        k = min(self.max_top_k, n)
        t_dispatch0 = self._clock()
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
        idx, scores = _start_copy_to_host(idx), _start_copy_to_host(scores)
        event = None
        if dev.type == "cuda":
            event = torch.cuda.Event()
            event.record()      # on the current stream, which ran the solve
        return out, _InFlight(graph=graph, epoch=epoch, rg=rg, live=live,
                              cols=cols, col_of=col_of, n_reps=len(reps),
                              b_pad=b_pad, rounds_used=int(used),
                              rounds_bound=sched.rounds, idx=idx,
                              scores=scores, event=event,
                              t_dispatch0=t_dispatch0)

    def _harvest(self, rec: _InFlight) -> list[PPRResult]:
        """Fence one dispatched batch and materialize its results: wait on
        its CUDA event (the only fence of the tick), feed the measured
        dispatch-to-ready time into the solve-time EWMA, fill the cache and
        settle each rider's disposition and deadline."""
        if rec.event is not None:
            rec.event.synchronize()
        t_ready = self._clock()
        self.estimator.observe(rec.graph, rec.b_pad,
                               t_ready - rec.t_dispatch0)
        self._counts["solves"] += 1
        self._counts["rounds_used"] += rec.rounds_used
        self._counts["rounds_bound"] += rec.rounds_bound
        idx = rec.idx.numpy()
        scores = rec.scores.numpy()
        for key, j in rec.cols.items():
            self.cache.put(key, (idx[j], scores[j]))
        out: list[PPRResult] = []
        for i, e in enumerate(rec.live):
            self.cache.count_miss()
            self._counts["solved_queries"] += 1
            j = rec.col_of[i]
            out.append(self._materialize(e.q, rec.epoch, idx[j], scores[j],
                                         cached=False,
                                         batch_size=rec.n_reps))
            if self._clock() > e.deadline:
                self._counts["deadline_misses"] += 1
        return out

    def _flush_inflight(self) -> None:
        """Harvest every in-flight batch into the delivery buffer. Called
        before graph updates, so no result is materialized under a bumped
        epoch, and by overrun drains, so solved work is delivered."""
        while self._inflight:
            for r in self._harvest(self._inflight.popleft()):
                self._results[r.qid] = r

    def _materialize(self, q: PPRQuery, epoch: int, idx: np.ndarray,
                     scores: np.ndarray, cached: bool,
                     batch_size: int = 0) -> PPRResult:
        return PPRResult(qid=q.qid, graph=q.graph, epoch=epoch,
                         indices=idx[:q.top_k].copy(),
                         scores=scores[:q.top_k].copy(),
                         cached=cached, batch_size=batch_size)

    # ---- drain loop -------------------------------------------------------
    def pending(self) -> int:
        """Accepted queries not yet answered: queued plus in flight."""
        return self.scheduler.depth() + sum(len(rec.live)
                                            for rec in self._inflight)

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
        """Tick until the queue AND the in-flight batch are empty; returns
        (and clears) the delivery buffer of results since the last drain,
        keyed by qid. Drain ticks run with `force=True`. With
        `refresh_batch > 0` one background `refresh_tick` runs after the
        drain (the service is idle then).

        Raises:
            ValueError: unknown `on_overrun` policy.
            RuntimeError: overrun with on_overrun="raise".
        """
        if on_overrun not in ("raise", "drop"):
            raise ValueError(f"on_overrun {on_overrun!r} not in "
                             "('raise', 'drop')")
        ticks = 0
        while self.scheduler.depth() or self._inflight:
            if ticks >= max_ticks:
                if on_overrun == "raise":
                    raise RuntimeError(
                        f"PPR serve loop did not drain: {self.pending()} "
                        f"queries still in flight after {max_ticks} ticks")
                self._flush_inflight()   # solved work is never dropped
                self._drop_pending(max_ticks)
                break
            self.tick(force=True)
            ticks += 1
        if self.refresh_batch > 0:
            self.refresh_tick()   # idle work: near-boundary cache refreshes
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
