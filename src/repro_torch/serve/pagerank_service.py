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
    residual-controlled `cpaa_adaptive_loop`: converged columns stop
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
    first, as `lax.top_k` breaks them in the reference; every ranking (the
    adaptive and the fixed-round tick, the refresh) is one `topk_columns`
    call, the adaptive tick's over the loop's snapshot in the engine's own
    layout;
  * an LRU cache keyed by (graph, epoch, seeds, c, tol) serves repeats; an
    effective edge-update batch bumps the epoch and invalidates, blanket
    or selectively (`invalidation_radius`): entries seeded within the hop
    radius of the delta are dropped, the rest re-stamped, and near-boundary
    survivors are refreshed by the background `refresh_tick` through a
    warm-started `power_refine`. The refresh tick yields (defers, counted)
    while foreground queries are queued or in flight.

Observability (`repro_torch.obs`, as in the reference): every counter is
a labeled metric in a `ServeMetrics` bundle, and `stats` renders the
reference's flat dict from the metric totals. Each query is counted at
DISPOSITION time, exactly once, as one of cache_hit | solved | dropped;
rejected queries are refused before acceptance and counted under
`serve_admission_total`. With `ServeMetrics(detail=True)` (the default)
the service also records latency and stage histograms, per-query
lifecycle traces (submit -> queue -> batch_form -> solve_dispatch ->
solve_device -> materialize) and per-tick convergence telemetry (rounds
used against the Formula 8 bound, residual at exit, converged column
fraction). `detail=False` keeps only the counters.

One fence per tick: on CUDA the tick's only wait on the card is the CUDA
event `_harvest` synchronizes on. The adaptive solve's per-column
residuals ride the same pinned copy as the answers, and the
`solve_device` span (kind "device") is the elapsed time between two CUDA
events recorded around the solve on its stream, read after that fence.
On the CPU, where the solve ran at dispatch, the span is the host clock
around the fence point, as in the reference.

Lockstep at world size > 1 (the sharded engines, one process per rank):
rank 0 owns the service — admission, the scheduler (FIFO or deadline,
sync or async), the cache and every decision. Before each collective step
it broadcasts that step's small plan: a solve's graph, epoch, c, tol,
bucket and the columns' seeds; a refresh's cached entry; an update batch.
The plans ride the host-only channel (`core.distributed.host_group`), so
on cuda sending one never waits on the batch in flight and async dispatch
keeps its overlap. Every other rank runs `follow()`, which rebuilds the
same personalization from the plan and runs the same solve (or refresh,
or update), so every rank reaches every collective in the same order; it
returns when rank 0 calls `close()`. At world size 1 nothing is
broadcast.
"""
from __future__ import annotations

import math
import time
import warnings
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.distributed import broadcast_object, rank, world_size
from repro_torch.core.pagerank import cpaa_adaptive_loop, cpaa_fixed, \
    power_refine
from repro_torch.kernels.topk import topk_columns
from repro_torch.obs import export as obs_export
from repro_torch.obs.convergence import (ConvergenceLog, TickTelemetry,
                                         UpdateTelemetry)
from repro_torch.obs.metrics import NULL_REGISTRY, MetricsRegistry
from repro_torch.obs.trace import Tracer
from repro_torch.serve.graph_registry import GraphRegistry
from repro_torch.serve.result_cache import ResultCache
from repro_torch.serve.scheduler import (AdmissionRejected, DeadlineScheduler,
                                         FifoScheduler, QueueEntry,
                                         SolveTimeEstimator, TenantSpec)
from repro_torch.topk import topk_lower_index_first

__all__ = ["PPRQuery", "PPRResult", "PageRankService", "ServeMetrics",
           "topk_lower_index_first"]

# Nominal round count that scales a tuner's per-round measurement into a
# whole-batch-solve seed for the deadline estimator (the reference's).
_SEED_ROUNDS = 12


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


class ServeMetrics:
    """The service's observability bundle: metric families + tracer +
    convergence log, all hanging off one `MetricsRegistry`.

    Args:
        registry: `MetricsRegistry` to register families on (None = new).
        detail: True (default) arms the full layer — latency/stage
            histograms, per-query traces, convergence series. False keeps
            only the counters (the histograms come from a disabled registry
            and the tracer hands out null traces): the metrics-off operating
            point the detail layer's overhead is measured against.
        trace_keep: bounded ring size of retained query traces.
        history: bounded length of the convergence time series.

    Invariant: the counter layer is always live — disposition accounting
    (`queries == cache_hits + solved + dropped`) holds at either detail
    level.
    """

    def __init__(self, registry: MetricsRegistry | None = None,
                 detail: bool = True, trace_keep: int = 256,
                 history: int = 1024):
        self.registry = MetricsRegistry() if registry is None else registry
        self.detail = detail
        self.tracer = Tracer(enabled=detail, keep=trace_keep)
        self.convergence = ConvergenceLog(keep=history)
        r = self.registry
        hr = r if detail else NULL_REGISTRY   # detail gates the histograms
        self.queries = r.counter(
            "serve_queries_total", "queries accepted by submit()", ("graph",))
        self.served = r.counter(
            "serve_served_total",
            "queries answered, by disposition (cache_hit | solved | dropped)",
            ("graph", "disposition"))
        self.admission = r.counter(
            "serve_admission_total",
            "admission decisions (accept | reject) with machine-readable "
            "reason", ("graph", "tenant", "decision", "reason"))
        self.solves = r.counter(
            "serve_solves_total", "batched device solves",
            ("graph", "engine", "bucket", "mode"))
        self.ticks = r.counter("serve_ticks_total", "micro-batch ticks")
        self.held = r.counter(
            "serve_hold_total",
            "ticks the deadline scheduler held batch formation, betting on "
            "more arrivals")
        self.overlap = r.counter(
            "serve_overlap_dispatch_total",
            "async-dispatch ticks whose host batch formation overlapped an "
            "in-flight device solve")
        self.deadline_miss = r.counter(
            "serve_deadline_miss_total",
            "queries answered after their latency budget expired",
            ("graph", "tenant"))
        self.padded = r.counter(
            "serve_padded_columns_total",
            "pad columns solved (bucket width minus live columns)")
        self.updates = r.counter(
            "serve_updates_total", "edge-update batches by effective path",
            ("graph", "kind"))
        self.refreshes = r.counter(
            "serve_refreshes_total", "background warm-start cache refreshes",
            ("graph",))
        self.engine_swaps = r.counter(
            "serve_engine_swaps_total",
            "graph rebuilds that changed the engine class (each resets the "
            "solve-time estimator for the graph)", ("graph",))
        self.refresh_deferred = r.counter(
            "serve_refresh_deferred_total",
            "refresh_tick calls that yielded to pending foreground queries")
        self.cache_dropped = r.counter(
            "serve_cache_dropped_total",
            "cache entries invalidated by graph updates", ("graph",))
        self.cache_retained = r.counter(
            "serve_cache_retained_total",
            "cache entries re-stamped across graph updates", ("graph",))
        self.rounds_used = r.counter(
            "serve_rounds_used_total", "solver rounds actually run",
            ("graph", "mode"))
        self.rounds_bound = r.counter(
            "serve_rounds_bound_total",
            "Formula 8 a-priori round bound accumulated over ticks",
            ("graph", "mode"))
        self.queue_depth = r.gauge(
            "serve_queue_depth", "queries waiting for a tick")
        self.tenant_depth = r.gauge(
            "serve_tenant_depth", "queries queued per tenant class",
            ("tenant",))
        self.solve_ewma = r.gauge(
            "serve_solve_ewma_seconds",
            "EWMA expected batch solve time per (graph, bucket) — the "
            "deadline math's solve-estimate term", ("graph", "bucket"))
        self.latency = hr.histogram(
            "serve_query_latency_seconds", "submit-to-answer e2e latency",
            ("graph", "disposition"))
        self.stage = hr.histogram(
            "serve_stage_seconds",
            "per-tick stage durations (queue is per-query)", ("stage",))
        self.slack = hr.histogram(
            "serve_slack_seconds",
            "dispatch-time slack: latency budget minus expected solve time "
            "(<= 0 lands in the zero bucket)", ("graph",))
        self.solve_seconds = hr.histogram(
            "serve_solve_seconds",
            "dispatch-to-ready batch solve duration (feeds the EWMA "
            "estimator)", ("graph", "bucket"))
        self.refresh_seconds = hr.histogram(
            "serve_refresh_seconds", "per-entry background refresh duration",
            ("graph",))

    def _label_total(self, fam, pos: int, value: str) -> float:
        return sum(inst.value for values, inst in fam.children()
                   if values[pos] == value)

    def disposition_total(self, disposition: str) -> float:
        """Total queries answered under one disposition label."""
        return self._label_total(self.served, 1, disposition)

    def update_kind_total(self, kind: str) -> float:
        """Total edge-update batches of one effective kind."""
        return self._label_total(self.updates, 1, kind)

    def admission_total(self, decision: str) -> float:
        """Total admission decisions of one kind (accept | reject)."""
        return self._label_total(self.admission, 2, decision)

    def snapshot(self, meta: dict | None = None) -> dict:
        """JSON-ready snapshot of metrics + convergence + recent traces."""
        return obs_export.snapshot(self.registry,
                                   convergence=self.convergence,
                                   tracer=self.tracer, meta=meta)


def _solve_topk(engine, coeffs: torch.Tensor, p: torch.Tensor, rounds: int,
                k: int):
    """One micro-batch: [n, B] personalization -> ([B, k] ids, [B, k] mass).
    The engine owns any vertex reordering, so ids are original ids; pi is
    contiguous [n, B] in vertex order and is ranked down its columns."""
    pi, _ = cpaa_fixed(engine, coeffs, p, rounds=rounds)
    return topk_columns(pi, k)


def _refine_topk(engine, x0: torch.Tensor, p: torch.Tensor, c, rounds: int,
                 k: int):
    """Warm-started single-column refresh: `rounds` of `power_refine` from a
    cached score vector, then the re-ranked top-k."""
    pi = power_refine(engine, x0, p, c, rounds)
    idx, scores = topk_columns(pi[:, None], k)
    return idx[0], scores[0]


def _solve_topk_adaptive(engine, p: torch.Tensor, c, tol, max_rounds: int,
                         chunk: int, k: int):
    """Adaptive micro-batch: like _solve_topk with residual-controlled round
    counts; also returns rounds run, per-column rounds and residuals.

    The loop's last snapshot is already the column-normalized accumulator
    (`cpaa_adaptive_loop`), in the engine's internal layout: it is ranked
    there, through the engine's row map (`ranking_layout`), so pi is never
    built in vertex order."""
    snap, rounds_used, col_rounds, resid = cpaa_adaptive_loop(
        engine, p, c, tol, max_rounds=max_rounds, chunk=chunk)[1:]
    rows, n_valid, ids = engine.ranking_layout(snap)
    idx, scores = topk_columns(rows, k, n_valid=n_valid, ids=ids)
    return idx, scores, rounds_used, col_rounds, resid


def _refresh_inputs(n: int, idx: np.ndarray, scores: np.ndarray, seeds,
                    dev: torch.device):
    """Warm start and personalization of one cache refresh: the cached
    top-k mass in place, the unseen remainder spread uniformly
    (power_refine normalizes); unit mass on each seed."""
    gap = max(0.0, 1.0 - float(scores.sum()))
    x0 = np.full(n, gap / n, np.float32)
    x0[idx] += scores
    p = np.zeros(n, np.float32)
    p[list(seeds)] = 1.0
    return torch.from_numpy(x0).to(dev), torch.from_numpy(p).to(dev), gap


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

    On CUDA the solve, its top-k and the copies of the answers (and of the
    adaptive residuals) into pinned host memory may still be running;
    `event` was recorded after them on the stream that ran them, and
    `_harvest` synchronizes on it. `solve_events` (detail metrics on CUDA
    only) bracket the solve on the same stream for the device span. The
    rest is the host context that materializes the results: which queries
    ride which column, the epoch the solve is valid at, and the dispatch
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
    mode: str                   # "adaptive" | "fixed"
    rounds_used: int
    rounds_bound: int
    tol: float
    c: float
    idx: torch.Tensor           # [B, k] on the host (pinned on CUDA)
    scores: torch.Tensor        # [B, k] on the host (pinned on CUDA)
    resid: torch.Tensor | None = None   # adaptive: [B] residuals, host
    event: object = None        # torch.cuda.Event, None on the CPU
    solve_events: tuple | None = None   # (start, stop) timing events
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
    refresh_margin, metrics (a `ServeMetrics` bundle; None = a fresh
    detailed one), scheduler ("fifo", "deadline" or a scheduler instance),
    tenants, default_deadline_s, admission_depth, slack_margin_s (a
    deadline batch releases once its slack falls to this), async_dispatch
    (depth-1 pipelining, see the module note) and clock (injectable for
    tests).

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
                 metrics: ServeMetrics | None = None,
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
        self.metrics = ServeMetrics() if metrics is None else metrics
        # the registry shares the service's metric registry (build/update/
        # BFS timings and per-graph gauges land next to the serve metrics)
        registry.bind_metrics(self.metrics.registry)
        for gname in registry.names():
            self._seed_estimator(gname)
        self._submitted = 0     # total accepted queries (qid autogeneration)
        self._tick_no = 0
        # lockstep (module note): rank 0 leads, the other ranks follow()
        self._world = world_size()
        self._closed = False

    def _seed_estimator(self, name: str) -> None:
        """Prime the solve-time estimator from the tuner's per-round time
        (a tuned registry records one per graph), scaled by a nominal round
        count. No-op when untuned."""
        us = getattr(self.registry.get(name), "tune_us_per_iter", None)
        if us is not None:
            self.estimator.seed(name, us * 1e-6 * _SEED_ROUNDS)

    @property
    def stats(self) -> dict:
        """The reference's counter dict, rendered from the metric families'
        totals."""
        m = self.metrics
        return {
            "queries": int(m.queries.total()),
            "cache_hits": int(m.disposition_total("cache_hit")),
            "solves": int(m.solves.total()),
            "solved_queries": int(m.disposition_total("solved")),
            "dropped_queries": int(m.disposition_total("dropped")),
            "rejected_queries": int(m.admission_total("reject")),
            "deadline_misses": int(m.deadline_miss.total()),
            "ticks": int(m.ticks.total()),
            "held_ticks": int(m.held.total()),
            "padded_columns": int(m.padded.total()),
            "updates": int(m.updates.total()),
            "rounds_used": int(m.rounds_used.total()),
            "rounds_bound": int(m.rounds_bound.total()),
            "noop_updates": int(m.update_kind_total("noop")),
            "incremental_updates": int(m.update_kind_total("incremental")),
            "cache_dropped": int(m.cache_dropped.total()),
            "cache_retained": int(m.cache_retained.total()),
            "refreshes": int(m.refreshes.total()),
            "refresh_deferred": int(m.refresh_deferred.total()),
        }

    def snapshot(self, meta: dict | None = None) -> dict:
        """JSON-ready snapshot of metrics + convergence + recent traces."""
        return self.metrics.snapshot(meta)

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
                (counted under `serve_admission_total{decision="reject"}`,
                never accepted).
        """
        if not q.seeds:
            raise ValueError("query needs at least one seed vertex")
        rg = self.registry.get(q.graph)
        if min(q.seeds) < 0 or max(q.seeds) >= rg.n:
            raise ValueError(f"seed out of range [0, {rg.n})")
        if q.top_k > self.max_top_k:
            raise ValueError(f"top_k {q.top_k} exceeds service max_top_k "
                             f"{self.max_top_k}")
        m = self.metrics
        t0 = self._clock()
        hit = self.cache.lookup(q.key(rg.epoch))
        if hit is not None:
            # disposition decided here: served from cache, counted once
            m.queries.labels(graph=q.graph).inc()
            self._submitted += 1
            self.cache.count_hit()
            res = self._materialize(q, rg.epoch, *hit, cached=True)
            self._results[q.qid] = res
            m.served.labels(graph=q.graph, disposition="cache_hit").inc()
            m.latency.labels(graph=q.graph, disposition="cache_hit").observe(
                self._clock() - t0)
            tr = m.tracer.start("query", qid=q.qid, graph=q.graph)
            tr.mark("submit")
            tr.begin("cache_hit")
            tr.end("cache_hit")
            m.tracer.finish(tr)
            return res
        # the miss is not counted yet: this query's disposition (solved at
        # a later tick, twin-filled cache hit, or dropped) is still open
        spec = self._tenant_spec(q.tenant)
        entry = QueueEntry(q=q, t0=t0, tr=None,
                           deadline=t0 + self._deadline_budget(q, spec),
                           tenant=q.tenant, priority=spec.priority)
        try:
            self.scheduler.admit(entry, now=t0)
        except AdmissionRejected as e:
            m.admission.labels(graph=q.graph, tenant=q.tenant,
                               decision="reject", reason=e.reason).inc()
            raise
        m.queries.labels(graph=q.graph).inc()
        m.admission.labels(graph=q.graph, tenant=q.tenant,
                           decision="accept", reason="ok").inc()
        self._submitted += 1
        tr = m.tracer.start("query", qid=q.qid, graph=q.graph)
        tr.mark("submit")
        tr.begin("queue")
        entry.tr = tr
        m.queue_depth.set(self.scheduler.depth())
        m.tenant_depth.labels(tenant=q.tenant).set(
            self.scheduler.depth_for(q.tenant))
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
        m = self.metrics
        t0 = self._clock()
        prev_engine = type(self.registry.get(name).engine)
        insert, delete = list(insert), list(delete)
        self._lead("update", name, insert, delete)
        rg = self.registry.apply_updates(name, insert=insert, delete=delete)
        if type(rg.engine) is not prev_engine:
            # a rebuild picked another engine: the old EWMAs time a layout
            # that no longer runs, so the deadline math restarts from the
            # tuner's seed (or cold)
            self.estimator.reset(graph=name)
            self._seed_estimator(name)
            m.engine_swaps.labels(graph=name).inc()
        delta = rg.last_delta
        edges_changed = (len(delta.inserted) + len(delta.deleted)
                         if delta is not None else 0)
        if delta is not None and delta.is_noop:
            m.updates.labels(graph=name, kind="noop").inc()
            m.convergence.record_update(UpdateTelemetry(
                graph=name, kind="noop", edges_changed=0, cache_dropped=0,
                cache_retained=self.cache.count_for(name),
                duration_s=self._clock() - t0))
            return rg.epoch
        kind = "incremental" if rg.last_update_incremental else "rebuild"
        m.updates.labels(graph=name, kind=kind).inc()
        dropped = retained = 0
        if self.invalidation_radius is None or delta is None:
            dropped = self.cache.invalidate_graph(name)
            m.cache_dropped.labels(graph=name).inc(dropped)
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
            retained = len(retained_keys)
            m.cache_dropped.labels(graph=name).inc(dropped)
            m.cache_retained.labels(graph=name).inc(retained)
            if ring is not None:
                for key in retained_keys:
                    if any(ring[s] for s in key[2]):
                        self._refresh.append(key)
        m.convergence.record_update(UpdateTelemetry(
            graph=name, kind=kind, edges_changed=edges_changed,
            cache_dropped=dropped, cache_retained=retained,
            duration_s=self._clock() - t0))
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
        or in flight the tick returns 0 at once, counted under
        `serve_refresh_deferred_total`, and the queued keys stay for the
        next idle tick.
        """
        m = self.metrics
        if self.scheduler.depth() or self._inflight:
            if self._refresh:
                m.refresh_deferred.inc()
            return 0      # yield: foreground queries own the device
        budget = self.refresh_batch if max_entries is None else max_entries
        done = 0
        dev = self.registry.device
        t_all = self._clock()
        while self._refresh and done < budget:
            key = self._refresh.popleft()
            graph, epoch, seeds, c, tol = key
            rg = self.registry.get(graph)
            if epoch != rg.epoch:
                continue      # a later update superseded this refresh
            hit = self.cache.lookup(key)
            if hit is None:
                continue      # evicted before we got to it
            t0 = self._clock()
            idx, scores = hit
            k = min(self.max_top_k, rg.n)
            self._lead("refresh", graph, epoch, idx, scores, seeds, c, tol)
            x0, p, gap = _refresh_inputs(rg.n, idx, scores, seeds, dev)
            new_idx, new_scores = _refine_topk(
                rg.engine, x0, p, c,
                rounds=self._refresh_round_count(gap, c, tol), k=k)
            self.cache.put(key, (new_idx.cpu().numpy(),
                                 new_scores.cpu().numpy()))
            m.refreshes.labels(graph=graph).inc()
            m.refresh_seconds.labels(graph=graph).observe(
                self._clock() - t0)
            done += 1
        if done:
            m.convergence.record_update(UpdateTelemetry(
                graph=graph, kind="refresh", edges_changed=0,
                cache_dropped=0, cache_retained=done,
                duration_s=self._clock() - t_all))
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
        m = self.metrics
        now = self._clock() if now is None else now
        out: list[PPRResult] = []
        rec = None
        if self.scheduler.depth():
            group = self.scheduler.next_group(now, force=force)
            if group is None:
                m.held.inc()
            else:
                m.ticks.inc()
                self._tick_no += 1
                m.queue_depth.set(self.scheduler.depth())
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
        m = self.metrics
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
                m.served.labels(graph=e.q.graph,
                                disposition="cache_hit").inc()
                done = self._clock()
                e.tr.end("queue")
                m.latency.labels(graph=e.q.graph,
                                 disposition="cache_hit").observe(done - e.t0)
                m.tracer.finish(e.tr)
                out.append(self._materialize(e.q, epoch, *hit, cached=True))
            else:
                live.append(e)
        if not live:
            return out, None

        # ---- batch formation: identical queries share a column
        if self._inflight:
            # the card is still solving the previous batch while this
            # host-side formation runs: the overlap async dispatch buys
            m.overlap.inc()
        t_stage = self._clock()
        for e in live:
            queued = e.tr.end("queue")
            m.stage.labels(stage="queue").observe(
                queued if queued else t_stage - e.t0)
            e.tr.begin("batch_form")
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

        sched, _ = self.registry.schedule(live[0].q.c, live[0].q.tol)
        n = rg.n
        dev = self.registry.device
        b_pad = self._bucket(len(reps))
        m.padded.inc(b_pad - len(reps))
        rows = np.concatenate([np.asarray(q.seeds, np.int64) for q in reps])
        cidx = np.repeat(np.arange(len(reps), dtype=np.int64),
                         [len(q.seeds) for q in reps])
        c_q, tol_q = float(live[0].q.c), float(live[0].q.tol)
        self._lead("solve", graph, epoch, c_q, tol_q, b_pad, len(reps), rows,
                   cidx)
        p = self._personalization(n, b_pad, len(reps), rows, cidx)
        for e in live:
            e.tr.end("batch_form")
        m.stage.labels(stage="batch_form").observe(self._clock() - t_stage)

        # dispatch-time slack telemetry: how much budget the most urgent
        # rider had left, net of the expected solve (deadline health)
        deadlines = [e.deadline for e in live if e.deadline != math.inf]
        if deadlines:
            est = self.estimator.estimate(graph, b_pad)
            m.slack.labels(graph=graph).observe(
                min(deadlines) - self._clock() - est)

        # ---- dispatch (host): enqueue the solve, the top-k and the copies
        # to the host on the stream; the fence is _harvest's
        k = min(self.max_top_k, n)
        mode = "adaptive" if self.adaptive else "fixed"
        cuda = dev.type == "cuda"
        t_stage = self._clock()
        for e in live:
            e.tr.begin("solve_dispatch")
        solve_events = None
        if cuda and m.detail:
            solve_events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            solve_events[0].record()
        idx, scores, used, resid, tol_eff, c_eff = self._solve(
            rg, p, c_q, tol_q, k)
        if resid is not None:
            resid = _start_copy_to_host(resid)
        if solve_events is not None:
            solve_events[1].record()
        idx, scores = _start_copy_to_host(idx), _start_copy_to_host(scores)
        event = None
        if cuda:
            event = torch.cuda.Event()
            event.record()      # on the current stream, which ran the solve
        for e in live:
            e.tr.end("solve_dispatch")
        m.stage.labels(stage="solve_dispatch").observe(
            self._clock() - t_stage)
        return out, _InFlight(graph=graph, epoch=epoch, rg=rg, live=live,
                              cols=cols, col_of=col_of, n_reps=len(reps),
                              b_pad=b_pad, mode=mode, rounds_used=int(used),
                              rounds_bound=sched.rounds, tol=tol_eff,
                              c=c_eff, idx=idx, scores=scores, resid=resid,
                              event=event, solve_events=solve_events,
                              t_dispatch0=t_stage)

    def _personalization(self, n: int, b_pad: int, n_reps: int,
                         rows: np.ndarray, cidx: np.ndarray) -> torch.Tensor:
        """The [n, b_pad] personalization matrix, built on the device: only
        the seed coordinates cross from the host. Pad columns carry uniform
        mass and are discarded."""
        dev = self.registry.device
        p = torch.zeros((n, b_pad), dtype=self.registry.dtype, device=dev)
        # the value as a device tensor: a Python number assigned through
        # tensor indices is copied from the host, which waits for the stream
        p[_to_device_async(rows, dev), _to_device_async(cidx, dev)] = \
            torch.ones((), dtype=p.dtype, device=dev)
        p[:, n_reps:] = 1.0
        return p

    def _solve(self, rg, p: torch.Tensor, c: float, tol: float, k: int):
        """One batch solve + top-k on the graph's engine: (idx, scores,
        rounds used, adaptive residuals or None, tol, c) — the adaptive
        path's tol and c are its schedule's."""
        if self.adaptive:
            plan = self.registry.adaptive_schedule(c, tol,
                                                   chunk=self.adaptive_chunk)
            idx, scores, used, _, resid = _solve_topk_adaptive(
                rg.engine, p, plan.c, plan.tol, max_rounds=plan.max_rounds,
                chunk=plan.chunk, k=k)
            return idx, scores, used, resid, plan.tol, plan.c
        sched, coeffs = self.registry.schedule(c, tol)
        idx, scores = _solve_topk(rg.engine, coeffs, p, rounds=sched.rounds,
                                  k=k)
        return idx, scores, sched.rounds, None, tol, c

    # ---- lockstep across ranks --------------------------------------------
    def _lead(self, op: str, *args) -> None:
        """Rank 0: broadcast one collective step's plan to the followers
        before running it (nothing at world size 1)."""
        if self._world > 1:
            if self._closed:
                raise RuntimeError("service closed: the followers are gone")
            broadcast_object((op,) + args)

    def close(self) -> None:
        """Rank 0: end the followers' `follow()` loops (idempotent; nothing
        at world size 1). The service takes no collective step after it."""
        if self._world > 1 and rank() == 0 and not self._closed:
            broadcast_object(("close",))
        self._closed = True

    def follow(self) -> int:
        """Ranks > 0: run rank 0's plans — each solve, refresh and update
        batch, in rank 0's order — until rank 0 calls `close()`. The
        results are rank 0's to deliver; a follower keeps none. Returns
        the number of plans run.

        Raises:
            RuntimeError: called on rank 0, or a plan names an epoch this
                rank's registry is not at (the ranks lost lockstep).
        """
        if rank() == 0:
            raise RuntimeError("rank 0 leads the service; follow() is for "
                               "the other ranks")
        steps = 0
        dev = self.registry.device
        while True:
            msg = broadcast_object(None)
            op, args = msg[0], msg[1:]
            if op == "close":
                self._closed = True
                return steps
            if op == "update":
                name, insert, delete = args
                self.registry.apply_updates(name, insert=insert,
                                            delete=delete)
            else:
                rg = self.registry.get(args[0])
                if rg.epoch != args[1]:
                    raise RuntimeError(
                        f"lockstep lost: {op} of {args[0]!r} at epoch "
                        f"{args[1]}, this rank holds epoch {rg.epoch}")
                if op == "solve":
                    c, tol, b_pad, n_reps, rows, cidx = args[2:]
                    p = self._personalization(rg.n, b_pad, n_reps, rows,
                                              cidx)
                    self._solve(rg, p, c, tol, min(self.max_top_k, rg.n))
                elif op == "refresh":
                    idx, scores, seeds, c, tol = args[2:]
                    x0, p, gap = _refresh_inputs(rg.n, idx, scores, seeds,
                                                 dev)
                    _refine_topk(rg.engine, x0, p, c,
                                 rounds=self._refresh_round_count(gap, c,
                                                                  tol),
                                 k=min(self.max_top_k, rg.n))
                else:
                    raise RuntimeError(f"unknown lockstep plan {op!r}")
            steps += 1

    def _harvest(self, rec: _InFlight) -> list[PPRResult]:
        """Fence one dispatched batch and materialize its results: wait on
        its CUDA event (the only fence of the tick), feed the measured
        dispatch-to-ready time into the solve-time EWMA, fill the cache,
        settle each rider's disposition, latency and deadline, and record
        the tick's convergence telemetry."""
        m = self.metrics
        graph, epoch = rec.graph, rec.epoch

        # ---- device: the only fence
        t_stage = self._clock()
        if rec.event is not None:
            rec.event.synchronize()
        t_ready = self._clock()
        if rec.solve_events is not None:
            # device time of the solve, between events on its stream
            device_s = rec.solve_events[0].elapsed_time(
                rec.solve_events[1]) * 1e-3
        else:
            device_s = t_ready - t_stage
        for e in rec.live:
            e.tr.record("solve_device", t_stage, device_s, kind="device")
        m.stage.labels(stage="solve_device").observe(device_s)

        # the EWMA the deadline scheduler plans with: dispatch-to-ready,
        # what a batch riding this (graph, bucket) should expect
        t_solve = t_ready - rec.t_dispatch0
        self.estimator.observe(graph, rec.b_pad, t_solve)
        m.solve_seconds.labels(graph=graph, bucket=rec.b_pad).observe(t_solve)
        m.solve_ewma.labels(graph=graph, bucket=rec.b_pad).set(
            self.estimator.estimate(graph, rec.b_pad))

        engine_name = type(rec.rg.engine).__name__
        m.solves.labels(graph=graph, engine=engine_name, bucket=rec.b_pad,
                        mode=rec.mode).inc()
        m.rounds_used.labels(graph=graph, mode=rec.mode).inc(rec.rounds_used)
        m.rounds_bound.labels(graph=graph, mode=rec.mode).inc(
            rec.rounds_bound)

        # ---- materialize: cache fills, per-query results
        out: list[PPRResult] = []
        t_stage = self._clock()
        for e in rec.live:
            e.tr.begin("materialize")
        idx = rec.idx.numpy()
        scores = rec.scores.numpy()
        for key, j in rec.cols.items():
            self.cache.put(key, (idx[j], scores[j]))
        for i, e in enumerate(rec.live):
            # disposition: served by this solve (twins included — each
            # query counts itself, the COLUMNS were deduplicated)
            self.cache.count_miss()
            m.served.labels(graph=e.q.graph, disposition="solved").inc()
            j = rec.col_of[i]
            out.append(self._materialize(e.q, epoch, idx[j], scores[j],
                                         cached=False,
                                         batch_size=rec.n_reps))
            e.tr.end("materialize")
            done = self._clock()
            m.latency.labels(graph=e.q.graph, disposition="solved").observe(
                done - e.t0)
            if done > e.deadline:
                m.deadline_miss.labels(graph=e.q.graph,
                                       tenant=e.tenant).inc()
            m.tracer.finish(e.tr)
        m.stage.labels(stage="materialize").observe(self._clock() - t_stage)

        # ---- convergence telemetry: the paper's bound, checked per tick
        if rec.resid is not None:
            r_live = rec.resid.numpy()[:rec.n_reps]
            residual = float(r_live.max()) if r_live.size else 0.0
            converged = float(np.mean(r_live <= rec.tol)) if r_live.size \
                else 1.0
        else:
            residual = 0.0      # fixed path: no residual is measured
            converged = 1.0     # by construction of the a-priori bound
        m.convergence.record_tick(TickTelemetry(
            tick=self._tick_no, graph=graph, engine=engine_name,
            bucket=rec.b_pad, columns=rec.n_reps,
            rounds_used=rec.rounds_used, rounds_bound=rec.rounds_bound,
            residual=residual, converged_frac=converged, tol=rec.tol,
            c=rec.c))
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
        warning instead of raising. Dropped queries get no result."""
        m = self.metrics
        entries = self.scheduler.drain()
        n_drop = len(entries)
        now = self._clock()
        tenants = set()
        for e in entries:
            m.served.labels(graph=e.q.graph, disposition="dropped").inc()
            m.latency.labels(graph=e.q.graph, disposition="dropped").observe(
                now - e.t0)
            e.tr.end("queue")
            e.tr.mark("dropped")
            m.tracer.finish(e.tr)
            tenants.add(e.tenant)
        m.queue_depth.set(0)
        for t in tenants:
            m.tenant_depth.labels(tenant=t).set(0)
        warnings.warn(
            f"PPR serve loop dropped {n_drop} undrained queries after "
            f"{max_ticks} ticks (see serve_served_total"
            '{disposition="dropped"})', RuntimeWarning, stacklevel=3)

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
