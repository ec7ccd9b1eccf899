"""Query scheduling for the online PPR service (a copy of
`repro.serve.scheduler`; pure Python, no array library).

  * `TenantSpec`        — one tenant class: priority, default latency
                          budget, and its admission bound.
  * `AdmissionRejected` — raised by `admit` when a queue is full; carries a
                          machine-readable reason the service counts
                          (reject-with-reason, never silent).
  * `SolveTimeEstimator`— per-(graph, bucket) EWMAs of measured batch solve
                          time (dispatch to harvest on the service clock);
                          the deadline math's "expected solve time" term.
  * `FifoScheduler`     — one global FIFO behind the scheduler interface
                          (`admit` / `next_group` / `depth` / `drain`);
                          admission bound optional, never holds a batch.
  * `DeadlineScheduler` — per-(tenant, graph) queues with EDF dispatch and
                          deadline-aware batch CLOSING: a group is released
                          when the oldest query's remaining budget, minus
                          the EWMA solve estimate for the bucket it would
                          ride, says waiting longer risks the deadline.
"""
from __future__ import annotations

import heapq
import math
from collections import deque
from dataclasses import dataclass

__all__ = ["TenantSpec", "AdmissionRejected", "QueueEntry",
           "SolveTimeEstimator", "FifoScheduler", "DeadlineScheduler",
           "DEFAULT_TENANT"]


@dataclass(frozen=True)
class TenantSpec:
    """One tenant (SLO) class.

    Args:
        name: tenant label; `PPRQuery.tenant` selects it.
        priority: tie-break weight (higher = dispatched first among equal
            deadlines). Never overrides an earlier deadline.
        deadline_s: default latency budget for the tenant's queries, used
            when a query carries no `deadline_s` of its own. `inf` means
            "no SLO" (batch traffic).
        max_depth: admission bound — queued (not yet dispatched) queries
            this tenant may hold. `None` falls back to the scheduler-wide
            bound. Invariant: a tenant can never queue past its bound;
            excess submissions raise `AdmissionRejected`.
    """

    name: str = "default"
    priority: int = 1
    deadline_s: float = math.inf
    max_depth: int | None = None


DEFAULT_TENANT = TenantSpec()


class AdmissionRejected(RuntimeError):
    """A query was refused at admission (never enqueued, never counted as
    accepted).

    Attributes:
        reason: machine-readable cause — currently "queue_full" (the
            tenant's or scheduler's depth bound was hit). The service
            counts it under `serve_admission_total{decision="reject",
            reason=...}`.
        tenant: the tenant class the query presented.
        depth: that tenant's queue depth at rejection time.
    """

    def __init__(self, reason: str, tenant: str, depth: int):
        super().__init__(f"admission rejected ({reason}): tenant "
                         f"{tenant!r} at depth {depth}")
        self.reason = reason
        self.tenant = tenant
        self.depth = depth


@dataclass
class QueueEntry:
    """One admitted, not-yet-solved query as the scheduler tracks it.

    Invariant: `deadline` is absolute (same clock as `t0`), resolved ONCE
    at admission from the query's own budget or its tenant default — the
    scheduler never re-reads tenant config after admit.
    """

    q: object                  # PPRQuery
    t0: float                  # submit timestamp (service clock)
    tr: object                 # obs lifecycle trace (opaque here)
    deadline: float = math.inf  # absolute deadline on the service clock
    tenant: str = "default"
    priority: int = 1

    def group_key(self) -> tuple:
        """Solve-compatibility key: queries in one batch must share it."""
        return (self.q.graph, float(self.q.c), float(self.q.tol))


class SolveTimeEstimator:
    """Per-(graph, bucket) EWMA of measured batch solve time.

    The service observes every batch's dispatch-to-ready duration (from
    the host's dispatch to the harvest fence, on the service clock) keyed
    by (graph, bucket); `estimate` is the deadline math's
    expected-solve-time term. Cold keys fall back per-graph, then global,
    then `default_s` — an unwarmed estimator under-promises (estimate 0.0)
    and the scheduler dispatches eagerly, which is the safe direction.

    Args:
        alpha: EWMA weight of the newest sample (0 < alpha <= 1).
        default_s: estimate when nothing has been observed at all.

    Invariant: estimates are monotone in information — an exact
    (graph, bucket) sample always wins over the graph or global fallback.
    """

    def __init__(self, alpha: float = 0.25, default_s: float = 0.0):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha {alpha} outside (0, 1]")
        self.alpha = alpha
        self.default_s = default_s
        self._by_bucket: dict[tuple, float] = {}   # (graph, bucket) -> s
        self._by_graph: dict[str, float] = {}
        self._global: float | None = None
        self._seeded: set[str] = set()   # graphs whose value is a tuner seed

    def _ewma(self, old: float | None, sample: float) -> float:
        return sample if old is None else \
            old + self.alpha * (sample - old)

    def observe(self, graph: str, bucket: int, seconds: float) -> None:
        """Fold one measured batch solve time into the EWMAs.

        Args:
            graph: registry graph name.
            bucket: the power-of-two batch bucket the solve ran at.
            seconds: measured dispatch-to-ready duration (>= 0).
        """
        key = (graph, int(bucket))
        self._by_bucket[key] = self._ewma(self._by_bucket.get(key), seconds)
        if graph in self._seeded:
            # A tuner seed is a prior, not a sample: the first real
            # observation replaces it outright instead of EWMA-blending.
            self._seeded.discard(graph)
            self._by_graph[graph] = seconds
        else:
            self._by_graph[graph] = self._ewma(self._by_graph.get(graph),
                                               seconds)
        self._global = self._ewma(self._global, seconds)

    def estimate(self, graph: str, bucket: int) -> float:
        """Expected solve time for (graph, bucket), in seconds.

        Returns: the bucket EWMA, else the graph EWMA, else the global
        EWMA, else `default_s`.
        """
        v = self._by_bucket.get((graph, int(bucket)))
        if v is not None:
            return v
        v = self._by_graph.get(graph)
        if v is not None:
            return v
        return self._global if self._global is not None else self.default_s

    def snapshot(self) -> dict[tuple, float]:
        """Copy of the per-(graph, bucket) EWMAs (for gauges / debugging)."""
        return dict(self._by_bucket)

    def seed(self, graph: str, seconds: float) -> None:
        """Install a prior for `graph` from an out-of-band measurement
        (the engine autotuner's us_per_iter, scaled to a batch solve).

        Only the per-graph fallback is seeded — bucket EWMAs stay empty so
        exact samples still dominate — and only if nothing real has been
        observed yet. The first `observe` for the graph replaces the seed.
        """
        if graph not in self._by_graph:
            self._by_graph[graph] = float(seconds)
            self._seeded.add(graph)

    def reset(self, graph: str | None = None) -> None:
        """Forget observations — everything, or one graph's.

        With no argument: full reset (benchmarks drop warm-up samples this
        way — the first solve at a shape pays one-time set-up, which would
        otherwise dominate the EWMA for many ticks).
        With `graph`: drop that graph's bucket EWMAs, graph fallback and
        seed mark — the service does this on an engine swap so deadline
        math never runs on the old engine's timings.
        """
        if graph is None:
            self._by_bucket.clear()
            self._by_graph.clear()
            self._global = None
            self._seeded.clear()
            return
        for key in [k for k in self._by_bucket if k[0] == graph]:
            del self._by_bucket[key]
        self._by_graph.pop(graph, None)
        self._seeded.discard(graph)


class FifoScheduler:
    """The historical policy behind the scheduler interface.

    One global FIFO; `next_group` always releases the head query's
    compatibility group (up to `max_batch`, preserving arrival order) and
    never holds. Admission is unbounded unless `max_depth` is set.

    Invariant: dispatch order of group heads is exactly arrival order —
    deadlines and tenants are carried but ignored.
    """

    name = "fifo"

    def __init__(self, max_batch: int, max_depth: int | None = None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.max_batch = max_batch
        self.max_depth = max_depth
        self._q: deque[QueueEntry] = deque()

    def admit(self, e: QueueEntry, now: float | None = None) -> None:
        """Enqueue one entry.

        Raises:
            AdmissionRejected: `max_depth` is set and the queue is full
                (reason "queue_full").
        """
        if self.max_depth is not None and len(self._q) >= self.max_depth:
            raise AdmissionRejected("queue_full", e.tenant, len(self._q))
        self._q.append(e)

    def next_group(self, now: float | None = None,
                   force: bool = False) -> list[QueueEntry] | None:
        """Release the head query's (graph, c, tol) group, FIFO order.

        Returns: up to `max_batch` compatible entries, or None when empty.
        FIFO never holds, so `force` is irrelevant here.
        """
        if not self._q:
            return None
        gkey = self._q[0].group_key()
        group: list[QueueEntry] = []
        rest: deque[QueueEntry] = deque()
        while self._q:
            e = self._q.popleft()
            if len(group) < self.max_batch and e.group_key() == gkey:
                group.append(e)
            else:
                rest.append(e)
        self._q = rest
        return group

    def depth(self) -> int:
        """Queued (admitted, undispatched) entry count."""
        return len(self._q)

    def depth_for(self, tenant: str) -> int:
        """Queued entry count for one tenant (FIFO carries the label but
        bounds admission globally)."""
        return sum(1 for e in self._q if e.tenant == tenant)

    def drain(self) -> list[QueueEntry]:
        """Remove and return every queued entry (the service's drop path)."""
        out = list(self._q)
        self._q.clear()
        return out


class DeadlineScheduler:
    """Per-(tenant, graph) priority queues with admission control and
    deadline-aware batch formation (EDF across groups).

    Queries queue per (tenant, graph-operating-point); dispatch considers
    each solve-compatible group (graph, c, tol) MERGED across tenants —
    tenants share device batches, they don't share admission bounds. Within
    a group, entries release in (deadline, -priority, arrival) order.

    Args:
        max_batch: widest batch a group may dispatch (the service's).
        estimator: `SolveTimeEstimator` supplying expected solve times.
        tenants: mapping name -> `TenantSpec`; unknown tenants use
            `default_spec`.
        default_spec: spec for tenants not present in `tenants`.
        max_depth: per-tenant admission bound used when a spec carries
            none. None = unbounded.
        slack_margin_s: safety margin added to the expected solve time —
            a group is released once slack <= this margin.
        bucket: callable size -> padded bucket width (the service's
            power-of-two bucketing); identity by default.

    Invariant (no starvation): an admitted entry whose slack has reached
    the margin is dispatched within one `next_group` sweep — `next_group`
    never returns None while any group's slack is at or below the margin.
    """

    name = "deadline"

    def __init__(self, max_batch: int, estimator: SolveTimeEstimator,
                 tenants: dict[str, TenantSpec] | None = None,
                 default_spec: TenantSpec = DEFAULT_TENANT,
                 max_depth: int | None = None,
                 slack_margin_s: float = 0.0,
                 bucket=None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.max_batch = max_batch
        self.estimator = estimator
        self.tenants = dict(tenants or {})
        self.default_spec = default_spec
        self.max_depth = max_depth
        self.slack_margin_s = slack_margin_s
        self._bucket = bucket if bucket is not None else (lambda b: b)
        # (graph, c, tol) -> heap of (deadline, -priority, seq, entry)
        self._groups: dict[tuple, list] = {}
        self._tenant_depth: dict[str, int] = {}
        self._seq = 0

    def spec(self, tenant: str) -> TenantSpec:
        """Resolve a tenant name to its spec (default for unknown names)."""
        return self.tenants.get(tenant, self.default_spec)

    def admit(self, e: QueueEntry, now: float | None = None) -> None:
        """Admit one entry into its (tenant, group) queue.

        Raises:
            AdmissionRejected: the tenant is at its depth bound (its
                spec's `max_depth`, else the scheduler-wide one); reason
                "queue_full".
        """
        spec = self.spec(e.tenant)
        bound = spec.max_depth if spec.max_depth is not None \
            else self.max_depth
        depth = self._tenant_depth.get(e.tenant, 0)
        if bound is not None and depth >= bound:
            raise AdmissionRejected("queue_full", e.tenant, depth)
        heap = self._groups.setdefault(e.group_key(), [])
        heapq.heappush(heap, (e.deadline, -e.priority, self._seq, e))
        self._seq += 1
        self._tenant_depth[e.tenant] = depth + 1

    def _slack(self, gkey: tuple, heap: list, now: float) -> float:
        size = min(len(heap), self.max_batch)
        est = self.estimator.estimate(gkey[0], self._bucket(size))
        return heap[0][0] - now - est

    def next_group(self, now: float,
                   force: bool = False) -> list[QueueEntry] | None:
        """Pick and possibly release the most urgent compatible group.

        Args:
            now: current time on the service clock.
            force: True releases the most urgent group unconditionally
                (drain mode: no further arrivals can widen any batch).

        Returns: the released entries in (deadline, -priority, arrival)
        order (at most `max_batch`), or None — empty, or every group still
        has slack above the margin and room to grow (held for batching).
        """
        if not self._groups:
            return None
        best_key, best_heap, best_slack = None, None, math.inf
        for gkey, heap in self._groups.items():
            slack = self._slack(gkey, heap, now)
            # <= so all-infinite-slack groups (no deadlines anywhere) still
            # elect a candidate for the force/full release paths
            if best_heap is None or slack < best_slack:
                best_key, best_heap, best_slack = gkey, heap, slack
        full = len(best_heap) >= self.max_batch
        if not (force or full or best_slack <= self.slack_margin_s):
            return None     # hold: more arrivals may widen this batch
        group = []
        while best_heap and len(group) < self.max_batch:
            _, _, _, e = heapq.heappop(best_heap)
            group.append(e)
            self._tenant_depth[e.tenant] -= 1
            if not self._tenant_depth[e.tenant]:
                del self._tenant_depth[e.tenant]
        if not best_heap:
            del self._groups[best_key]
        return group

    def depth(self) -> int:
        """Queued (admitted, undispatched) entry count across all groups."""
        return sum(len(h) for h in self._groups.values())

    def depth_for(self, tenant: str) -> int:
        """Queued entry count for one tenant (admission's denominator)."""
        return self._tenant_depth.get(tenant, 0)

    def min_slack(self, now: float) -> float:
        """Most urgent group's slack at `now` (inf when empty)."""
        if not self._groups:
            return math.inf
        return min(self._slack(g, h, now)
                   for g, h in self._groups.items())

    def drain(self) -> list[QueueEntry]:
        """Remove and return every queued entry (the service's drop path),
        most urgent first."""
        out = []
        for heap in self._groups.values():
            out.extend(e for _, _, _, e in heap)
        out.sort(key=lambda e: (e.deadline, -e.priority))
        self._groups.clear()
        self._tenant_depth.clear()
        return out
