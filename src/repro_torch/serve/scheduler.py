"""Query scheduling for the online PPR service (the FIFO part of
`repro.serve.scheduler`, copied; pure Python, no array library).

  * `TenantSpec`        — one tenant class: priority, default latency
                          budget, and its admission bound.
  * `AdmissionRejected` — raised by `admit` when a queue is full; carries a
                          machine-readable reason the service counts
                          (reject-with-reason, never silent).
  * `FifoScheduler`     — one global FIFO behind the scheduler interface
                          (`admit` / `next_group` / `depth` / `drain`);
                          admission bound optional, never holds a batch.

The reference's deadline scheduler and its solve-time estimator come with
the port's deadline-scheduling slice (ROADMAP A5), with their tests.
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass

__all__ = ["TenantSpec", "AdmissionRejected", "QueueEntry", "FifoScheduler",
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
