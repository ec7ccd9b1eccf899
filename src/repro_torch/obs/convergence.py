"""Per-tick convergence telemetry: does the paper's bound hold in serving?
(A copy of `repro.obs.convergence`.)

The adaptive CPAA solver (`core.pagerank.cpaa_adaptive_fixed`) runs until
the Chebyshev residual proxy drops below tol, capped by the Formula 8
a-priori bound K = ceil(ln(tol*(1-sqrt(c))/2) / ln(sqrt(c))) (Zhang et al.,
2112.01743). The paper's headline claim — convergence up to ~50% faster
than the bound suggests at c=0.85 — is a per-solve property, so the serve
path records it per tick:

  * `rounds_used` vs `rounds_bound` (the invariant used <= bound must hold
    for every tick; the obs tests assert it),
  * residual at exit (only meaningful when the solve stopped early),
  * the fraction of real (non-pad) columns individually converged at exit,
  * which engine/bucket served the tick.

Graph updates and background refreshes land in the same log so cache
retention and warm-start effectiveness are visible next to the solve
series. All three series are bounded deques (newest kept), so a
long-running service holds O(keep) history.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field, asdict

__all__ = ["TickTelemetry", "UpdateTelemetry", "ConvergenceLog"]


@dataclass(frozen=True)
class TickTelemetry:
    """One batched adaptive solve."""

    tick: int
    graph: str
    engine: str
    bucket: int            # padded batch width the solve compiled for
    columns: int           # real (non-pad) columns in the batch
    rounds_used: int
    rounds_bound: int
    residual: float        # residual proxy at exit
    converged_frac: float  # fraction of real columns converged at exit
    tol: float
    c: float

    @property
    def rounds_saved(self) -> int:
        """Rounds the residual controller saved vs the a-priori bound."""
        return self.rounds_bound - self.rounds_used

    @property
    def within_bound(self) -> bool:
        return self.rounds_used <= self.rounds_bound


@dataclass(frozen=True)
class UpdateTelemetry:
    """One graph update (or background refresh) as seen by the cache."""

    graph: str
    kind: str              # "noop" | "incremental" | "rebuild" | "refresh"
    edges_changed: int
    cache_dropped: int
    cache_retained: int
    duration_s: float

    @property
    def retention(self) -> float:
        """Fraction of cached entries that survived the update."""
        tot = self.cache_dropped + self.cache_retained
        return self.cache_retained / tot if tot else 1.0


class ConvergenceLog:
    """Bounded time series of tick/update telemetry + aggregate views."""

    def __init__(self, keep: int = 1024):
        self.ticks: deque[TickTelemetry] = deque(maxlen=keep)
        self.updates: deque[UpdateTelemetry] = deque(maxlen=keep)
        # running totals survive ring eviction so summaries cover all time
        self._tick_count = 0
        self._rounds_used_total = 0
        self._rounds_bound_total = 0
        self._bound_violations = 0

    def record_tick(self, t: TickTelemetry) -> None:
        self.ticks.append(t)
        self._tick_count += 1
        self._rounds_used_total += t.rounds_used
        self._rounds_bound_total += t.rounds_bound
        if not t.within_bound:
            self._bound_violations += 1

    def record_update(self, u: UpdateTelemetry) -> None:
        self.updates.append(u)

    @property
    def bound_violations(self) -> int:
        """Ticks where rounds_used exceeded the Formula 8 bound. Always 0
        unless the solver cap is broken — tests assert on this."""
        return self._bound_violations

    def rounds_saved_ratio(self) -> float:
        """All-time 1 - used/bound: the measured version of the paper's
        'up to 50% fewer rounds' claim (0.0 when nothing recorded)."""
        if self._rounds_bound_total == 0:
            return 0.0
        return 1.0 - self._rounds_used_total / self._rounds_bound_total

    def summary(self) -> dict:
        recent = list(self.ticks)
        ups = list(self.updates)
        out = {
            "ticks_recorded": self._tick_count,
            "rounds_used_total": self._rounds_used_total,
            "rounds_bound_total": self._rounds_bound_total,
            "bound_violations": self._bound_violations,
            "rounds_saved_ratio": self.rounds_saved_ratio(),
        }
        if recent:
            out["recent_converged_frac"] = (
                sum(t.converged_frac for t in recent) / len(recent))
            out["recent_residual_max"] = max(t.residual for t in recent)
        if ups:
            tot_drop = sum(u.cache_dropped for u in ups)
            tot_keep = sum(u.cache_retained for u in ups)
            out["updates_recorded"] = len(ups)
            out["cache_retention"] = (
                tot_keep / (tot_drop + tot_keep) if (tot_drop + tot_keep)
                else 1.0)
        return out

    def as_dicts(self) -> dict:
        """JSON-ready dump of the retained series (snapshot export)."""
        return {
            "ticks": [asdict(t) for t in self.ticks],
            "updates": [asdict(u) for u in self.updates],
            "summary": self.summary(),
        }
