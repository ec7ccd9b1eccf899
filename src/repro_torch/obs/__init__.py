"""Dependency-free observability for the port's serving stack (a copy of
`repro.obs`; only `trace.profiled` differs, see below).

Four layers, each usable on its own:

  * `obs.metrics`     — typed Counter/Gauge/Histogram families with labels;
                        latency histograms are log-bucketed (DDSketch-style)
                        so p50/p99/p999 queries are exact to a bounded
                        relative bucket width at O(1) memory per bucket.
  * `obs.trace`       — lightweight query-lifecycle spans (submit, queue,
                        batch-form, solve dispatch, fenced device time,
                        materialize) plus the opt-in `profiled()` hook that
                        wraps a region in `torch.profiler.profile` and
                        writes a Chrome trace.
  * `obs.convergence` — per-tick solver telemetry: adaptive `rounds_used`
                        vs the Formula 8 a-priori bound, residual-at-exit,
                        per-column converged fractions, and update-path
                        cache retention/refresh effectiveness, kept as
                        bounded time series tests and benches assert on.
  * `obs.export`      — Prometheus-text and JSON snapshot exposition, a
                        stdlib-http `/metrics` endpoint, snapshot schema
                        validation, and the single summary renderer the
                        serve CLI, benches and tests share.

Submodules load lazily (PEP 562): importing `repro_torch.obs` costs
nothing, and `python -m repro_torch.obs.export --validate FILE` runs
without the package pre-importing the module runpy is about to execute.

The metric catalog and the span model are the reference's
(docs/observability.md); the snapshot schema string is shared, so a
snapshot either package writes validates in the other.
"""
from importlib import import_module

_EXPORTS = {
    "Counter": "metrics", "Gauge": "metrics", "Histogram": "metrics",
    "Family": "metrics", "MetricsRegistry": "metrics",
    "NULL_REGISTRY": "metrics",
    "Span": "trace", "Trace": "trace", "Tracer": "trace",
    "NULL_TRACE": "trace", "profiled": "trace",
    "ConvergenceLog": "convergence", "TickTelemetry": "convergence",
    "UpdateTelemetry": "convergence",
    "MetricsServer": "export", "render_summary": "export",
    "snapshot": "export", "to_prometheus": "export",
    "validate_snapshot": "export", "write_snapshot": "export",
    "SNAPSHOT_SCHEMA": "export",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    submodule = _EXPORTS.get(name)
    if submodule is None:
        raise AttributeError(f"module 'repro_torch.obs' has no attribute {name!r}")
    value = getattr(import_module(f"repro_torch.obs.{submodule}"), name)
    globals()[name] = value     # cache: next access skips this hook
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
