"""Query-lifecycle spans and the opt-in PyTorch profiler hook (a copy of
`repro.obs.trace`, with `Trace.record` added and `profiled` on
`torch.profiler`).

A `Trace` is one traced unit of work (a query's life, a tick, a graph
update) holding an ordered list of named `Span`s. Spans are wall-clock
(`time.perf_counter`) intervals opened either bracketed::

    with trace.span("materialize"):
        ...

or split across call sites (a query's queue time starts at submit and ends
inside a later tick)::

    trace.begin("queue")
    ...                       # other code, other calls
    trace.end("queue")

CUDA work is asynchronous, so a host span around a kernel launch measures
the enqueue. The serve path therefore separates `solve_dispatch` (enqueue
on the stream, host clock) from `solve_device` (kind "device"): on CUDA the
elapsed time between two CUDA events recorded around the solve, read after
the tick's one fence and stored with `Trace.record`; on the CPU the host
clock around that fence point. `Span.kind` records which side a span timed.

The `Tracer` owns a bounded ring of completed traces (newest kept) so a
long-running service can always answer "show me the last N queries" without
growing. A disabled tracer hands out `NULL_TRACE`, which absorbs the whole
API at a cost of one attribute lookup per call.

`profiled(logdir)` is the deep-dive hook: it wraps a region in
`torch.profiler.profile` (CPU activity, plus CUDA where a card is present)
when a logdir is given and writes a Chrome trace there (view with Perfetto
or chrome://tracing); it is a free no-op otherwise.
"""
from __future__ import annotations

import os
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field

__all__ = ["Span", "Trace", "Tracer", "NULL_TRACE", "profiled"]


@dataclass
class Span:
    """One named interval inside a trace. `kind` is "host" or "device"."""

    name: str
    start: float
    end: float = 0.0
    kind: str = "host"

    @property
    def duration(self) -> float:
        return max(0.0, self.end - self.start)

    @property
    def closed(self) -> bool:
        return self.end != 0.0


class Trace:
    """Ordered spans for one traced unit (query, tick, or update)."""

    __slots__ = ("name", "meta", "spans", "_open", "created")

    def __init__(self, name: str, **meta):
        self.name = name
        self.meta = meta
        self.spans: list[Span] = []
        self._open: dict[str, Span] = {}
        self.created = time.perf_counter()

    def begin(self, name: str, kind: str = "host") -> None:
        """Open a span; re-opening an already-open name restarts it."""
        sp = Span(name=name, start=time.perf_counter(), kind=kind)
        self._open[name] = sp
        self.spans.append(sp)

    def end(self, name: str) -> float:
        """Close the span opened under `name`; returns its duration.
        Ending a span that was never begun is a no-op returning 0.0 (a
        cache-hit query never opens batch-form/solve spans)."""
        sp = self._open.pop(name, None)
        if sp is None:
            return 0.0
        sp.end = time.perf_counter()
        return sp.duration

    @contextmanager
    def span(self, name: str, kind: str = "host"):
        self.begin(name, kind=kind)
        try:
            yield self
        finally:
            self.end(name)

    def mark(self, name: str, kind: str = "host") -> None:
        """Record a zero-width event (e.g. "submit")."""
        now = time.perf_counter()
        self.spans.append(Span(name=name, start=now, end=now, kind=kind))

    def record(self, name: str, start: float, duration: float,
               kind: str = "host") -> None:
        """Record a closed span measured elsewhere: `duration` seconds from
        `start` (a perf_counter reading). The serve path stores the CUDA
        event time of a solve this way, once the fence has passed."""
        self.spans.append(Span(name=name, start=start,
                               end=start + max(0.0, duration), kind=kind))

    def duration(self, name: str) -> float:
        """Total closed duration of all spans named `name`."""
        return sum(s.duration for s in self.spans
                   if s.name == name and s.closed)

    def span_names(self) -> list[str]:
        return [s.name for s in self.spans]

    def total(self) -> float:
        """Wall time from trace creation to the latest closed span end."""
        ends = [s.end for s in self.spans if s.closed]
        return max(ends) - self.created if ends else 0.0

    def as_dict(self) -> dict:
        return {
            "name": self.name,
            "meta": dict(self.meta),
            "total_s": self.total(),
            "spans": [
                {"name": s.name, "kind": s.kind, "start_s": s.start - self.created,
                 "duration_s": s.duration}
                for s in self.spans if s.closed
            ],
        }


class _NullTrace(Trace):
    """Shared do-nothing trace: accepts the full Trace API, records nothing.
    Handed out by a disabled Tracer so call sites never branch."""

    def __init__(self):
        super().__init__("null")

    def begin(self, name, kind="host"):
        pass

    def end(self, name):
        return 0.0

    def mark(self, name, kind="host"):
        pass

    def record(self, name, start, duration, kind="host"):
        pass


NULL_TRACE = _NullTrace()


class Tracer:
    """Factory + bounded retention ring for traces.

    `start(...)` returns a live Trace when enabled, else `NULL_TRACE`.
    Completed traces are `finish()`ed into a deque keeping the newest
    `keep` entries, so retention cost is O(keep) regardless of uptime.
    """

    def __init__(self, enabled: bool = True, keep: int = 256):
        self.enabled = enabled
        self.keep = keep
        self.finished: deque[Trace] = deque(maxlen=keep)

    def start(self, name: str, **meta) -> Trace:
        if not self.enabled:
            return NULL_TRACE
        return Trace(name, **meta)

    def finish(self, trace: Trace) -> None:
        if trace is NULL_TRACE or not self.enabled:
            return
        self.finished.append(trace)

    def last(self, name: str | None = None) -> Trace | None:
        """Most recent finished trace, optionally filtered by name."""
        for tr in reversed(self.finished):
            if name is None or tr.name == name:
                return tr
        return None

    def drain(self) -> list[Trace]:
        out = list(self.finished)
        self.finished.clear()
        return out


@contextmanager
def profiled(logdir: str | None):
    """Opt-in deep-dive: wrap a region in `torch.profiler.profile` and
    write its Chrome trace to `logdir/trace_<pid>_<ns>.json` on exit.

    Activities: the CPU, plus CUDA when a card is present (kernel names
    and device times come from CUPTI). No-op when logdir is falsy or the
    profiler cannot start: serving must never die because profiling is
    broken. Exceptions raised inside the region propagate unchanged.
    """
    if not logdir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    try:
        prof.__enter__()
    except RuntimeError:
        yield
        return
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()    # the region's kernels into the trace
        prof.__exit__(None, None, None)
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
