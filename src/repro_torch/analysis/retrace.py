"""RetraceGate: the runtime complement to the TL002 lint rule.

The port compiles in two places, and each records the event in
`repro_torch.compile_log`, which the gate reads:

  * a CUDA graph capture — `ServeEngine._capture` records
    ("ServeEngine._decode_core", the tick's token and length buffers as
    "shape dtype") when the first full tick of an engine captures its
    decode step;
  * an nvcc build — `kernels._build.build_all` records (kernel name,
    "build") for every source it compiles.

Steady state does neither: a captured engine replays its graph and the
kernels are built once per process. The PPR path captures nothing and
its kernels take any batch width, so a batch-bucket change compiles
nothing and the gate stays quiet there — unlike the reference's, which
trips on the fresh trace of a new bucket.

Usage (wrap a warm steady-state loop):

    warm up the service ...
    with RetraceGate():          # zero compiles allowed
        for _ in range(50):
            svc.tick()

On violation the gate raises `RetraceError` listing each offending
(name, "shape dtype") signature against the set seen before the gate —
the diff names the axis that churned.

Stdlib-only, as the log is, so the lint CLI can import the package on a
bare Python.
"""
from __future__ import annotations

from collections import Counter

from repro_torch.compile_log import compile_log

__all__ = ["RetraceError", "RetraceGate"]


class RetraceError(AssertionError):
    """A hot path captured or compiled inside a RetraceGate block."""


class RetraceGate:
    """Context manager asserting no compile events happen inside.

    `allowed` > 0 tolerates that many events (e.g. a test that
    deliberately builds one new engine). The gate snapshots the global log
    on entry, so gates can nest and interleave with unrelated compiles
    BEFORE entry; activity INSIDE the block is attributed to the block.
    """

    def __init__(self, allowed: int = 0):
        self.allowed = allowed
        self.events: list[tuple[str, str]] = []
        self._mark = 0
        self._warm: Counter | None = None

    def __enter__(self) -> "RetraceGate":
        log = compile_log()
        self._mark = len(log)
        self._warm = Counter(log)   # signatures seen before the gate
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.events = compile_log()[self._mark:]
        if exc_type is None and len(self.events) > self.allowed:
            raise RetraceError(self._describe())
        return False

    def _describe(self) -> str:
        warm = self._warm or Counter()
        lines = [
            f"{len(self.events)} compile(s) inside a RetraceGate "
            f"(allowed {self.allowed}) — a hot path captured or built in "
            "steady state:"
        ]
        for name, sig in self.events:
            status = ("signature already compiled during warmup — a cache "
                      "was dropped, not a shape change"
                      if (name, sig) in warm
                      else "NEW signature — shape/dtype drift into the "
                           "hot path")
            lines.append(f"  {name}: {sig}  [{status}]")
        if warm:
            seen = ", ".join(f"{n}: {s}" for (n, s) in sorted(warm))
            lines.append(f"  warmup signatures were: {seen}")
        return "\n".join(lines)
