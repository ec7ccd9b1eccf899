"""FLOP and byte reports of the hand-written kernels.

The kernels run through ctypes, so a counting `TorchDispatchMode`
(`launch/analysis.py`) never sees their work. Each wrapper reports its
own after every launch: `report(name, fn)`, where `fn()` returns
(flops, bytes) from the same byte count as the kernel's bound in
PERF.md's kernel table (each input read once, each output written once;
for the gathers and the scatter, the distinct rows they touch). Nothing
is computed unless a collector is active (`collecting`), so the hot path
pays one test per launch.
"""
from __future__ import annotations

import contextlib

__all__ = ["active", "report", "collecting"]

_sink = None          # the open collector's sink(name, fn), or None


def active() -> bool:
    """True while a `collecting` block is open."""
    return _sink is not None


def report(name: str, fn) -> None:
    """Hand `name` and `fn` (-> (flops, bytes)) to the open collector, if
    any; the collector calls `fn` (its torch ops are the accounting's, not
    the step's)."""
    if _sink is not None:
        _sink(name, fn)


@contextlib.contextmanager
def collecting(sink):
    """Route every kernel's report to sink(name, fn) inside the block (one
    block at a time)."""
    global _sink
    if _sink is not None:
        raise RuntimeError("a kernel cost collector is already open")
    _sink = sink
    try:
        yield sink
    finally:
        _sink = None
