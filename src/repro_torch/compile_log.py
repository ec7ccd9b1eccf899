"""The port's compile log: one (name, "shape dtype") entry for every CUDA
graph capture (`serve.engine.ServeEngine._capture`) and every nvcc build
(`kernels._build.build_all`).

The layers that compile append here; `analysis.retrace.RetraceGate` reads
the log to assert that steady state compiles nothing. Stdlib-only, so
recording costs an append and the lint CLI imports it on a bare Python.
"""
from __future__ import annotations

__all__ = ["record_compile", "compile_log"]

_LOG: list[tuple[str, str]] = []


def record_compile(name: str, signature: str) -> None:
    """Log one compile event: what was compiled and for which operands."""
    _LOG.append((name, signature))


def compile_log() -> list[tuple[str, str]]:
    """Every (name, signature) recorded in this process, oldest first."""
    return list(_LOG)
