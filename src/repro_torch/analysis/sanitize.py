"""Runtime sanitizer tier: torch's runtime checkers for the test suite and
the card.

Static rules (TL001..TL006) catch what the AST can prove; this tier turns
on runtime checkers for everything the AST can't. The flags, and what each
stands in for in the reference's `jax.config` tier:

  * ``debug_nans`` (``jax_debug_nans``) — `NanCheckMode`, a
    `TorchDispatchMode` that names the first aten op whose floating output
    holds a NaN and raises `FloatingPointError`. On a CPU tensor it raises
    at that op. On CUDA it reads nothing back per op: each op's "any NaN"
    flag stays on the device, and the block's exit reads them once and
    raises naming the first. Not checked: ops recorded into a CUDA graph
    capture (the mode steps aside while the stream captures), so the
    replayed decode ticks of a `ServeEngine` are unchecked; the outputs of
    allocations (`empty*`, whose memory is not yet written) and host
    outputs of device->host copies (not there until the copy's stream
    gets to it); and the port's CUDA kernels, which are launched through
    ctypes and are no aten op: a NaN one writes shows at the first aten op
    that reads it;
  * ``sync_debug_mode`` (``jax_transfer_guard``) —
    `torch.cuda.set_sync_debug_mode`: "warn" warns at every operation that
    synchronizes host and card (`.item()`, a pageable device->host copy,
    `nonzero`), "error" raises there. A host without a card has nothing to
    synchronize with and leaves the flag alone;
  * ``detect_anomaly`` — `torch.autograd.set_detect_anomaly` (off by
    default: it records a traceback per autograd node).

``jax_check_tracer_leaks`` has no torch counterpart: eager tensors cannot
escape a trace, so the port's plan drops it.

The checked-in plan is ``torch_sanitize_optouts.json`` at the repo root
(next to ``torchlint_baseline.json``): the default flag values plus
per-test-module opt-outs, each with a mandatory ``reason``.
`repro_torch.analysis.pytest_plugin` applies it under
``pytest -p repro_torch.analysis.pytest_plugin --torch-sanitize``.

torch imports stay inside functions: the lint CLI shares this package and
must import on a bare Python.
"""
from __future__ import annotations

import json
from pathlib import Path

__all__ = ["SanitizePlan", "load_plan", "applied", "nan_check_mode",
           "DEFAULT_OPTOUTS_FILE", "FLAGS"]

FORMAT_VERSION = 1
DEFAULT_OPTOUTS_FILE = "torch_sanitize_optouts.json"
FLAGS = ("debug_nans", "sync_debug_mode", "detect_anomaly")

# Applied when the opt-out file is absent (e.g. a fresh checkout).
FALLBACK_DEFAULTS = {
    "debug_nans": True,
    "sync_debug_mode": "warn",
    "detect_anomaly": False,
}

_CHUNK = 4096   # CUDA NaN flags stacked into one tensor per this many ops
# aten ops whose output memory is allocated, not written
_UNWRITTEN = frozenset({"empty", "empty_like", "empty_strided",
                        "empty_permuted", "new_empty", "new_empty_strided",
                        "resize_", "set_"})


class SanitizePlan:
    """Parsed opt-out file: default flag values + per-module overrides."""

    def __init__(self, defaults: dict, modules: dict):
        self.defaults = dict(defaults)
        self.modules = dict(modules)

    def flags_for(self, module: str) -> dict:
        """Effective flags for one test module."""
        flags = dict(self.defaults)
        override = self.modules.get(module, {})
        flags.update({k: v for k, v in override.items() if k != "reason"})
        return flags


def load_plan(path: Path) -> SanitizePlan:
    """Read the opt-out file; every module override must carry a reason."""
    if not path.exists():
        return SanitizePlan(FALLBACK_DEFAULTS, {})
    data = json.loads(path.read_text())
    if data.get("version") != FORMAT_VERSION:
        raise ValueError(f"{path}: sanitize config version "
                         f"{data.get('version')!r}, expected {FORMAT_VERSION}")
    modules = data.get("modules", {})
    bad = [m for m, o in modules.items()
           if not str(o.get("reason", "")).strip()]
    if bad:
        raise ValueError(f"{path}: sanitizer opt-outs need a `reason`: "
                         f"{sorted(bad)}")
    return SanitizePlan(data.get("defaults", FALLBACK_DEFAULTS), modules)


def nan_check_mode():
    """A fresh `NanCheckMode` (the class is built on first use so that
    importing this module needs no torch)."""
    import torch
    from torch.utils import _pytree as pytree
    from torch.utils._python_dispatch import TorchDispatchMode

    class NanCheckMode(TorchDispatchMode):
        """Raises FloatingPointError naming the first aten op whose
        floating output holds a NaN (CPU: at the op; CUDA: at exit)."""

        def __init__(self):
            super().__init__()
            self.names: list[str] = []      # op of each pending CUDA flag
            self._flags: list = []          # [] bool device scalars
            self._chunks: list = []         # stacked _CHUNK flags each

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if func.overloadpacket.__name__ in _UNWRITTEN:
                return out
            from_card = any(isinstance(a, torch.Tensor) and
                            a.device.type == "cuda"
                            for a in pytree.tree_leaves((args, kwargs)))
            for t in pytree.tree_leaves(out):
                if not isinstance(t, torch.Tensor) or \
                        not t.is_floating_point() or t.numel() == 0 or \
                        t.layout != torch.strided:
                    continue
                if t.device.type == "cuda":
                    if torch.cuda.is_current_stream_capturing():
                        continue
                    self.names.append(str(func))
                    self._flags.append(torch.isnan(t).any())
                    if len(self._flags) == _CHUNK:
                        self._chunks.append(torch.stack(self._flags))
                        self._flags = []
                elif t.device.type == "cpu" and not from_card and \
                        bool(torch.isnan(t).any()):
                    raise FloatingPointError(
                        f"NaN in the output of aten op {func}")
            return out

        def first_nan(self) -> str | None:
            """The first op whose CUDA output held a NaN (one host read),
            or None."""
            parts = self._chunks + ([torch.stack(self._flags)]
                                    if self._flags else [])
            if not parts:
                return None
            hit = torch.cat(parts).nonzero()
            return self.names[int(hit[0, 0])] if len(hit) else None

        def __exit__(self, exc_type, exc, tb):
            out = super().__exit__(exc_type, exc, tb)
            if exc_type is None:
                first = self.first_nan()
                if first is not None:
                    raise FloatingPointError(
                        f"NaN in the output of aten op {first} (first of "
                        f"{len(self.names)} CUDA ops checked)")
            return out

    return NanCheckMode()


class applied:
    """Context manager applying a flag dict, restoring the previous values
    on exit (so per-module opt-outs stay scoped). `nan_mode` is the active
    `NanCheckMode` while debug_nans is on."""

    def __init__(self, flags: dict):
        unknown = set(flags) - set(FLAGS)
        if unknown:
            raise ValueError(f"unknown sanitizer flag(s) {sorted(unknown)}; "
                             f"known: {FLAGS}")
        self.flags = flags
        self.nan_mode = None
        self._prev: dict = {}

    def __enter__(self):
        import torch

        if "detect_anomaly" in self.flags:
            self._prev["detect_anomaly"] = torch.is_anomaly_enabled()
            torch.autograd.set_detect_anomaly(
                bool(self.flags["detect_anomaly"]))
        if "sync_debug_mode" in self.flags and torch.cuda.is_available():
            self._prev["sync_debug_mode"] = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode(self.flags["sync_debug_mode"])
        if self.flags.get("debug_nans"):
            self.nan_mode = nan_check_mode()
            self.nan_mode.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        import torch

        try:
            if self.nan_mode is not None:
                self.nan_mode.__exit__(exc_type, exc, tb)
        finally:
            if "sync_debug_mode" in self._prev:
                torch.cuda.set_sync_debug_mode(self._prev["sync_debug_mode"])
            if "detect_anomaly" in self._prev:
                torch.autograd.set_detect_anomaly(
                    self._prev["detect_anomaly"])
        return False
