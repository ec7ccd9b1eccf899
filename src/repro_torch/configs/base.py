"""The registry's cell (port of `repro.configs.base`).

Every architecture module exposes:
  full_config()   the assigned configuration
  smoke_config()  a reduced config of the same family (CPU tests)
  cells()         its list of Cell(shape, kind, skip_reason, extra)
  smoke_run(seed, device)  one reduced run, returning its outputs

`DryRunPlan`, `abstract_tree` and each module's `build` (the dry-run
plans) wait for the dry-run tooling.
"""
from __future__ import annotations

from dataclasses import dataclass

__all__ = ["Cell"]


@dataclass(frozen=True)
class Cell:
    shape: str
    # train | prefill | decode | serve | retrieval | pagerank
    kind: str
    skip_reason: str | None = None
    extra: bool = False      # beyond the 40 assigned cells (perf variants)
