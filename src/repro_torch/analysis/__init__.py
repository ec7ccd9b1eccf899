"""PyTorch-aware static analysis of the port (torchlint), and its runtime
tier.

The port's load-bearing invariants — one device fence per tick (the
harvest's event), f32 accumulation over bf16 storage, no CUDA graph
capture and no nvcc build in steady state — are machine-checked here, as
the reference's `repro.analysis` (jaxlint) checks its own:

  * `repro_torch.analysis.core`     — the framework: `Rule` registry,
    `Finding`, per-rule `LintConfig`, `# torchlint: disable=RULE` inline
    suppressions, and the per-file runner.
  * `repro_torch.analysis.torchctx` — which code is hot (engine protocol
    methods, CUDA graph capture bodies, torch.compile targets, the named
    hot functions) and which calls update arguments in place.
  * `repro_torch.analysis.rules`    — the six rules (TL001..TL006), one
    for each of the reference's JL rules.
  * `repro_torch.analysis.baseline` — the checked-in findings baseline
    (`torchlint_baseline.json`): known, justified findings that do not fail
    the lint, fingerprinted so line drift does not invalidate them.
  * `repro_torch.analysis.runner`   — the CLI
    (`python -m repro_torch.analysis`, default path `src/repro_torch`).
  * `repro_torch.analysis.sanitize` — the RUNTIME tier: a NaN-naming
    dispatch mode, CUDA sync debug mode and anomaly detection, applied per
    test module by `repro_torch.analysis.pytest_plugin` under
    `--torch-sanitize`, with opt-outs in `torch_sanitize_optouts.json`.
  * `repro_torch.analysis.retrace`  — `RetraceGate`, the hard steady-state
    gate over the port's compile log (`repro_torch.compile_log`, which the
    CUDA graph capture and the nvcc build append to).

The static side (core/torchctx/rules/baseline/runner) and `retrace` are
stdlib-only — no torch import — so the lint runs on a bare Python. The
runtime side imports torch lazily.
"""
from repro_torch.analysis.baseline import Baseline, BaselineEntry, fingerprint
from repro_torch.analysis.core import (Finding, LintConfig, Rule, all_rules,
                                       lint_file, lint_paths, lint_source)

__all__ = [
    "Baseline",
    "BaselineEntry",
    "Finding",
    "LintConfig",
    "Rule",
    "all_rules",
    "fingerprint",
    "lint_file",
    "lint_paths",
    "lint_source",
]
