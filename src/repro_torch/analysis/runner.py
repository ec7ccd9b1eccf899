"""torchlint CLI: `python -m repro_torch.analysis [paths...]`.

Exit codes: 0 clean (every finding inline-suppressed or baselined),
1 new findings (or a stale/invalid baseline under --strict), 2 usage or
internal error. Paths are resolved against `--root` (default: the
current directory, which is the repository root when run from there).
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from repro_torch.analysis.baseline import Baseline, TODO_JUSTIFICATION
from repro_torch.analysis.core import LintConfig, all_rules, lint_paths

__all__ = ["main", "run"]

DEFAULT_BASELINE = "torchlint_baseline.json"


def _build_config(args) -> LintConfig:
    known = set(all_rules())
    select = None
    if args.select:
        select = frozenset(s.strip() for s in args.select.split(","))
        bad = select - known
        if bad:
            raise SystemExit(f"unknown rule(s) in --select: {sorted(bad)}")
    ignore = frozenset()
    if args.ignore:
        ignore = frozenset(s.strip() for s in args.ignore.split(","))
        bad = ignore - known
        if bad:
            raise SystemExit(f"unknown rule(s) in --ignore: {sorted(bad)}")
    return LintConfig(select=select, ignore=ignore)


def run(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="PyTorch-aware static analysis of the port (torchlint) "
                    "— rules TL001..TL006 in repro_torch.analysis.rules")
    ap.add_argument("paths", nargs="*", default=["src/repro_torch"],
                    help="files or directories to lint "
                         "(default: src/repro_torch)")
    ap.add_argument("--root", default=".",
                    help="repo root paths are reported relative to")
    ap.add_argument("--baseline", default=None,
                    help=f"baseline file (default: <root>/{DEFAULT_BASELINE})")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline file entirely")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline to cover current findings "
                         "(keeps surviving justifications; NEW entries get "
                         "a TODO you must edit before the lint passes)")
    ap.add_argument("--select", help="comma-separated rule ids to run")
    ap.add_argument("--ignore", help="comma-separated rule ids to skip")
    ap.add_argument("--strict", action="store_true",
                    help="also fail on stale baseline entries")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="only print failures")
    args = ap.parse_args(argv)

    root = Path(args.root).resolve()
    targets = []
    for p in args.paths:
        pp = Path(p)
        if not pp.is_absolute():
            pp = root / pp
        if not pp.exists():
            print(f"error: no such path: {p}", file=sys.stderr)
            return 2
        targets.append(pp)

    config = _build_config(args)
    results = lint_paths(targets, root=root, config=config)
    findings = [f for r in results for f in r.findings]
    suppressed = sum(len(r.suppressed) for r in results)
    errors = [e for r in results for e in r.errors]
    for e in errors:
        print(f"error: {e}", file=sys.stderr)

    baseline_path = Path(args.baseline) if args.baseline \
        else root / DEFAULT_BASELINE

    if args.update_baseline:
        previous = None
        try:
            previous = Baseline.load(baseline_path,
                                     require_justifications=False)
        except ValueError:
            pass
        new_bl = Baseline.from_findings(findings, previous=previous)
        new_bl.save(baseline_path)
        todos = sum(1 for e in new_bl.entries
                    if e.justification == TODO_JUSTIFICATION)
        print(f"wrote {baseline_path} ({len(new_bl.entries)} entries, "
              f"{todos} needing justification)")
        if todos:
            print("edit the TODO justifications — the lint fails until "
                  "every entry carries one")
        return 0

    if args.no_baseline:
        new, baselined, stale = findings, [], []
    else:
        try:
            bl = Baseline.load(baseline_path)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        new, baselined, stale = bl.split(findings)

    for f in new:
        print(f.format())
        if f.code:
            print(f"    {f.code}")
    if stale:
        tag = "error" if args.strict else "warning"
        for e in stale:
            print(f"{tag}: stale baseline entry {e.rule} {e.fingerprint} "
                  f"({e.path}) — finding no longer present; remove it",
                  file=sys.stderr)

    n_files = len(results)
    if not args.quiet or new:
        print(f"torchlint: {n_files} files, {len(new)} new finding(s), "
              f"{len(baselined)} baselined, {suppressed} suppressed inline"
              + (f", {len(stale)} stale baseline entr(y/ies)" if stale
                 else ""))
    if errors:
        return 2
    if new or (stale and args.strict):
        return 1
    return 0


def main() -> None:  # console entry
    raise SystemExit(run())
