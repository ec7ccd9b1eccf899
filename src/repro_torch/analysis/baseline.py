"""The checked-in torchlint baseline: known, justified findings.

The baseline (`torchlint_baseline.json` at the repo root) is the second
suppression tier: inline `# torchlint: disable=` markers document a
judgment call AT the site; the baseline records findings whose
justification is better kept in one reviewable place (the measurement
drivers' fences, for instance). The lint fails on any finding in NEITHER
tier, so the baseline is a ratchet — it can shrink silently but
growing it is a reviewed edit.

Entries are matched by FINGERPRINT — sha1 over (rule, path, normalized
source line) — so ordinary line drift (code moving within a file) does not
invalidate them, while any edit to the offending line itself does, forcing
a re-review. Every entry must carry a non-empty one-line `justification`;
`load()` rejects a baseline that doesn't (a TODO placeholder written by
`--update-baseline` counts as missing).
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from pathlib import Path

from repro_torch.analysis.core import Finding

__all__ = ["BaselineEntry", "Baseline", "fingerprint", "TODO_JUSTIFICATION"]

FORMAT_VERSION = 1
TODO_JUSTIFICATION = "TODO: justify this baseline entry"


def fingerprint(finding: Finding) -> str:
    """Stable id of a finding: rule + file + the offending line's text
    (whitespace-normalized). Line NUMBERS are deliberately excluded."""
    blob = f"{finding.rule}|{finding.path}|{' '.join(finding.code.split())}"
    return hashlib.sha1(blob.encode()).hexdigest()[:16]


@dataclass
class BaselineEntry:
    rule: str
    path: str
    fingerprint: str
    justification: str
    code: str = ""    # informational copy of the line at record time
    line: int = 0     # informational; matching ignores it

    def as_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path,
                "fingerprint": self.fingerprint,
                "justification": self.justification,
                "code": self.code, "line": self.line}


@dataclass
class Baseline:
    entries: list[BaselineEntry] = field(default_factory=list)

    def __post_init__(self):
        self._by_fp = {e.fingerprint: e for e in self.entries}

    @classmethod
    def load(cls, path: Path, require_justifications: bool = True) -> "Baseline":
        """Read a baseline file; missing file = empty baseline."""
        if not path.exists():
            return cls()
        data = json.loads(path.read_text())
        if data.get("version") != FORMAT_VERSION:
            raise ValueError(
                f"{path}: baseline version {data.get('version')!r}, "
                f"expected {FORMAT_VERSION}")
        entries = [BaselineEntry(**e) for e in data.get("findings", [])]
        if require_justifications:
            bad = [e for e in entries
                   if not e.justification.strip() or
                   e.justification.strip().upper().startswith("TODO")]
            if bad:
                lines = "\n".join(f"  {e.path}: {e.rule} {e.fingerprint}"
                                  for e in bad)
                raise ValueError(
                    f"{path}: every baseline entry needs a one-line "
                    f"justification; missing/TODO on:\n{lines}")
        return cls(entries)

    def save(self, path: Path) -> None:
        data = {
            "version": FORMAT_VERSION,
            "findings": [e.as_dict() for e in
                         sorted(self.entries,
                                key=lambda e: (e.path, e.rule, e.line))],
        }
        path.write_text(json.dumps(data, indent=2) + "\n")

    def match(self, finding: Finding) -> BaselineEntry | None:
        return self._by_fp.get(fingerprint(finding))

    def split(self, findings: list[Finding]):
        """(new, baselined, stale_entries): findings not in the baseline,
        findings absorbed by it, and entries no finding matched (candidates
        for removal — the ratchet's shrink signal)."""
        new, matched = [], []
        seen: set[str] = set()
        for f in findings:
            e = self.match(f)
            if e is None:
                new.append(f)
            else:
                matched.append(f)
                seen.add(e.fingerprint)
        stale = [e for e in self.entries if e.fingerprint not in seen]
        return new, matched, stale

    @classmethod
    def from_findings(cls, findings: list[Finding],
                      previous: "Baseline | None" = None) -> "Baseline":
        """Baseline covering `findings`, keeping justifications from
        `previous` where fingerprints survive; new entries get the TODO
        placeholder (which load() rejects until edited)."""
        entries = []
        seen: set[str] = set()
        for f in findings:
            fp = fingerprint(f)
            if fp in seen:
                continue
            seen.add(fp)
            prev = previous.match(f) if previous is not None else None
            entries.append(BaselineEntry(
                rule=f.rule, path=f.path, fingerprint=fp,
                justification=prev.justification if prev is not None
                else TODO_JUSTIFICATION,
                code=f.code, line=f.line))
        return cls(entries)
