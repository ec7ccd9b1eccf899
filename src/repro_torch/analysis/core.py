"""torchlint framework: rules, config, suppressions, per-file runner.

Stdlib-only by design (ast + dataclasses): the lint runs on a bare Python
without torch installed.

A `Rule` is a named check over one parsed module. Rules are registered with
the `register` decorator and selected per run through `LintConfig.select` /
`ignore`. Each rule receives a `ModuleContext` — the parsed AST plus the
shared hot-code analysis from `repro_torch.analysis.torchctx` (which
functions are hot, which calls update their arguments in place, source
lines) — and yields `Finding`s.

Suppressions: a finding is dropped when its line carries an inline
marker::

    x = self.src.cpu().numpy()  # torchlint: disable=TL001 -- host CSR build

Several rules separated by commas suppress together
(``# torchlint: disable=TL001,TL003``), and a file-level marker
(``# torchlint: disable-file=TL003``) suppresses a rule for the whole
module. The text after ``--`` is the human justification; the runner
counts suppressions so a baseline diff can report them.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable, Iterator

from repro_torch.analysis import torchctx

__all__ = ["Finding", "LintConfig", "Rule", "ModuleContext", "LintResult",
           "register", "all_rules", "lint_source", "lint_file", "lint_paths"]


@dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    rule: str         # "TL001"
    path: str         # repo-relative posix path
    line: int         # 1-based
    col: int          # 0-based
    message: str
    code: str = ""    # the stripped offending source line

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col + 1}: " \
               f"{self.rule} {self.message}"


@dataclass(frozen=True)
class LintConfig:
    """Per-run rule selection + the codebase-tuned knobs each rule reads.

    The defaults encode the port's contracts: the engine protocol methods
    and the PPR tick path are hot (they run once per round or per tick and
    must not read the card), `w`/`inv_deg` are the packed (possibly bf16)
    attributes that must upcast before multiplying, and blocking fences are
    sanctioned only in `obs/trace.py`, the service harvest and the
    autotuner's timed round.
    """

    select: frozenset[str] | None = None   # None = every registered rule
    ignore: frozenset[str] = frozenset()

    # torchctx: methods that are hot by contract when defined in a class
    # body (the engine protocol: every solver round calls them)
    hot_methods: tuple[str, ...] = ("apply", "cheb_round", "to_internal",
                                    "from_internal")
    # torchctx: (path suffix, function name) pairs that are hot: the
    # functions the reference jits, under their names in the port's
    # counterpart modules, and the PPR tick path
    hot_functions: tuple[tuple[str, str], ...] = (
        ("core/pagerank.py", "cpaa_fixed"),
        ("core/pagerank.py", "cpaa_adaptive_fixed"),
        ("core/pagerank.py", "power_refine"),
        ("serve/pagerank_service.py", "tick"),
        ("serve/pagerank_service.py", "_form_and_dispatch"),
        ("serve/pagerank_service.py", "_personalization"),
        ("serve/pagerank_service.py", "_solve"),
        ("serve/pagerank_service.py", "_harvest"),
        ("serve/pagerank_service.py", "_solve_topk"),
        ("serve/pagerank_service.py", "_solve_topk_adaptive"),
        ("serve/pagerank_service.py", "_refine_topk"),
        ("serve/pagerank_service.py", "_start_copy_to_host"),
        ("serve/pagerank_service.py", "_to_device_async"),
    )

    # TL001: numpy-module aliases, the coercions and tensor methods that
    # read a device value on the host, and the np.* calls that are pure
    # host metadata (fine in hot code)
    numpy_aliases: tuple[str, ...] = ("np", "numpy")
    transfer_calls: tuple[str, ...] = ("float", "int", "bool", "complex")
    host_methods: tuple[str, ...] = ("item", "tolist", "cpu", "numpy")
    numpy_meta_calls: tuple[str, ...] = ("dtype", "iinfo", "finfo", "shape",
                                         "ndim", "result_type", "promote_types")
    # receivers whose src/dst/w/inv_deg attributes are device tensors by
    # convention (DeviceGraph instances / engine self): reading them on the
    # host is a device->host copy even outside hot code
    device_receivers: tuple[str, ...] = ("self", "dg")
    device_attrs: tuple[str, ...] = ("src", "dst", "w", "inv_deg")

    # TL003: attributes holding packed-storage weights (bf16 allowed);
    # multiplying them without a `.to(x.dtype)` / `.float()` upcast breaks
    # the f32-accumulation contract
    packed_attrs: tuple[str, ...] = ("w", "inv_deg")

    # TL004: fields a copy method may leave behind (caches / informational)
    exempt_prefixes: tuple[str, ...] = ("_",)

    # torchctx / TL005: calls that update argument positions in place.
    # in_place_calls: callee -> positions updated when the call passes
    # in_place=True; in_place_factories: a name bound from the factory's
    # call updates these positions unless the call passes donate=False
    in_place_calls: tuple[tuple[str, tuple[int, ...]], ...] = (
        ("adamw_update", (1, 2)),
        ("adamw_step", (0, 2, 3)),
    )
    in_place_factories: tuple[tuple[str, tuple[int, ...]], ...] = (
        ("make_train_step", (0, 1)),
    )

    # TL006: (path-suffix, function-name) pairs where blocking calls are
    # sanctioned. "*" matches any function.
    blocking_allowed: tuple[tuple[str, str], ...] = (
        ("obs/trace.py", "*"),
        ("serve/pagerank_service.py", "_harvest"),
        # the autotuner's candidate timing is a deliberate fence: it times
        # warm solve rounds, so every rep must be device-complete
        ("core/autotune.py", "_time_round"),
    )
    # torch.cuda.synchronize, Event.synchronize, Stream.synchronize
    blocking_calls: tuple[str, ...] = ("synchronize",)

    def enabled(self, rule_id: str) -> bool:
        if rule_id in self.ignore:
            return False
        return self.select is None or rule_id in self.select


class ModuleContext:
    """Everything a rule needs about one module, computed once."""

    def __init__(self, path: str, source: str, config: LintConfig):
        self.path = path
        self.source = source
        self.config = config
        self.tree = ast.parse(source, filename=path)
        self.lines = source.splitlines()
        self.hot = torchctx.analyze(
            self.tree, hot_methods=config.hot_methods,
            hot_functions=tuple(fn for suffix, fn in config.hot_functions
                                if path.endswith(suffix)),
            in_place_calls=dict(config.in_place_calls),
            in_place_factories=dict(config.in_place_factories))

    def line(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def finding(self, rule: str, node: ast.AST, message: str) -> Finding:
        return Finding(rule=rule, path=self.path, line=node.lineno,
                       col=node.col_offset, message=message,
                       code=self.line(node.lineno))


class Rule:
    """One named check. Subclasses set `rule_id`/`title` and implement
    `run(ctx) -> Iterator[Finding]`."""

    rule_id: str = ""
    title: str = ""

    def run(self, ctx: ModuleContext) -> Iterator[Finding]:  # pragma: no cover
        raise NotImplementedError


_REGISTRY: dict[str, type[Rule]] = {}


def register(cls: type[Rule]) -> type[Rule]:
    """Class decorator adding a Rule to the global registry (id-unique)."""
    if not cls.rule_id:
        raise ValueError(f"{cls.__name__} has no rule_id")
    if cls.rule_id in _REGISTRY and _REGISTRY[cls.rule_id] is not cls:
        raise ValueError(f"duplicate rule id {cls.rule_id}")
    _REGISTRY[cls.rule_id] = cls
    return cls


def all_rules() -> dict[str, type[Rule]]:
    """rule_id -> Rule class for every registered rule (import side effect:
    registering `repro_torch.analysis.rules`)."""
    from repro_torch.analysis import rules as _rules  # noqa: F401
    return dict(_REGISTRY)


# --------------------------------------------------------------------------
# suppressions

_SUPPRESS_RE = re.compile(
    r"#\s*torchlint:\s*disable=([A-Z0-9,\s]+?)(?:\s*--|$)")
_SUPPRESS_FILE_RE = re.compile(
    r"#\s*torchlint:\s*disable-file=([A-Z0-9,\s]+?)(?:\s*--|$)")


def _parse_ids(blob: str) -> set[str]:
    return {p.strip() for p in blob.split(",") if p.strip()}


def line_suppressions(lines: list[str]) -> dict[int, set[str]]:
    """1-based line -> rule ids suppressed on that line. A marker on its own
    line (nothing but the comment) also covers the NEXT line, so long
    statements can carry the justification above instead of trailing."""
    out: dict[int, set[str]] = {}
    for i, ln in enumerate(lines, start=1):
        m = _SUPPRESS_RE.search(ln)
        if not m:
            continue
        ids = _parse_ids(m.group(1))
        out.setdefault(i, set()).update(ids)
        if ln.strip().startswith("#"):
            out.setdefault(i + 1, set()).update(ids)
    return out


def file_suppressions(lines: list[str]) -> set[str]:
    """Rule ids disabled for the whole file via `# torchlint: disable-file=`
    markers anywhere in the module (conventionally the top comment block)."""
    out: set[str] = set()
    for ln in lines:
        m = _SUPPRESS_FILE_RE.search(ln)
        if m:
            out.update(_parse_ids(m.group(1)))
    return out


# --------------------------------------------------------------------------
# runner

@dataclass
class LintResult:
    """Findings for one file plus the suppression accounting."""

    path: str
    findings: list[Finding] = field(default_factory=list)
    suppressed: list[Finding] = field(default_factory=list)
    errors: list[str] = field(default_factory=list)


def lint_source(source: str, path: str = "<string>",
                config: LintConfig | None = None) -> LintResult:
    """Lint one module's source. Returns surviving + suppressed findings."""
    config = config or LintConfig()
    result = LintResult(path=path)
    try:
        ctx = ModuleContext(path, source, config)
    except SyntaxError as e:
        result.errors.append(f"{path}: syntax error: {e}")
        return result
    per_line = line_suppressions(ctx.lines)
    per_file = file_suppressions(ctx.lines)
    for rule_id, rule_cls in sorted(all_rules().items()):
        if not config.enabled(rule_id):
            continue
        for f in rule_cls().run(ctx):
            if f.rule in per_file or f.rule in per_line.get(f.line, ()):
                result.suppressed.append(f)
            else:
                result.findings.append(f)
    result.findings.sort(key=lambda f: (f.line, f.col, f.rule))
    return result


def lint_file(path: Path, root: Path | None = None,
              config: LintConfig | None = None) -> LintResult:
    rel = path.relative_to(root).as_posix() if root else path.as_posix()
    try:
        source = path.read_text()
    except OSError as e:
        r = LintResult(path=rel)
        r.errors.append(f"{rel}: unreadable: {e}")
        return r
    return lint_source(source, path=rel, config=config)


def iter_python_files(paths: Iterable[Path]) -> Iterator[Path]:
    for p in paths:
        if p.is_dir():
            yield from sorted(p.rglob("*.py"))
        elif p.suffix == ".py":
            yield p


def lint_paths(paths: Iterable[Path], root: Path | None = None,
               config: LintConfig | None = None) -> list[LintResult]:
    """Lint every .py under `paths` (files or directories)."""
    return [lint_file(p, root=root, config=config)
            for p in iter_python_files(paths)]
