"""torchlint, the port's static analysis, and its runtime tier, held to the
reference's jaxlint (`repro.analysis`) where the two share behaviour.

* the framework: fingerprints, inline / file suppressions (the marker name
  swapped), baselines written by either package, and the CLI's exit codes
  and summary line, each against the reference on the same inputs;
* every rule: a positive fixture that fires the stated number of times and
  a negative that stays quiet (`tests/fixtures/torchlint/`); each of the
  reference's `jl00N_pos.py` has a torch translation `tl00N_pos.py` that
  fires the TL counterpart on the same lines;
* the hot-code analysis covers what the reference's jaxctx marks traced in
  the counterpart modules, TL004 fires on a `with_kernels` that drops a
  field, and `src/repro_torch` is clean against `torchlint_baseline.json`;
* the sanitizer plan, the NaN dispatch mode, `applied`, the pytest plugin
  (a subprocess run under `--torch-sanitize`) and `RetraceGate` on the
  CPU by way of the compile log.
"""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.analysis import baseline as jbl
from repro.analysis import core as jcore
from repro.analysis import jaxctx
from repro.analysis import runner as jrunner
from repro.graph import generators as jgen
from repro.serve import GraphRegistry as JRegistry
from repro.serve import PageRankService as JService
from repro.serve import PPRQuery as JQuery

from repro_torch.analysis import (Baseline, LintConfig, all_rules,
                                  fingerprint, lint_file, lint_paths,
                                  lint_source)
from repro_torch.analysis import core as tcore
from repro_torch import compile_log
from repro_torch.analysis import retrace, runner, sanitize
from repro_torch.analysis.baseline import BaselineEntry, TODO_JUSTIFICATION
from repro_torch.analysis.core import Finding, ModuleContext
from repro_torch.graph import generators
from repro_torch.serve import GraphRegistry, PageRankService, PPRQuery

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures" / "torchlint"
JL_FIXTURES = REPO / "tests" / "fixtures" / "jaxlint"
PORT = REPO / "src" / "repro_torch"
ALL_RULES = ("TL001", "TL002", "TL003", "TL004", "TL005", "TL006")


def fixture_findings(name: str, config: LintConfig | None = None):
    res = lint_file(FIXTURES / name, root=FIXTURES, config=config)
    assert not res.errors, res.errors
    return res.findings


def fixture_rules(name: str, config: LintConfig | None = None) -> list[str]:
    return [f.rule for f in fixture_findings(name, config)]


# ------------------------------------------------------------------ rules --
class TestRuleFixtures:
    def test_registry_is_complete(self):
        assert tuple(sorted(all_rules())) == ALL_RULES

    @pytest.mark.parametrize("rule,expected", [
        ("TL001", 4),   # np call, float(), .item() in hot code; dg.w.cpu()
        ("TL002", 3),   # per-call compile, nested compiled def, shape key
        ("TL003", 3),   # packed multiply, float64 dtype, "float64" string
        ("TL004", 1),   # field dropped by the copy method
        ("TL005", 1),   # read after an in-place step
        ("TL006", 2),   # torch.cuda.synchronize + Stream.synchronize
    ])
    def test_positive_fixture_fires(self, rule, expected):
        found = fixture_rules(f"{rule.lower()}_pos.py")
        assert found.count(rule) == expected, found

    @pytest.mark.parametrize("rule", ALL_RULES)
    def test_negative_fixture_stays_quiet(self, rule):
        found = fixture_rules(f"{rule.lower()}_neg.py")
        assert rule not in found, found

    @pytest.mark.parametrize("n", range(1, 7))
    def test_translation_fires_on_the_reference_lines(self, n):
        """tl00N_pos.py is jl00N_pos.py in torch: TL00N fires on exactly
        the lines where the reference's JL00N fires."""
        ref = jcore.lint_file(JL_FIXTURES / f"jl00{n}_pos.py",
                              root=JL_FIXTURES)
        ref_lines = [f.line for f in ref.findings if f.rule == f"JL00{n}"]
        lines = [f.line for f in fixture_findings(f"tl00{n}_pos.py")
                 if f.rule == f"TL00{n}"]
        assert ref_lines and lines == ref_lines

    def test_tl006_allowlist_silences_the_positive(self):
        cfg = LintConfig(blocking_allowed=(("tl006_pos.py", "*"),))
        assert "TL006" not in fixture_rules("tl006_pos.py", config=cfg)

    def test_select_and_ignore(self):
        only = LintConfig(select=frozenset({"TL006"}))
        assert set(fixture_rules("tl001_pos.py", config=only)) == set()
        skip = LintConfig(ignore=frozenset({"TL001"}))
        assert "TL001" not in fixture_rules("tl001_pos.py", config=skip)


def _rules_of(src: str, path: str = "t.py") -> list[tuple[str, int]]:
    return [(f.rule, f.line) for f in lint_source(src, path=path).findings]


class TestTorchForms:
    """The forms the translated fixtures do not reach."""

    def test_capture_body_is_hot(self):
        src = ("import torch\n"
               "class E:\n"
               "    def _core(self, x):\n"
               "        return x.item()\n"
               "    def capture(self, x):\n"
               "        with torch.cuda.graph(self._g):\n"
               "            self._core(x)\n")
        assert _rules_of(src) == [("TL001", 4)]

    def test_hot_functions_by_path(self):
        src = "def tick(x):\n    return x.cpu()\n"
        assert _rules_of(src, "src/repro_torch/serve/pagerank_service.py") \
            == [("TL001", 2)]
        assert _rules_of(src, "src/repro_torch/serve/other.py") == []

    def test_compile_wrapping_marks_the_target(self):
        src = ("import torch\n"
               "def f(x):\n"
               "    return bool(x.sum())\n"
               "g = torch.compile(f)\n")
        assert _rules_of(src) == [("TL001", 3)]

    def test_host_to_device_copies_in_hot_code(self):
        src = ("import torch\n"
               "class E:\n"
               "    def apply(self, x, c, idx):\n"
               "        a = torch.tensor(c, device=x.device)\n"
               "        b = torch.full((), c, device=x.device)\n"
               "        x[idx, 0] = 1.0\n"
               "        x[:, 3:] = 1.0\n"
               "        x[idx, 0] = b\n"
               "        return torch.as_tensor(c, dtype=x.dtype, "
               "device=x.device) + a + b\n"
               "def cold(x, c):\n"
               "    x[:, 1:] = 0.0\n"
               "    return torch.tensor(c, device=x.device)\n")
        assert _rules_of(src) == [("TL001", 4), ("TL001", 6), ("TL001", 9)]

    def test_per_call_cuda_graph(self):
        src = ("import torch\n"
               "def tick(self):\n"
               "    g = torch.cuda.CUDAGraph()\n"
               "    return g\n"
               "def kept(self):\n"
               "    self._g = torch.cuda.CUDAGraph()\n")
        assert _rules_of(src) == [("TL002", 3)]

    def test_float64_forms(self):
        src = ("import torch\n"
               "a = torch.zeros(3, dtype=torch.float64)\n"
               "b = torch.zeros(3).double()\n"
               "c = torch.zeros(3, dtype=torch.double)\n"
               "d = torch.zeros(3, dtype=torch.float32).float()\n")
        assert _rules_of(src) == [("TL003", 2), ("TL003", 3), ("TL003", 4)]

    def test_packed_matmul_and_upcast(self):
        src = ("import torch\n"
               "class E:\n"
               "    def apply(self, x):\n"
               "        a = torch.matmul(self.inv_deg, x)\n"
               "        return a + torch.mul(self.w.float(), x)\n")
        assert _rules_of(src) == [("TL003", 4)]

    def test_in_place_keyword_call(self):
        src = ("from repro_torch.train.optimizer import adamw_update\n"
               "def step(g, state, params, cfg):\n"
               "    adamw_update(g, state, params, cfg, in_place=True)\n"
               "    return params, state\n")
        assert _rules_of(src) == [("TL005", 4), ("TL005", 4)]

    def test_rebind_inside_a_loop(self):
        """`params, opt, m = step(params, opt, b)` in a loop rebinds: a
        read after the loop sees what the loop last returned."""
        src = ("from repro_torch.train.train_loop import make_train_step\n"
               "def run(params, opt, batches):\n"
               "    step = make_train_step(None, None)\n"
               "    for b in batches:\n"
               "        params, opt, m = step(params, opt, b)\n"
               "    return params\n")
        assert _rules_of(src) == []

    def test_donate_false_binding_shadows_per_function(self):
        src = ("from repro_torch.train.train_loop import make_train_step\n"
               "def a(params, opt, b):\n"
               "    step = make_train_step(None, None)\n"
               "    step(params, opt, b)\n"
               "    return params\n"
               "def c(params, opt, b):\n"
               "    step = make_train_step(None, None, donate=False)\n"
               "    step(params, opt, b)\n"
               "    return params\n")
        assert _rules_of(src) == [("TL005", 5)]

    def test_tl004_fires_on_a_with_kernels_that_drops_a_field(self):
        """The real BlockEllEngine with `fill_rate` dropped from its copy."""
        path = "src/repro_torch/core/engine.py"
        src = (REPO / path).read_text()
        assert "TL004" not in [f.rule for f in
                               lint_source(src, path=path).findings]
        dropped = src.replace(
            "                         self.inv_perm, self.n_orig, "
            "self.block,\n                         fill_rate=self.fill_rate)",
            "                         self.inv_perm, self.n_orig, "
            "self.block)")
        assert dropped != src
        found = [f for f in lint_source(dropped, path=path).findings
                 if f.rule == "TL004"]
        assert len(found) == 1 and "`fill_rate`" in found[0].message
        assert "BlockEllEngine" in found[0].message


class TestTickPathSyncs:
    """A fault the sanitizer found on the card (slice L-a): the tick path
    copied host scalars to the card (torch.tensor(c, device=) in the
    adaptive core and power_refine, a Python number assigned through the
    seed indices of the personalization matrix), and each copy
    synchronized the stream. They are made on the device now: these
    functions (and the adaptive loop, which `cpaa_adaptive_fixed` and the
    tick share) are hot code, and TL001 finds nothing unmarked in them."""

    @pytest.mark.parametrize("rel,func", [
        ("core/pagerank.py", "cpaa_adaptive_fixed"),
        ("core/pagerank.py", "cpaa_adaptive_loop"),
        ("core/pagerank.py", "power_refine"),
        ("serve/pagerank_service.py", "_personalization"),
    ])
    def test_the_copies_stay_out(self, rel, func):
        path = f"src/repro_torch/{rel}"
        src = (REPO / path).read_text()
        ctx = ModuleContext(path, src, LintConfig())
        nodes = [n for n in ast.walk(ctx.tree)
                 if isinstance(n, ast.FunctionDef) and n.name == func]
        assert len(nodes) == 1
        node = nodes[0]
        assert ctx.hot.info(node).hot
        inside = [f for f in lint_source(src, path=path).findings
                  if f.rule == "TL001"
                  and node.lineno <= f.line <= node.end_lineno]
        assert inside == []


class TestHotCode:
    # the reference modules whose jitted functions the port keeps under
    # the same names (LintConfig.hot_functions' first group)
    COUNTERPARTS = ("core/pagerank.py", "serve/pagerank_service.py")

    @pytest.mark.parametrize("rel", COUNTERPARTS)
    def test_hot_functions_cover_the_reference_traced_functions(self, rel):
        ref = ast.parse((REPO / "src" / "repro" / rel).read_text())
        traced = {fi.node.name for fi in jaxctx.analyze(ref).functions
                  if fi.traced}
        path = f"src/repro_torch/{rel}"
        ctx = ModuleContext(path, (REPO / path).read_text(), LintConfig())
        port_defs = {fi.node.name: fi for fi in ctx.hot.functions}
        shared = traced & set(port_defs)
        assert {"cpaa_fixed", "_solve_topk"} & shared
        cold = sorted(n for n in shared if not port_defs[n].hot)
        assert not cold, f"traced in the reference, not hot here: {cold}"

    def test_tick_path_and_capture_are_hot(self):
        for rel, names in (
                ("serve/pagerank_service.py",
                 ("tick", "_form_and_dispatch", "_harvest",
                  "_start_copy_to_host", "_to_device_async")),
                ("serve/engine.py", ("_decode_core",)),
                ("core/engine.py", ("apply", "cheb_round", "to_internal",
                                    "from_internal"))):
            path = f"src/repro_torch/{rel}"
            ctx = ModuleContext(path, (REPO / path).read_text(),
                                LintConfig())
            hot = {fi.node.name for fi in ctx.hot.functions if fi.hot}
            assert set(names) <= hot, (rel, set(names) - hot)


# -------------------------------------------------------------- framework --
def _pair(rule="TL001", path="src/x.py", line=3, code="y = x.cpu()"):
    return (Finding(rule=rule, path=path, line=line, col=4, message="m",
                    code=code),
            jcore.Finding(rule=rule, path=path, line=line, col=4,
                          message="m", code=code))


class TestFrameworkVsReference:
    @pytest.mark.parametrize("rule,path,code", [
        ("TL001", "src/repro_torch/a.py", "x = t.cpu()"),
        ("JL003", "src/repro/b.py", "  a =   np.zeros(3,   np.float64)  "),
        ("TL006", "c.py", ""),
    ])
    def test_equal_fingerprints(self, rule, path, code):
        port, ref = _pair(rule, path, 7, code)
        assert fingerprint(port) == jbl.fingerprint(ref)
        assert len(fingerprint(port)) == 16

    LINES = [
        "x = 1  # {m}: disable=R001 -- trailing",
        "# {m}: disable=R002,R003 -- own line covers the next",
        "y = 2",
        "z = 3  # {m}: disable=R004",
        "# {m}: disable-file=R005 -- whole file",
        "w = 4  # {m}: disable=R006,  R007 --",
        "v = 5  # other: disable=R008",
    ]

    def test_suppressions_match_with_the_marker_swapped(self):
        ref = [ln.format(m="jaxlint") for ln in self.LINES]
        port = [ln.format(m="torchlint") for ln in self.LINES]
        assert tcore.line_suppressions(port) == jcore.line_suppressions(ref)
        assert tcore.file_suppressions(port) == jcore.file_suppressions(ref)
        # each package reads only its own marker
        assert tcore.line_suppressions(ref) == {}
        assert jcore.line_suppressions(port) == {}

    @pytest.mark.parametrize("writer", ["port", "reference"])
    def test_baseline_written_by_either_loads_in_the_other(self, tmp_path,
                                                           writer):
        port_f, ref_f = _pair()
        entry = dict(rule="TL001", path="src/x.py",
                     fingerprint=fingerprint(port_f),
                     justification="test: a known host build", code=port_f.code,
                     line=3)
        p = tmp_path / "bl.json"
        if writer == "port":
            Baseline([BaselineEntry(**entry)]).save(p)
            other = jbl.Baseline.load(p)
            new, matched, stale = other.split([ref_f])
        else:
            jbl.Baseline([jbl.BaselineEntry(**entry)]).save(p)
            other = Baseline.load(p)
            new, matched, stale = other.split([port_f])
        assert not new and len(matched) == 1 and not stale
        assert [e.as_dict() for e in other.entries] == [entry]

    def test_todo_justification_rejected_like_the_reference(self, tmp_path):
        port_f, _ = _pair()
        p = tmp_path / "bl.json"
        Baseline([BaselineEntry(rule="TL001", path="src/x.py",
                                fingerprint=fingerprint(port_f),
                                justification=TODO_JUSTIFICATION)]).save(p)
        assert TODO_JUSTIFICATION == jbl.TODO_JUSTIFICATION
        for load in (Baseline.load, jbl.Baseline.load):
            with pytest.raises(ValueError, match="justification"):
                load(p)

    # one module both linters flag once, anywhere: np.asarray(dg.w)
    FLAGGED = "import numpy as np\n\n\ndef host(dg):\n    return np.asarray(dg.w)\n"
    CLEAN = "import numpy as np\n\n\ndef host(edges):\n    return np.asarray(edges)\n"

    def _both(self, tmp_path, capsys, src, extra=(), baseline=None):
        """(rc, stdout) of each CLI over one module with `src`."""
        out = {}
        for tag, run, prog in (("ref", jrunner.run, "jaxlint"),
                               ("port", runner.run, "torchlint")):
            root = tmp_path / tag
            root.mkdir(exist_ok=True)
            (root / "m.py").write_text(src)
            argv = ["m.py", "--root", str(root), *extra]
            if baseline is not None:
                (root / "bl.json").write_text(json.dumps(baseline))
                argv += ["--baseline", str(root / "bl.json")]
            rc = run(argv)
            text = capsys.readouterr().out.replace(prog + ":", "LINT:")
            out[tag] = (rc, text.replace("JL001", "R").replace("TL001", "R"))
        return out

    def test_clean_run(self, tmp_path, capsys):
        out = self._both(tmp_path, capsys, self.CLEAN, ["--no-baseline"])
        assert out["port"] == out["ref"]
        assert out["port"][0] == 0 and "LINT: 1 files, 0 new" in out["port"][1]

    def test_new_finding(self, tmp_path, capsys):
        out = self._both(tmp_path, capsys, self.FLAGGED, ["--no-baseline"])
        assert out["port"][0] == out["ref"][0] == 1
        assert out["port"][1].splitlines()[-1] == \
            out["ref"][1].splitlines()[-1] == \
            "LINT: 1 files, 1 new finding(s), 0 baselined, 0 suppressed inline"

    def test_stale_entry_under_strict(self, tmp_path, capsys):
        bl = {"version": 1, "findings": [
            {"rule": "R", "path": "gone.py", "fingerprint": "0" * 16,
             "justification": "was real once", "code": "", "line": 1}]}
        for strict, rc in ((["--strict"], 1), ([], 0)):
            out = self._both(tmp_path, capsys, self.CLEAN, strict, bl)
            assert out["port"] == out["ref"]
            assert out["port"][0] == rc
            assert "1 stale baseline entr(y/ies)" in out["port"][1]

    def test_bad_path_is_a_usage_error(self, tmp_path, capsys):
        for run in (jrunner.run, runner.run):
            assert run(["nope.py", "--root", str(tmp_path)]) == 2
        assert capsys.readouterr().err.count("no such path: nope.py") == 2

    def test_unknown_rule_is_refused(self):
        with pytest.raises(SystemExit, match="unknown rule"):
            runner.run(["--select", "JL001", "--root", str(REPO)])


class TestSelfLint:
    def test_port_is_clean_against_committed_baseline(self):
        results = lint_paths([PORT], root=REPO)
        assert not [e for r in results for e in r.errors]
        findings = [f for r in results for f in r.findings]
        bl = Baseline.load(REPO / "torchlint_baseline.json")
        new, _, stale = bl.split(findings)
        assert not new, "unbaselined findings:\n" + \
            "\n".join(f.format() for f in new)
        assert not stale, "stale baseline entries: " + \
            ", ".join(e.fingerprint for e in stale)

    def test_committed_baseline_entries_all_justified(self):
        bl = Baseline.load(REPO / "torchlint_baseline.json")
        assert bl.entries
        assert all(len(e.justification.split()) >= 3 for e in bl.entries)

    def test_cli_strict_exits_zero(self, capsys):
        assert runner.run(["--strict", "--root", str(REPO)]) == 0
        assert "0 new finding(s)" in capsys.readouterr().out

    def test_static_side_imports_no_torch(self):
        code = ("import sys, repro_torch.analysis, "
                "repro_torch.analysis.runner, repro_torch.analysis.rules, "
                "repro_torch.analysis.retrace, repro_torch.analysis.sanitize\n"
                "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
                "('torch', 'numpy', 'jax', 'repro'))\n"
                "print(bad)\nsys.exit(1 if bad else 0)\n")
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                             env={"PYTHONPATH": str(REPO / "src"),
                                  "PATH": "/usr/bin:/bin"},
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stdout + out.stderr


# --------------------------------------------------------------- sanitize --
class TestSanitizePlan:
    def test_committed_optouts_load(self):
        plan = sanitize.load_plan(REPO / sanitize.DEFAULT_OPTOUTS_FILE)
        assert plan.defaults == {"debug_nans": True,
                                 "sync_debug_mode": "warn",
                                 "detect_anomaly": False}
        assert set(plan.defaults) == set(sanitize.FLAGS)

    def test_missing_file_falls_back(self, tmp_path):
        plan = sanitize.load_plan(tmp_path / "none.json")
        assert plan.defaults == sanitize.FALLBACK_DEFAULTS

    def test_module_override_layering(self):
        plan = sanitize.SanitizePlan(
            {"debug_nans": True, "sync_debug_mode": "warn"},
            {"tests.test_x": {"debug_nans": False, "reason": "r"}})
        assert plan.flags_for("tests.test_x") == {
            "debug_nans": False, "sync_debug_mode": "warn"}
        assert plan.flags_for("tests.test_y")["debug_nans"] is True

    def test_optout_without_reason_rejected(self, tmp_path):
        p = tmp_path / "s.json"
        p.write_text(json.dumps({"version": 1, "defaults": {},
                                 "modules": {"m": {"debug_nans": False}}}))
        with pytest.raises(ValueError, match="reason"):
            sanitize.load_plan(p)

    def test_version_mismatch_rejected(self, tmp_path):
        p = tmp_path / "s.json"
        p.write_text(json.dumps({"version": 2}))
        with pytest.raises(ValueError, match="version"):
            sanitize.load_plan(p)


def _nan_op():
    return torch.zeros(2) / torch.zeros(2)


class TestSanitizeRuntime:
    def test_nan_mode_names_the_op(self):
        with pytest.raises(FloatingPointError, match="aten.div"):
            with sanitize.applied({"debug_nans": True}):
                _nan_op()

    def test_finite_ops_pass(self):
        with sanitize.applied({"debug_nans": True}) as ctx:
            y = torch.ones(3) / 2
            assert ctx.nan_mode is not None
        assert torch.equal(y, torch.full((3,), 0.5))

    def test_applied_restores_flags(self):
        before = torch.is_anomaly_enabled()
        with sanitize.applied({"debug_nans": True,
                               "detect_anomaly": not before,
                               "sync_debug_mode": "warn"}):
            assert torch.is_anomaly_enabled() is (not before)
        assert torch.is_anomaly_enabled() is before
        assert torch.isnan(_nan_op()).all()     # the mode is gone

    def test_restores_after_an_error(self):
        before = torch.is_anomaly_enabled()
        with pytest.raises(FloatingPointError):
            with sanitize.applied({"debug_nans": True,
                                   "detect_anomaly": not before}):
                _nan_op()
        assert torch.is_anomaly_enabled() is before
        assert torch.isnan(_nan_op()).all()

    def test_unknown_flag_refused(self):
        with pytest.raises(ValueError, match="jax_debug_nans"):
            sanitize.applied({"jax_debug_nans": True})

    def test_integer_outputs_are_not_checked(self):
        with sanitize.applied({"debug_nans": True}):
            idx = torch.arange(4).argsort()
        assert idx.dtype == torch.int64


class TestPytestPlugin:
    def _pytest(self, *args, cwd=REPO):
        env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
                   JAX_PLATFORMS="cpu")
        return subprocess.run(
            [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
             "-p", "no:randomly", "-p", "repro_torch.analysis.pytest_plugin",
             "--torch-sanitize", *args],
            cwd=cwd, env=env, capture_output=True, text=True, timeout=120)

    def test_engine_cases_pass_sanitized(self):
        out = self._pytest("tests/test_torch_engine.py", "-k",
                           "TestEngines")
        assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
        assert " passed" in out.stdout

    def test_the_mode_is_live(self, tmp_path):
        (tmp_path / "test_nan.py").write_text(
            "import torch\n\n"
            "def test_nan():\n"
            "    torch.zeros(1) / torch.zeros(1)\n\n"
            "def test_gate(torch_retrace_gate):\n"
            "    from repro_torch.analysis.retrace import RetraceGate\n"
            "    assert torch_retrace_gate is RetraceGate\n")
        out = self._pytest(str(tmp_path / "test_nan.py"), cwd=tmp_path)
        assert out.returncode == 1, out.stdout[-3000:]
        assert "FloatingPointError" in out.stdout
        assert "1 failed, 1 passed" in out.stdout


# ---------------------------------------------------------------- retrace --
class TestRetraceGate:
    def test_quiet_without_compiles(self):
        with retrace.RetraceGate() as gate:
            pass
        assert gate.events == []

    def test_trips_with_a_new_signature(self):
        compile_log.record_compile("warm", "[8, 1] int64")
        with pytest.raises(retrace.RetraceError) as ei:
            with retrace.RetraceGate():
                compile_log.record_compile("fresh", "[3, 1] int64")
        msg = str(ei.value)
        assert "fresh: [3, 1] int64" in msg and "NEW signature" in msg
        assert "warmup signatures" in msg

    def test_names_a_repeat_of_a_warm_signature(self):
        compile_log.record_compile("again", "build")
        with pytest.raises(retrace.RetraceError,
                           match="already compiled during warmup"):
            with retrace.RetraceGate():
                compile_log.record_compile("again", "build")

    def test_allowed_tolerates_that_many(self):
        with retrace.RetraceGate(allowed=2) as gate:
            compile_log.record_compile("a", "build")
            compile_log.record_compile("b", "build")
        assert [n for n, _ in gate.events] == ["a", "b"]
        with pytest.raises(retrace.RetraceError, match="allowed 1"):
            with retrace.RetraceGate(allowed=1):
                compile_log.record_compile("a", "build")
                compile_log.record_compile("b", "build")

    def test_the_compiling_layers_do_not_load_the_analysis_package(self):
        """The build and serving layers append to `repro_torch.compile_log`;
        only the gate, above them, reads it."""
        code = ("import sys\n"
                "import repro_torch.kernels._build, repro_torch.serve.engine\n"
                "print(sorted(m for m in sys.modules\n"
                "             if m.startswith('repro_torch.analysis')))\n")
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                             env={**os.environ,
                                  "PYTHONPATH": str(REPO / "src")},
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert out.stdout.strip() == "[]"

    def test_ppr_bucket_change_is_quiet(self):
        """By design the port diverges from the reference's
        test_gate_trips_on_batch_bucket_change: a new batch bucket traces
        a fresh solve in the reference and compiles nothing in the port.
        Both services answer the same queries."""
        def queries(make):
            return [make(qid=100, graph="g", seeds=(1,), top_k=5),
                    make(qid=101, graph="g", seeds=(2,), top_k=5)]

        reg = GraphRegistry(device="cpu")
        reg.register("g", generators.tri_mesh(13, 17))
        svc = PageRankService(reg, max_batch=8)
        svc.query("g", seeds=(0,), top_k=5)       # warm bucket 1 only
        with retrace.RetraceGate() as gate:
            for q in queries(PPRQuery):
                svc.submit(q)
            out = svc.run_until_drained()
        assert gate.events == [] and svc.stats["solves"] == 2

        jreg = JRegistry()
        jreg.register("g", jgen.tri_mesh(13, 17))
        jsvc = JService(jreg, max_batch=8)
        jsvc.query("g", seeds=(0,), top_k=5)
        for q in queries(JQuery):
            jsvc.submit(q)
        ref = jsvc.run_until_drained()
        for qid in (100, 101):
            np.testing.assert_allclose(out[qid].scores, ref[qid].scores,
                                       rtol=1e-5, atol=1e-7)
