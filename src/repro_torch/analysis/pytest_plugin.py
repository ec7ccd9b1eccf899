"""pytest wiring for the runtime tier: `--torch-sanitize` + RetraceGate.

    pytest -p repro_torch.analysis.pytest_plugin --torch-sanitize tests/...

`--torch-sanitize` turns on the port's runtime checkers (the NaN dispatch
mode, CUDA sync debug warnings, optionally autograd anomaly detection) for
the whole run — the runtime twin of the torchlint rules. Flag defaults and
per-module opt-outs (each with a mandatory reason) live in
`torch_sanitize_optouts.json` at the pytest root directory. The plugin is
loaded with `-p` because the suite's conftest belongs to the reference.
"""
from __future__ import annotations

import pytest

from repro_torch.analysis import sanitize


def pytest_addoption(parser):
    parser.addoption(
        "--torch-sanitize", action="store_true", default=False,
        help="run with the port's runtime checkers on (NaN dispatch mode, "
             "CUDA sync debug mode, anomaly detection); per-module "
             "opt-outs in torch_sanitize_optouts.json")


def pytest_configure(config):
    if not config.getoption("--torch-sanitize"):
        return
    plan = sanitize.load_plan(config.rootpath /
                              sanitize.DEFAULT_OPTOUTS_FILE)
    config._torch_sanitize_plan = plan


@pytest.fixture(autouse=True, scope="module")
def _torch_sanitize_module_flags(request):
    """Apply the plan's flags for this module (defaults layered with its
    opt-outs), restored when the module's tests are done."""
    plan = getattr(request.config, "_torch_sanitize_plan", None)
    if plan is None:
        yield
        return
    with sanitize.applied(plan.flags_for(request.module.__name__)):
        yield


@pytest.fixture
def torch_retrace_gate():
    """The RetraceGate class: `with torch_retrace_gate(): ...` asserts zero
    compiles (CUDA graph captures, nvcc builds) inside."""
    from repro_torch.analysis.retrace import RetraceGate

    return RetraceGate
