"""Guards on the port's boundaries.

* `src/repro_torch/` and `chip_smoke.py` import neither `jax` nor the JAX
  package `repro` (an AST walk, and a fresh interpreter's sys.modules);
* entry points called without `device` run on CUDA, so on a host without a
  GPU they raise instead of carrying on quietly on the CPU.
"""
import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"


def _port_files():
    files = sorted(PORT.rglob("*.py"))
    assert len(files) >= 16
    return files + [REPO / "chip_smoke.py"]


def _imported_modules(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    mods = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.extend(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.append(node.module or "")
        elif isinstance(node, ast.Call) and \
                getattr(node.func, "id", None) == "__import__" and \
                node.args and isinstance(node.args[0], ast.Constant):
            mods.append(str(node.args[0].value))
    return mods


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    for mod in _imported_modules(path):
        root = mod.split(".")[0]
        assert root not in ("jax", "jaxlib", "repro"), (path, mod)


def test_fresh_import_leaves_jax_and_reference_out():
    code = ("import sys, repro_torch.configs.pagerank_serve, "
            "repro_torch.launch.serve, repro_torch.interop, "
            "repro_torch.kernels.bsr_spmm.ops, "
            "repro_torch.kernels.cheb_step.ops, "
            "repro_torch.kernels.embedding_bag.ops, "
            "repro_torch.models.recsys.dlrm, repro_torch.configs.dlrm_rm2, "
            "repro_torch.train.data, repro_torch.topk\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env={"PYTHONPATH": str(REPO / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


class TestDefaultDeviceIsCuda:
    def test_make_service(self, no_gpu):
        from repro_torch.configs import pagerank_serve
        with pytest.raises(RuntimeError, match="CUDA"):
            pagerank_serve.make_service(pagerank_serve.smoke_config())

    def test_registry(self, no_gpu):
        from repro_torch.serve.graph_registry import GraphRegistry
        with pytest.raises(RuntimeError, match="CUDA"):
            GraphRegistry()

    def test_select_engine(self, no_gpu):
        from repro_torch.core.engine import select_engine
        from repro_torch.graph.generators import tri_mesh
        for mode in ("auto", "coo", "fused"):
            with pytest.raises(RuntimeError, match="CUDA"):
                select_engine(tri_mesh(20, 20), mode=mode)

    def test_solvers_and_device_graph(self, no_gpu):
        from repro_torch.core.pagerank import cpaa, cpaa_adaptive
        from repro_torch.graph.generators import caveman
        from repro_torch.graph.ops import device_graph
        g = caveman(5, 4)
        for fn in (cpaa, cpaa_adaptive, device_graph):
            with pytest.raises(RuntimeError, match="CUDA"):
                fn(g)

    def test_interop(self, no_gpu):
        import numpy as np
        from repro_torch import interop
        with pytest.raises(RuntimeError, match="CUDA"):
            interop.coeffs_tensor(np.ones(3))

    def test_dlrm_params(self, no_gpu):
        from repro_torch.configs import dlrm_rm2
        from repro_torch.models.recsys import dlrm
        with pytest.raises(RuntimeError, match="CUDA"):
            dlrm.init_params(dlrm_rm2.smoke_config())

    def test_dlrm_batches(self, no_gpu):
        from repro_torch.configs import dlrm_rm2
        from repro_torch.train.data import RecsysPipelineConfig, recsys_batch
        with pytest.raises(RuntimeError, match="CUDA"):
            dlrm_rm2.make_batch(dlrm_rm2.smoke_config(), 4, seed=0)
        with pytest.raises(RuntimeError, match="CUDA"):
            recsys_batch(RecsysPipelineConfig((5, 7), 13, 1, 4), 0)

    def test_dlrm_interop(self, no_gpu):
        import numpy as np
        from repro_torch import interop
        layer = {"w": np.ones((2, 2), np.float32), "b": np.zeros(2, np.float32)}
        with pytest.raises(RuntimeError, match="CUDA"):
            interop.dlrm_params({"table": np.zeros((4, 2), np.float32),
                                 "bot": [layer], "top": [layer]})

    def test_launcher(self, no_gpu):
        from repro_torch.launch import serve
        with pytest.raises(RuntimeError, match="CUDA"):
            serve.main(["--arch", "pagerank-serve", "--smoke",
                        "--requests", "2"])

    def test_explicit_cpu_still_runs(self, no_gpu):
        from repro_torch.core.pagerank import cpaa
        from repro_torch.graph.generators import caveman
        assert cpaa(caveman(5, 4), device="cpu").pi.device.type == "cpu"

    def test_explicit_cpu_dlrm_still_runs(self, no_gpu):
        from repro_torch.configs import dlrm_rm2
        from repro_torch.models.recsys import dlrm
        cfg = dlrm_rm2.smoke_config()
        params = dlrm.init_params(cfg, device="cpu")
        batch = dlrm_rm2.make_batch(cfg, 4, device="cpu")
        assert dlrm.serve_step(params, batch, cfg).device.type == "cpu"
