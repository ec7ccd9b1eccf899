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
            "repro_torch.graph.datasets, repro_torch.serve.scheduler, "
            "repro_torch.kernels.bsr_spmm.ops, "
            "repro_torch.kernels.cheb_step.ops, "
            "repro_torch.kernels.embedding_bag.ops, "
            "repro_torch.kernels.attention.ops, "
            "repro_torch.kernels.attention.ref, "
            "repro_torch.models.recsys.dlrm, repro_torch.configs.dlrm_rm2, "
            "repro_torch.train.data, repro_torch.topk, repro_torch.obs, "
            "repro_torch.obs.metrics, repro_torch.obs.trace, "
            "repro_torch.obs.convergence, repro_torch.obs.export, "
            "repro_torch.core.autotune, repro_torch.core.orthopoly, "
            "repro_torch.core.distributed, repro_torch.graph.partition, "
            "repro_torch.configs.pagerank_cpaa, "
            "repro_torch.core, repro_torch.serve, "
            "repro_torch.models.layers, repro_torch.models.gnn.common, "
            "repro_torch.models.gnn.meshgraphnet, "
            "repro_torch.models.gnn.pna, repro_torch.models.gnn.dimenet, "
            "repro_torch.models.gnn.graphcast, repro_torch.graph.sampler, "
            "repro_torch.train.optimizer, repro_torch.train.train_loop, "
            "repro_torch.train.checkpoint, repro_torch.configs.gnn_common, "
            "repro_torch.configs.meshgraphnet, repro_torch.configs.pna, "
            "repro_torch.configs.dimenet, repro_torch.configs.graphcast, "
            "repro_torch.launch.train_gnn, repro_torch.models.moe, "
            "repro_torch.models.transformer, repro_torch.serve.engine, "
            "repro_torch.configs.lm_common, "
            "repro_torch.configs.h2o_danube_1_8b, "
            "repro_torch.configs.granite_moe_3b, "
            "repro_torch.configs.deepseek_7b, "
            "repro_torch.configs.qwen2_5_32b, "
            "repro_torch.configs.qwen3_moe_235b, "
            "repro_torch.launch.train, repro_torch.train.grad_compress, "
            "repro_torch.distributed, repro_torch.distributed.sharding, "
            "repro_torch.configs.base, repro_torch.configs.registry, "
            "repro_torch.launch.mesh, repro_torch.launch.analysis, "
            "repro_torch.launch.dryrun, repro_torch.launch.roofline, "
            "repro_torch.kernels.cost, repro_torch.analysis, "
            "repro_torch.analysis.runner, repro_torch.analysis.sanitize, "
            "repro_torch.analysis.retrace, repro_torch.compile_log, "
            "repro_torch.analysis.pytest_plugin, "
            "repro_torch.launch.quickstart, "
            "repro_torch.launch.serve_pagerank, repro_torch.launch.serve_lm, "
            "repro_torch.launch.distributed_pagerank\n"
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

    def test_update_path_entry_points(self, no_gpu):
        import numpy as np
        from repro_torch import interop
        from repro_torch.core.engine import HubTailEngine
        from repro_torch.graph.datasets import chung_lu
        from repro_torch.graph.ops import EdgeSlots
        g = chung_lu(500, seed=0)
        with pytest.raises(RuntimeError, match="CUDA"):
            HubTailEngine.from_graph(g)
        with pytest.raises(RuntimeError, match="CUDA"):
            EdgeSlots.from_graph(g).to_device()
        z = np.zeros(0, np.int32)
        with pytest.raises(RuntimeError, match="CUDA"):
            interop.hub_tail_engine(np.ones(4), z, z, z.reshape(0, 32), z, z,
                                    n=4)

    def test_tuner_and_solvers(self, no_gpu, tmp_path):
        from repro_torch.core.autotune import Autotuner, TuningStore
        from repro_torch.core.engine import select_engine
        from repro_torch.core.pagerank import forward_push, power
        from repro_torch.graph.generators import caveman
        g = caveman(5, 4)
        tuner = Autotuner(TuningStore(tmp_path / "t.json"))
        with pytest.raises(RuntimeError, match="CUDA"):
            tuner.tune(g, 8)
        with pytest.raises(RuntimeError, match="CUDA"):
            select_engine(g, mode="tuned", tuner=tuner)
        for fn in (power, forward_push):
            with pytest.raises(RuntimeError, match="CUDA"):
                fn(g)

    def test_sharded_entry_points(self, no_gpu):
        import numpy as np
        from repro_torch import interop
        from repro_torch.configs import pagerank_cpaa
        from repro_torch.core import distributed
        from repro_torch.core.engine import (Sharded1DEngine,
                                             Sharded2DEngine, select_engine)
        from repro_torch.graph.generators import tri_mesh
        g = tri_mesh(9, 11)
        for fn in (lambda: distributed.init_mesh((1,), ("dev",)),
                   lambda: distributed.init_process_group(),
                   lambda: Sharded1DEngine.from_graph(g),
                   lambda: Sharded2DEngine.from_graph(g),
                   lambda: select_engine(g, mode="sharded_1d"),
                   lambda: select_engine(g, mode="sharded-2d"),
                   lambda: pagerank_cpaa.smoke_run()):
            with pytest.raises(RuntimeError, match="CUDA"):
                fn()
        z = np.zeros((1, 4), np.int32)
        with pytest.raises(RuntimeError, match="CUDA"):
            interop.sharded_1d_engine(z, z, z.astype(np.float32), 4, 4, 4)
        with pytest.raises(RuntimeError, match="CUDA"):
            interop.sharded_2d_engine(z[None], z[None],
                                      z[None].astype(np.float32), None, 4,
                                      4, 4)

    def test_launcher(self, no_gpu):
        from repro_torch.launch import serve
        with pytest.raises(RuntimeError, match="CUDA"):
            serve.main(["--arch", "pagerank-serve", "--smoke",
                        "--requests", "2"])

    @pytest.mark.parametrize("arch", ["meshgraphnet", "pna", "dimenet",
                                      "graphcast"])
    def test_gnn_smoke_run(self, no_gpu, arch):
        import importlib
        cfg_mod = importlib.import_module(f"repro_torch.configs.{arch}")
        with pytest.raises(RuntimeError, match="CUDA"):
            cfg_mod.smoke_run(seed=0)
        with pytest.raises(RuntimeError, match="CUDA"):
            cfg_mod.make_batch(cfg_mod.smoke_config(),
                               dict(n=8, e=16, d_feat=12))

    def test_gnn_training_entry_points(self, no_gpu):
        import numpy as np
        from repro_torch import interop
        from repro_torch.graph.generators import caveman
        from repro_torch.launch import train_gnn
        from repro_torch.train.data import GraphBatchPipeline
        g = caveman(5, 4)
        z = np.zeros((g.n, 2), np.float32)
        for fn in (lambda: train_gnn.run(steps=2, batch_nodes=4),
                   lambda: train_gnn.main(["--steps", "2"]),
                   lambda: train_gnn.pagerank_task(g),
                   lambda: GraphBatchPipeline(g, z, z, 4, (2,)),
                   lambda: interop.gnn_params({"w": np.ones(2)})):
            with pytest.raises(RuntimeError, match="CUDA"):
                fn()

    def test_lm_entry_points(self, no_gpu):
        import numpy as np
        from repro_torch import interop
        from repro_torch.configs import h2o_danube_1_8b
        from repro_torch.launch import serve
        from repro_torch.models import transformer as tf
        from repro_torch.serve.engine import ServeEngine
        cfg = h2o_danube_1_8b.smoke_config()
        params = tf.init_params(torch.Generator().manual_seed(0), cfg)
        for fn in (lambda: ServeEngine(params, cfg, 2, 16),
                   lambda: tf.make_kv_cache(cfg, 2, 16),
                   lambda: interop.lm_params({"w": np.ones(2, np.float32)}),
                   lambda: serve.main(["--arch", "h2o-danube-1.8b",
                                       "--smoke", "--requests", "1"])):
            with pytest.raises(RuntimeError, match="CUDA"):
                fn()

    def test_explicit_cpu_lm_still_runs(self, no_gpu):
        import numpy as np
        from repro_torch import interop
        from repro_torch.configs import granite_moe_3b
        from repro_torch.launch import serve
        from repro_torch.models import transformer as tf
        from repro_torch.serve.engine import Request, ServeEngine
        cfg = granite_moe_3b.smoke_config()
        params = tf.init_params(torch.Generator().manual_seed(0), cfg)
        eng = ServeEngine(params, cfg, 2, 16, device="cpu")
        req = Request(rid=0, prompt=np.arange(4, dtype=np.int32),
                      max_new_tokens=2)
        eng.run_until_drained([req])
        assert req.done and eng.kv[0].device.type == "cpu"
        w = interop.lm_params({"w": np.ones(2, np.float32)}, device="cpu")
        assert w["w"].device.type == "cpu"
        out = serve.main(["--arch", "granite-moe-3b-a800m", "--smoke",
                          "--requests", "1", "--device", "cpu"])
        assert out["requests"] == 1

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
