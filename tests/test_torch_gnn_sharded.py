"""The port's partitioned GNN steps and rank-local CPAA steps against the
JAX reference run unsharded.

The production plans shard a GNN batch's node and edge arrays over every
mesh axis where their count tiles 256 (512 on two pods) and leave the
others whole (`gnn_batch_specs`); GSPMD computes the same function as one
device, so the reference runs here on one CPU device, and the port runs
SPMD on spawned gloo groups (tests/torch_gnn_worker.py) over the meshes
(1, 2), (2, 2), (2, 4), the uneven (1, 3) (512 nodes as 171, 171, 170
rows and 2,048 edges as 683, 683, 682: the padding edge has sender and
receiver 0) and the multi-pod (2, 2, 2) over ("pod", "data", "model"),
one mesh at a time. Every mesh runs the four GNNs at smoke width on 512
nodes and 2,048 edges (all sharded); the (2, 2, 2) mesh also runs them on
768 nodes, which do not tile 512 and stay whole beside the sharded edges
(GraphCast: a whole grid beside the sharded mesh and edge sets). The
reference's parameters are carried across by `interop.gnn_params`.

Tolerances are `test_torch_tensor_parallel.py`'s: the loss rtol 1e-5;
every gradient leaf rtol 1e-4 / atol 1e-6 (atol scaled by the leaf's
largest |value| where that is above 1, as tests/test_torch_gnn.py
scales it: DimeNet's smoke gradients reach 1e5); one AdamW step's
parameters, m and v rtol 1e-5 (atol 1e-7), with the rule for entries
whose first moment is tiny.

The same groups run the rank-local CPAA steps (`cpaa_local_1d` /
`_2d`) on (2, 2), (1, 3) and (2, 2, 2) (grid (4, 2) on the view that
flattens ("pod", "data")) on tri_mesh(23, 31): the gathered pi is held to
the reference's single-device `cpaa_fixed` at L1 <= 1e-5 per column, for
a uniform p (B = 1) and four one-hot columns (B = 4).
"""
import dataclasses
import os
import subprocess
import sys
import threading
import time
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_gnn_worker as W
from repro.configs import dimenet as j_dimenet_cfg
from repro.configs import graphcast as j_graphcast_cfg
from repro.configs import meshgraphnet as j_mgn_cfg
from repro.configs import pna as j_pna_cfg
from repro.core import pagerank as j_pagerank
from repro.core.chebyshev import make_schedule as j_make_schedule
from repro.graph import ops as j_ops
from repro.graph.generators import tri_mesh as j_tri_mesh
from repro.models.gnn import dimenet as j_dimenet
from repro.models.gnn import graphcast as j_graphcast
from repro.models.gnn import meshgraphnet as j_mgn
from repro.models.gnn import pna as j_pna
from repro.train import optimizer as ref_opt

HERE = Path(__file__).resolve().parent
SRC = HERE.parent / "src"
MESHES = [(1, 2), (2, 2), (2, 4), (1, 3), (2, 2, 2)]
MESH_IDS = ["x".join(map(str, m)) for m in MESHES]
CPAA_MESHES = [(2, 2), (1, 3), (2, 2, 2)]
CPAA_IDS = ["x".join(map(str, m)) for m in CPAA_MESHES]
ARCHS = list(W.ARCHS)
SIZES = {"even": dict(n=512, e=2048, d_feat=12, note="smoke"),
         "mixed": dict(n=768, e=2048, d_feat=12, note="smoke")}
MIXED_MESH = (2, 2, 2)
LOSS = dict(rtol=1e-5, atol=0)
GRAD = dict(rtol=1e-4, atol=1e-6)
STATE = dict(rtol=1e-5, atol=1e-7)
CPAA_L1 = 1e-5
G_STABLE = 1e-6           # |g| from which AdamW's update is stable
TINY_SHARE = 0.5
TIMEOUT = 600.0

# arch -> (reference module, config module, reference init)
REF = {
    "meshgraphnet": (j_mgn, j_mgn_cfg, j_mgn.init_params),
    "pna": (j_pna, j_pna_cfg, j_pna.init_params),
    "dimenet": (j_dimenet, j_dimenet_cfg, j_dimenet.init_params),
    "graphcast": (j_graphcast, j_graphcast_cfg,
                  partial(j_graphcast_cfg._init, d_in=12)),
}


def _ref_config(arch: str):
    cfg_mod = REF[arch][1]
    return type(cfg_mod.smoke_config())(
        **dataclasses.asdict(W.ARCHS[arch][1]))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _gnn_inputs(arch: str, size: str, seed: int) -> dict:
    """The reference's parameters and batch of one case (numpy)."""
    _, cfg_mod, init = REF[arch]
    cfg = _ref_config(arch)
    make = partial(cfg_mod.make_batch, d_in=12) if arch == "graphcast" \
        else cfg_mod.make_batch
    params = _np_tree(init(jax.random.PRNGKey(seed), cfg))
    batch = {k: np.asarray(v) for k, v in
             make(cfg, SIZES[size], seed=seed, abstract=False).items()}
    return {"params": params, "p": W.flatten(params), "b": batch}


def _gnn_expected(arch: str, inputs: dict) -> dict:
    """The reference's loss, gradients and one AdamW step of one case,
    unsharded."""
    mod = REF[arch][0]
    cfg = _ref_config(arch)
    params = inputs["params"]
    jb = {k: jnp.asarray(v) for k, v in inputs["b"].items()}
    loss, grads = jax.value_and_grad(mod.loss_fn)(params, jb, cfg)
    opt = ref_opt.AdamWConfig(lr=W.LR)
    new_p, new_s, metrics = ref_opt.adamw_update(
        grads, ref_opt.adamw_init(params, opt), params, opt)
    want = {"loss": loss, "step/grad_norm": metrics["grad_norm"]}
    for name, tree in (("grad", grads), ("params", new_p),
                       ("m", new_s["m"]), ("v", new_s["v"])):
        want.update({f"{name}/{k}": v
                     for k, v in W.flatten(_np_tree(tree)).items()})
    return {k: np.asarray(v) for k, v in want.items()}


def _cpaa_reference():
    """(personalizations, {name: the reference's pi})."""
    g = j_tri_mesh(23, 31)
    rng = np.random.default_rng(5)
    ps = {"b1": np.full(g.n, 1.0 / g.n, np.float32),
          "b4": np.zeros((g.n, 4), np.float32)}
    ps["b4"][rng.integers(0, g.n, 4), np.arange(4)] = 1.0
    sched = j_make_schedule(W.CPAA_C, rounds=W.CPAA_ROUNDS)
    dg = j_ops.device_graph(g)
    coeffs = jnp.asarray(sched.coeffs, jnp.float32)
    want = {k: np.asarray(j_pagerank.cpaa_fixed(dg, coeffs, jnp.asarray(p),
                                                rounds=sched.rounds)[0])
            for k, p in ps.items()}
    return ps, want


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra) -> dict:
    return dict(os.environ, OMP_NUM_THREADS="1",
                PYTHONPATH=os.pathsep.join(
                    [str(SRC), str(HERE), os.environ.get("PYTHONPATH", "")]),
                **extra)


def _run_group(in_dir: Path, out_dir: Path, shape: tuple) -> None:
    ws = int(np.prod(shape))
    tag = "x".join(map(str, shape))
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(HERE / "torch_gnn_worker.py"), str(in_dir),
         str(out_dir), tag],
        env=_env(RANK=str(r), WORLD_SIZE=str(ws), LOCAL_RANK=str(r),
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(ws)]
    t0, errs = time.perf_counter(), []
    for r, p in enumerate(procs):
        try:
            _, err = p.communicate(
                timeout=max(1.0, TIMEOUT - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise AssertionError(f"mesh {tag}: rank {r} timed out")
        if p.returncode != 0:
            errs.append(f"mesh {tag} rank {r} rc {p.returncode}\n"
                        f"{err[-4000:]}")
    assert not errs, "\n".join(errs)


def _save(path: Path, inputs: dict) -> None:
    np.savez(path, **{f"p/{k}": v for k, v in inputs["p"].items()},
             **{f"b/{k}": v for k, v in inputs.get("b", {}).items()})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(expected, get): the reference's results per (arch, size) and
    "cpaa", and get(mesh, case) -> the port's on that mesh. The inputs
    are made first; then the meshes' groups run one after another (at
    most 8 processes alive) in a thread while this one computes the
    reference's results."""
    tmp = tmp_path_factory.mktemp("gnn")
    inputs = {(arch, size): _gnn_inputs(arch, size, seed)
              for seed, arch in enumerate(ARCHS) for size in SIZES}
    ps, want_cpaa = _cpaa_reference()
    outs, errors = {}, {}
    for shape in MESHES:
        tag = "x".join(map(str, shape))
        in_dir, outs[shape] = tmp / f"in{tag}", tmp / f"m{tag}"
        in_dir.mkdir()
        outs[shape].mkdir()
        sizes = ["even"] + (["mixed"] if shape == MIXED_MESH else [])
        for arch in ARCHS:
            for size in sizes:
                _save(in_dir / f"gnn_{arch}_{size}.npz",
                      inputs[(arch, size)])
        if shape in CPAA_MESHES:
            _save(in_dir / "cpaa.npz", {"p": ps})

    def run_all():
        for shape in MESHES:
            tag = "x".join(map(str, shape))
            try:
                _run_group(tmp / f"in{tag}", outs[shape], shape)
            except AssertionError as e:
                errors[shape] = str(e)

    groups = threading.Thread(target=run_all)
    groups.start()
    try:
        expected = {key: _gnn_expected(key[0], inp)
                    for key, inp in inputs.items()}
    finally:
        groups.join()
    expected["cpaa"] = want_cpaa

    def get(shape, case):
        assert shape not in errors, errors[shape]
        name = "cpaa.npz" if case == "cpaa" else \
            f"gnn_{case[0]}_{case[1]}.npz"
        with np.load(outs[shape] / name) as z:
            return {k: z[k] for k in z.files}
    return expected, get


def _close(got: dict, want: dict, prefix: str, tol: dict) -> None:
    keys = sorted(k for k in want if k.startswith(prefix))
    assert keys and sorted(k for k in got if k.startswith(prefix)) == keys
    for k in keys:
        scale = max(1.0, float(np.abs(want[k]).max())) if want[k].size \
            else 1.0
        np.testing.assert_allclose(got[k], want[k], err_msg=k,
                                   rtol=tol["rtol"],
                                   atol=tol["atol"] * scale)


def _check_params(got: dict, want: dict) -> None:
    """The stepped parameters at STATE, except where AdamW's update is
    unstable (0 < |m| < 0.1 G_STABLE: sqrt(v_hat) near eps, so sums of
    another order move the entry by up to the learning rate); at most
    TINY_SHARE of a leaf may be such, and there the step is held within
    LR (tests/test_torch_tensor_parallel.py's rule)."""
    keys = sorted(k for k in want if k.startswith("params/"))
    assert keys and sorted(k for k in got if k.startswith("params/")) == keys
    for k in keys:
        leaf = k[len("params/"):]
        m_ref = np.abs(want["m/" + leaf])
        tiny = (m_ref > 0) & (m_ref < 0.1 * G_STABLE)
        assert tiny.mean() <= TINY_SHARE, (k, tiny.mean())
        np.testing.assert_allclose(got[k][~tiny], want[k][~tiny], err_msg=k,
                                   **STATE)
        assert np.all(np.abs(got[k] - want[k])[tiny] <= W.LR), k


def _check_step(got: dict, want: dict) -> None:
    _check_params(got, want)
    for part in ("m/", "v/"):
        _close(got, want, part, STATE)
    np.testing.assert_allclose(got["step/grad_norm"], want["step/grad_norm"],
                               rtol=1e-5)
    np.testing.assert_allclose(got["step/loss"], want["loss"], **LOSS)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
class TestShardedGNN:
    def test_loss(self, runs, shape, arch):
        want, get = runs
        got = get(shape, (arch, "even"))
        # every node and edge leaf tiles the spec rule: all sharded
        assert "node_mask" in got["sharded"] or "grid_feat" in got["sharded"]
        np.testing.assert_allclose(got["loss"], want[(arch, "even")]["loss"],
                                   **LOSS)

    def test_gradient_leaves(self, runs, shape, arch):
        want, get = runs
        _close(get(shape, (arch, "even")), want[(arch, "even")], "grad/",
               GRAD)

    def test_adamw_step(self, runs, shape, arch):
        want, get = runs
        _check_step(get(shape, (arch, "even")), want[(arch, "even")])


@pytest.mark.parametrize("arch", ARCHS)
class TestWholeBesideSharded:
    """768 nodes on the (2, 2, 2) mesh: the node (grid) leaves stay whole,
    the edge leaves (and GraphCast's mesh nodes) are sharded; gathers
    from the whole set are local and scatters into it all-reduce."""

    def test_loss_and_layout(self, runs, arch):
        want, get = runs
        got = get(MIXED_MESH, (arch, "mixed"))
        sharded = set(got["sharded"].tolist())
        node_key = "grid_feat" if arch == "graphcast" else "node_feat"
        assert node_key not in sharded and "node_mask" not in sharded
        assert any(k.endswith("senders") for k in sharded), sharded
        np.testing.assert_allclose(got["loss"],
                                   want[(arch, "mixed")]["loss"], **LOSS)

    def test_gradient_leaves(self, runs, arch):
        want, get = runs
        _close(get(MIXED_MESH, (arch, "mixed")), want[(arch, "mixed")],
               "grad/", GRAD)

    def test_adamw_step(self, runs, arch):
        want, get = runs
        _check_step(get(MIXED_MESH, (arch, "mixed")), want[(arch, "mixed")])


@pytest.mark.parametrize("b", ["b1", "b4"])
@pytest.mark.parametrize("partition", ["1d", "2d"])
@pytest.mark.parametrize("shape", CPAA_MESHES, ids=CPAA_IDS)
def test_rank_local_cpaa_matches_the_reference(runs, shape, partition, b):
    want, get = runs
    got = get(shape, "cpaa")
    if shape == (2, 2, 2):
        assert got["grid"].tolist() == [4, 2]
    pi, ref = got[f"{partition}/{b}"], want["cpaa"][b]
    assert pi.shape == ref.shape
    l1 = np.abs(pi - ref).sum(axis=0)
    assert np.all(l1 <= CPAA_L1), l1
