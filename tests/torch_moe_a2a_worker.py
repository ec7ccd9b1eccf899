"""One rank of the port's all-to-all MoE battery over gloo.

Run by tests/test_torch_moe_a2a.py, one process per rank, with torchrun's
environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT):

    python tests/torch_moe_a2a_worker.py INPUTS.npz OUT_DIR

Each rank builds the ("data", "model") meshes of its world size
(`MESHES`), runs the same cases on its own shard (SPMD) and pickles what
it saw to OUT_DIR/rank<r>.pkl: its outputs, aux estimates, dropped
assignments, trip counts and its own gradients (which the test averages
over the ranks and holds against the JAX package), and one
`make_train_step` step under the mesh, which takes the data-parallel
mean of the ranks' gradients itself (its new parameters and moments,
loss, grad norm and trips). On the meshes of `DP_MESHES` each rank also
takes one step of a dense smoke LM on its data shard, held against the
reference's single-device step on the whole batch.
`battery(mesh, inputs)` also runs in-process at world size 1. The case
constants are shared with tests/jax_moe_a2a_ref.py. Imports no jax.
"""
from __future__ import annotations

import dataclasses
import pickle
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch import interop
from repro_torch.configs import granite_moe_3b, h2o_danube_1_8b
from repro_torch.core import distributed as dist_mod
from repro_torch.core.distributed import collective_counts, flat_rank, \
    init_mesh, reset_collective_counts
from repro_torch.distributed import (axis_index, axis_size, current_mesh,
                                     use_mesh)
from repro_torch.models import moe as PM
from repro_torch.models import transformer as PT
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.train_loop import make_train_step

CPU = "cpu"
MESHES = {1: [(1, 1)], 2: [(1, 2)], 4: [(1, 4), (2, 2)],
          8: [(2, 4), (1, 8)]}
# meshes of the dense data-parallel step (smoke danube, no MoE)
DP_MESHES = {2: [(2, 1)], 4: [(4, 1), (2, 2)]}
D_MODEL, D_FF, N_EXPERTS, TOP_K, N_TOKENS = 16, 8, 8, 2, 32
# "nodrop": room for every assignment at both stages; "drop": a router
# pulled towards expert 0 at capacity factor 0.5, so the send buffers and
# the expert buffers both overflow on every mesh
CASES = {"nodrop": dict(cf=8.0, skew=0.0), "drop": dict(cf=0.5, skew=4.0)}
LM_BATCH, LM_SEQ = 4, 16
LEAVES = ("x", "router", "w1", "w3", "w2")


def mesh_of(shape):
    """The ("data", "model") mesh of `shape` over this process group."""
    return init_mesh(shape, ("data", "model"), CPU)


def data_shard(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """This rank's rows of x (dim 0) under `mesh` (default the active one):
    the block of its "data" coordinate when the data size divides the
    rows, else all of x, as the reference's token spec shards the batch
    over data or leaves it whole. The same on every rank of a "model"
    group. Without a mesh, x itself."""
    mesh = current_mesh() if mesh is None else mesh
    if mesh is None:
        return x
    n, idx = axis_size(mesh, "data"), axis_index(mesh, "data")
    if n == 1 or x.shape[0] % n:
        return x
    rows = x.shape[0] // n
    return x[idx * rows:(idx + 1) * rows]


def moe_config(case: str) -> PM.MoEConfig:
    return PM.MoEConfig(n_experts=N_EXPERTS, top_k=TOP_K,
                        capacity_factor=CASES[case]["cf"], impl="a2a")


def moe_inputs(case: str) -> dict:
    """numpy x [N_TOKENS, D] and the MoE weights of a case (seeded)."""
    rng = np.random.default_rng(3)
    s_in, s_out = 1 / np.sqrt(D_MODEL), 1 / np.sqrt(D_FF)
    out = {"x": rng.standard_normal((N_TOKENS, D_MODEL)),
           "router": rng.standard_normal((D_MODEL, N_EXPERTS)) * s_in,
           "w1": rng.standard_normal((N_EXPERTS, D_MODEL, D_FF)) * s_in,
           "w3": rng.standard_normal((N_EXPERTS, D_MODEL, D_FF)) * s_in,
           "w2": rng.standard_normal((N_EXPERTS, D_FF, D_MODEL)) * s_out}
    skew = CASES[case]["skew"]
    if skew:
        u = np.ones(D_MODEL) / np.sqrt(D_MODEL)
        out["x"] = out["x"] + u
        out["router"][:, 0] += skew * u
    return {k: v.astype(np.float32) for k, v in out.items()}


def lm_config(reference_module=granite_moe_3b):
    """Smoke granite with the all-to-all MoE at capacity factor 8 (no
    assignment drops at either stage); the same fields in both packages."""
    cfg = reference_module.smoke_config()
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, impl="a2a", capacity_factor=8.0))


def dense_config(reference_module=h2o_danube_1_8b):
    """Smoke danube (f32, window 8): the dense LM of the data-parallel
    step; the same fields in both packages."""
    return reference_module.smoke_config()


def unflatten(flat: dict, prefix: str) -> dict:
    """{"a/b/c": leaf} -> {"a": {"b": {"c": leaf}}} for keys under prefix."""
    tree: dict = {}
    for key, v in flat.items():
        if not key.startswith(prefix):
            continue
        node, parts = tree, key[len(prefix):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _grads(out, leaves) -> list:
    gs = torch.autograd.grad(out, leaves, retain_graph=True,
                             allow_unused=True)
    return [np.zeros(tuple(x.shape), np.float32) if g is None else _np(g)
            for g, x in zip(gs, leaves)]


def moe_case(mesh, case: str, inputs: dict) -> dict:
    """One rank's moe_apply_a2a on its data shard of x with its expert
    slice; the gradients of sum(y^2) and of the mesh-averaged aux, each
    with respect to the full-shape x and weights (zero outside this rank's
    shard / slice)."""
    cfg = moe_config(case)
    leaves = [torch.tensor(inputs[f"{case}/{k}"], requires_grad=True)
              for k in LEAVES]
    x, router, w1, w3, w2 = leaves
    ep = axis_size(mesh, "model")
    e_loc = N_EXPERTS // ep
    lo = axis_index(mesh, "model") * e_loc
    local = {"router": router, "w1": w1[lo:lo + e_loc],
             "w3": w3[lo:lo + e_loc], "w2": w2[lo:lo + e_loc]}
    group = mesh.get_group("model")
    stats: dict = {}
    reset_collective_counts()
    y, aux = PM.moe_apply_a2a(local, data_shard(x, mesh), cfg, ep, group,
                              stats=stats)
    aux_mean = PM.all_reduce_mean(aux, flat_rank(mesh)[0])
    fwd = collective_counts()
    reset_collective_counts()
    g_y = _grads((y * y).sum(), leaves)
    bwd = collective_counts()
    g_aux = _grads(aux_mean, leaves)
    with torch.no_grad():
        y2, _ = PM.moe_apply_a2a(local, data_shard(x, mesh), cfg, ep, group)
    return {"y": _np(y), "aux": float(aux.detach()),
            "aux_mean": float(aux_mean.detach()),
            "dropped_stage1": int(stats["dropped_stage1"]),
            "dropped_stage2": int(stats["dropped_stage2"]),
            "dropped": int(stats["dropped"]),
            "counts_fwd": fwd, "counts_bwd": bwd,
            "grad_y": dict(zip(LEAVES, g_y)),
            "grad_aux": dict(zip(LEAVES, g_aux)),
            "bitwise_again": bool(torch.equal(y, y2))}


def lm_case(mesh, inputs: dict) -> dict:
    """One rank's smoke-granite loss_fn under the mesh on its data shard of
    the batch, and the gradient of that loss (full-shape leaves)."""
    cfg = lm_config()
    params = interop.lm_params(unflatten(inputs, "lm/params/"), device=CPU)
    flat = [(k, v) for k, v in _flat(params)]
    leaves = [v.requires_grad_(True) for _, v in flat]
    tokens = data_shard(torch.from_numpy(inputs["lm/tokens"]), mesh)
    reset_collective_counts()
    with use_mesh(mesh):
        loss = PT.loss_fn(params, {"tokens": tokens}, cfg)
        grads = torch.autograd.grad(loss, leaves)
    counts = collective_counts()
    return {"loss": float(loss.detach()), "counts": counts,
            "grads": {k: _np(g) for (k, _), g in zip(flat, grads)}}


def step_case(mesh, inputs: dict, prefix: str, cfg) -> dict:
    """One `make_train_step` step (AdamW defaults, new tensors) from the
    inputs' parameters under the mesh, on this rank's data shard of the
    token batch: the step averages the ranks' gradients and losses. Its
    new parameters, m and v (flat numpy), loss, grad norm and trips."""
    params = interop.lm_params(unflatten(inputs, f"{prefix}/params/"),
                               device=CPU)
    opt_cfg = AdamWConfig()
    step = make_train_step(lambda p, b: PT.loss_fn(p, b, cfg), opt_cfg,
                           donate=False)
    batch = {"tokens": data_shard(torch.from_numpy(inputs["lm/tokens"]),
                                  mesh)}
    reset_collective_counts()
    with use_mesh(mesh):
        new, opt, metrics = step(params, adamw_init(params, opt_cfg), batch)
    return {"loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]),
            "params": {k: _np(v) for k, v in _flat(new)},
            "m": {k: _np(v) for k, v in _flat(opt["m"])},
            "v": {k: _np(v) for k, v in _flat(opt["v"])},
            "trips": collective_counts()}


def train_case(mesh, inputs: dict) -> dict:
    """`step_case` on smoke granite (impl "a2a", capacity 8)."""
    return step_case(mesh, inputs, "lm", lm_config())


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def fallback_case(mesh) -> dict:
    """transformer.ffn with impl "a2a" where the "model" size does not
    divide the expert count (3 experts): the dense path, no trips."""
    cfg = dataclasses.replace(lm_config(), moe=PM.MoEConfig(
        n_experts=3, top_k=2, capacity_factor=8.0, impl="a2a"))
    gen = torch.Generator().manual_seed(0)
    lp = {"moe": PM.moe_init(gen, cfg.d_model, cfg.d_ff, cfg.moe)}
    x = torch.randn((2, 5, cfg.d_model), generator=gen)
    reset_collective_counts()
    with use_mesh(mesh):
        y, aux = PT.ffn(lp, x, cfg)
    trips = collective_counts()
    y_dense, aux_dense = PM.moe_apply(lp["moe"], x.reshape(10, -1), cfg.moe)
    return {"trips": trips, "same": bool(
        torch.equal(y.reshape(10, -1), y_dense) and torch.equal(aux,
                                                                aux_dense))}


def battery(mesh, inputs: dict) -> dict:
    out = {case: moe_case(mesh, case, inputs) for case in CASES}
    out["lm"] = lm_case(mesh, inputs)
    out["train"] = train_case(mesh, inputs)
    if axis_size(mesh, "model") > 1:
        out["fallback"] = fallback_case(mesh)
    return out


def main(inputs_path: str, out_dir: str) -> int:
    torch.set_num_threads(1)
    inputs = dict(np.load(inputs_path))
    dist_mod.init_process_group(CPU)
    ws, rank = dist_mod.world_size(), dist_mod.rank()
    res = {}
    for shape in MESHES[ws]:
        res[shape] = battery(mesh_of(shape), inputs)
    for shape in DP_MESHES.get(ws, []):
        res[("dense",) + shape] = step_case(mesh_of(shape), inputs, "dense",
                                            dense_config())
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2]))
