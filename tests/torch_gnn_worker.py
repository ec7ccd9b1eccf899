"""One rank of the partitioned-GNN and rank-local CPAA parity battery over
gloo, for tests/test_torch_gnn_sharded.py.

    RANK=r WORLD_SIZE=n MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/torch_gnn_worker.py IN_DIR OUT_DIR SHAPE

SHAPE is the mesh, "DxM" over ("data", "model") or "PxDxM" over ("pod",
"data", "model"). For every IN_DIR/gnn_<arch>_<size>.npz (the whole
parameters flattened by path under "p/", the whole batch under "b/") it
lays the batch out by the production rule (`sharding.gnn_batch_specs`,
multi-pod on a mesh with "pod"), keeps this rank's pieces
(`sharding.shard_tree`) and runs the port under `use_mesh(mesh,
sharded=True)` with the batch's `GraphLayout`: the loss and every
gradient leaf after the GNN rule (the ranks' sums), and one AdamW step of
`make_train_step(grad_rule="sum")` (parameters, m, v, loss, grad_norm).
The parameters are replicated, so every rank holds them whole. With
IN_DIR/cpaa.npz it also runs the rank-local CPAA steps
(`core.distributed.cpaa_local_1d` / `_2d`) on `tri_mesh(23, 31)`: the
1D partition over every rank, the 2D grid (rows = every axis but
"model", flattened) on the mesh's grid view, for each personalization
p/<name>; the pieces of pi are gathered whole. Rank 0 writes
OUT_DIR/<case>.npz. Imports no jax.
"""
from __future__ import annotations

import sys
from functools import partial
from pathlib import Path

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch import interop
from repro_torch.configs import dimenet as dimenet_cfg
from repro_torch.configs import graphcast as graphcast_cfg
from repro_torch.configs import meshgraphnet as mgn_cfg
from repro_torch.configs import pna as pna_cfg
from repro_torch.core import distributed as cdist
from repro_torch.core.chebyshev import make_schedule
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import P
from repro_torch.graph import generators
from repro_torch.graph.partition import col_layout_perm, partition_1d, \
    partition_2d
from repro_torch.models.gnn import dimenet, graphcast, meshgraphnet, pna
from repro_torch.models.gnn.common import GraphLayout
from repro_torch.train import train_loop
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.train_loop import make_train_step

LR = 1e-3
CPAA_C = 0.85
CPAA_ROUNDS = 24
CPAA_LANE = 4

# arch -> (model module, port smoke config)
ARCHS = {
    "meshgraphnet": (meshgraphnet, mgn_cfg.smoke_config()),
    "pna": (pna, pna_cfg.smoke_config()),
    "dimenet": (dimenet, dimenet_cfg.smoke_config()),
    "graphcast": (graphcast, graphcast_cfg.smoke_config()),
}


def cpaa_graph():
    return generators.tri_mesh(23, 31)


def flatten(tree, prefix: str = "") -> dict:
    """{path: leaf} of a tree of dicts and lists ("layers/edge/mlp/0/w")."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in flatten(v, f"{prefix}{k}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in flatten(v, f"{prefix}{i}/").items()}
    return {prefix[:-1]: tree}


def unflatten(flat: dict):
    """The inverse of `flatten` (a key made of digits is a list index)."""
    root: dict = {}
    for path, v in flat.items():
        node = root
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = v

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}
    return lists(root)


def _np(tree) -> dict:
    return {k: v.detach().float().numpy()
            for k, v in flatten(tree).items()}


def run_gnn(arch: str, data: dict, mesh, multi_pod: bool) -> dict:
    mod, cfg = ARCHS[arch]
    params = interop.gnn_params(unflatten(data["p"]), device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in data["b"].items()}
    specs = sh.gnn_batch_specs(batch, multi_pod)
    layout = GraphLayout.of(batch, specs)
    out = {"sharded": np.array(sorted(layout.sharded))}
    with sh.use_mesh(mesh, sharded=True):
        local = sh.shard_tree(batch, specs, mesh)
        leaves, spec, xs = train_loop._grad_leaves(params)
        loss = mod.loss_fn(pytree.tree_unflatten(xs, spec), local, cfg,
                           layout)
        torch.autograd.backward(loss, inputs=xs)
        grads = [torch.zeros_like(x) if x.grad is None else x.grad
                 for x in xs]
        out["loss"] = train_loop._global_sum(grads, loss.detach()).numpy()
        out.update({f"grad/{k}": v for k, v in
                    _np(pytree.tree_unflatten(grads, spec)).items()})
        opt = AdamWConfig(lr=LR)
        step = make_train_step(partial(mod.loss_fn, cfg=cfg, layout=layout),
                               opt, donate=False, grad_rule="sum")
        new_p, new_s, metrics = step(params, adamw_init(params, opt), local)
        out["step/loss"] = metrics["loss"].numpy()
        out["step/grad_norm"] = metrics["grad_norm"].numpy()
        for name, tree in (("params", new_p), ("m", new_s["m"]),
                           ("v", new_s["v"])):
            out.update({f"{name}/{k}": v for k, v in _np(tree).items()})
    return out


def _pad(p: np.ndarray, n: int) -> torch.Tensor:
    out = np.zeros((n,) + p.shape[1:], np.float32)
    out[:p.shape[0]] = p
    return torch.from_numpy(out)


def run_cpaa(data: dict, mesh) -> dict:
    """pi of every personalization through the rank-local 1D and 2D steps,
    gathered whole (original vertex order, the real vertices)."""
    g = cpaa_graph()
    names = tuple(mesh.mesh_dim_names)
    rows = names[:-1]
    sched = make_schedule(CPAA_C, rounds=CPAA_ROUNDS)
    part = partition_1d(g, mesh.size(), lane=CPAA_LANE)
    view = cdist.grid_view(mesh, rows, "model")
    grid = tuple(int(s) for s in view.shape)
    part2 = partition_2d(g, grid, lane=CPAA_LANE)
    perm = col_layout_perm(part2.n, grid)
    step1 = cdist.cpaa_local_1d(mesh, part, sched)
    step2 = cdist.cpaa_local_2d(view, part2, sched)
    e1 = [sh.local_shard(torch.from_numpy(a), P(names), mesh)
          for a in (part.src, part.dst_local, part.weight)]
    e2 = [sh.local_shard(torch.from_numpy(a), P(rows, "model"), mesh)
          for a in (part2.src_local, part2.dst_local, part2.weight)]
    out = {"grid": np.array(grid)}
    for key, p in data["p"].items():
        tail = (None,) * (p.ndim - 1)
        whole = _pad(p, part.n)
        spec = P(names, *tail)
        pi = step1(sh.local_shard(whole, spec, mesh), *e1)
        pi = sh.gather_tree(pi, spec, mesh, whole)
        out[f"1d/{key}"] = pi[:g.n].numpy()
        whole = _pad(p, part2.n)[torch.from_numpy(perm).long()]
        spec = P("model", *tail)
        pi_col = step2(sh.local_shard(whole, spec, mesh), *e2)
        pi_col = sh.gather_tree(pi_col, spec, mesh, whole).numpy()
        pi = np.empty_like(pi_col)
        pi[perm] = pi_col
        out[f"2d/{key}"] = pi[:g.n]
    return out


def load(path: Path) -> dict:
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    return {"p": {k[2:]: v for k, v in flat.items() if k.startswith("p/")},
            "b": {k[2:]: v for k, v in flat.items() if k.startswith("b/")}}


def main(in_dir: str, out_dir: str, shape: str) -> int:
    torch.set_num_threads(1)
    dims = tuple(int(s) for s in shape.split("x"))
    names = ("pod", "data", "model")[-len(dims):]
    mesh = cdist.init_mesh(dims, names, "cpu")
    for path in sorted(Path(in_dir).glob("gnn_*.npz")):
        arch = path.stem.split("_")[1]
        out = run_gnn(arch, load(path), mesh, "pod" in names)
        if cdist.rank() == 0:
            np.savez(Path(out_dir) / path.name, **out)
    cpaa = Path(in_dir) / "cpaa.npz"
    if cpaa.exists():
        out = run_cpaa(load(cpaa), mesh)
        if cdist.rank() == 0:
            np.savez(Path(out_dir) / "cpaa.npz", **out)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2], sys.argv[3]))
