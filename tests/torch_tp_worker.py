"""One rank of the sharded-model parity battery over gloo, for
tests/test_torch_tensor_parallel.py.

    RANK=r WORLD_SIZE=n MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/torch_tp_worker.py IN_DIR OUT_DIR DP TP

Builds the (DP, TP) ("data", "model") mesh over the world, and for every
case of CASES reads IN_DIR/<case>.npz (the whole parameters flattened by
path under "p/", the batch under "b/"), shards the parameters by the
case's specs (`sharding.shard_tree`) and the batch by its rows over
"data", and runs the port under `use_mesh(mesh, sharded=True)`: the loss,
every gradient leaf after the sharded step's mean, one AdamW step
(parameters, m, v, grad_norm), and the inference entry points. Results
are gathered whole (`sharding.gather_tree`) and rank 0 writes
OUT_DIR/<case>.npz. Imports no jax.
"""
from __future__ import annotations

import dataclasses
import sys
from functools import partial
from pathlib import Path

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch import interop
from repro_torch.configs import (dlrm_rm2, granite_moe_3b, h2o_danube_1_8b,
                                 qwen2_5_32b, qwen3_moe_235b)
from repro_torch.core import distributed as cdist
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import P
from repro_torch.models import transformer as tf
from repro_torch.models.recsys import dlrm
from repro_torch.train import train_loop
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.train_loop import make_train_step

LR = 1e-3
DECODE_AT = 16           # prefill 16 tokens into a cache of CACHE
CACHE = 32
A2A_NODROP_CF = 8.0      # the a2a case's capacity factor: E / k, no drops
TOP_K = 8                # retrieval's top-k over the sharded bank


def _qwen3_ep(cfg):
    """qwen3's smoke config with 16 experts: the count tiles the specs'
    16-way rule, so its experts lie expert-parallel over "model"."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            n_experts=16))


# case -> (port module, config transform); the test gives the reference
# the same transform of its own smoke config
CASES = {
    "danube": (h2o_danube_1_8b, None),
    "granite": (granite_moe_3b, None),
    "qwen3": (qwen3_moe_235b, _qwen3_ep),
    "qwen25": (qwen2_5_32b, None),
    "dlrm": (dlrm_rm2, None),
}


def port_config(case: str):
    mod, fix = CASES[case]
    cfg = mod.smoke_config()
    return fix(cfg) if fix else cfg


def flatten(tree, prefix: str = "") -> dict:
    """{path: leaf} of a tree of dicts and lists ("layers/wq",
    "bot/0/w")."""
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


def _rows(mesh):
    """(lo, hi) of this rank's rows of a batch of n over "data"."""
    def rows(n):
        lo, hi, _ = sh.split(n, sh.axis_size(mesh, "data"),
                             sh.axis_index(mesh, "data"))
        return lo, hi
    return rows


def _gather_rows(x, mesh, n):
    """The whole [n, ...] from every "data" rank's rows (even splits)."""
    return sh.gather_tree(x, P("data"), mesh, torch.empty((n,)
                                                          + x.shape[1:]))


def _np(tree) -> dict:
    return {k: v.detach().float().numpy()
            for k, v in flatten(tree).items()}


def run_lm(case: str, data: dict, mesh) -> dict:
    cfg = port_config(case)
    params = interop.lm_params(unflatten(data["p"]), device="cpu")
    specs = sh.lm_param_specs(cfg, False)
    tokens = torch.from_numpy(data["b"]["tokens"])
    b = tokens.shape[0]
    lo, hi = _rows(mesh)(b)
    out = {}
    with sh.use_mesh(mesh, sharded=True):
        local = sh.shard_tree(params, specs, mesh)
        mine = tokens[lo:hi]
        # the loss and the gradient leaves after the sharded mean
        leaves, spec, xs = train_loop._grad_leaves(local)
        loss = tf.loss_fn(pytree.tree_unflatten(xs, spec),
                          {"tokens": mine}, cfg)
        torch.autograd.backward(loss, inputs=xs)
        grads = [x.grad for x in xs]
        loss = train_loop._spec_mean(
            grads, train_loop.spec_leaves(specs, local), loss.detach())
        out["loss"] = loss.numpy()
        g = sh.gather_tree(pytree.tree_unflatten(grads, spec), specs, mesh,
                           params)
        out.update({f"grad/{k}": v for k, v in _np(g).items()})
        # one AdamW step
        opt = AdamWConfig(lr=LR)
        step = make_train_step(partial(tf.loss_fn, cfg=cfg), opt,
                               donate=False, grad_specs=specs)
        new_p, new_s, metrics = step(local, adamw_init(local, opt),
                                     {"tokens": mine})
        out["step/loss"] = metrics["loss"].numpy()
        out["step/grad_norm"] = metrics["grad_norm"].numpy()
        for name, tree in (("params", new_p), ("m", new_s["m"]),
                           ("v", new_s["v"])):
            whole = sh.gather_tree(tree, specs, mesh, params)
            out.update({f"{name}/{k}": v for k, v in _np(whole).items()})
        # inference
        logits, _ = tf.forward(local, mine[:, :DECODE_AT], cfg)
        out["forward"] = _gather_rows(logits, mesh, b).numpy()
        last, kv = tf.prefill(local, mine[:, :DECODE_AT], cfg, pad_to=CACHE)
        out["prefill"] = _gather_rows(last, mesh, b).numpy()
        nxt = mine[:, DECODE_AT:DECODE_AT + 1]
        dec, _ = tf.decode_step(local, nxt, kv, DECODE_AT, cfg)
        out["decode"] = _gather_rows(dec, mesh, b).numpy()
    return out


def run_a2a(data: dict, mesh) -> dict:
    """qwen3's case with the all-to-all MoE (impl "a2a") at a capacity
    factor where nothing drops (where stage 2 drops, the ranks of a model
    group get different rows back, and the sharded model takes their
    mean), sharded: its expert weights all-gathered over "data", the a2a
    a region over "model". The loss and every gradient leaf after the
    sharded mean, and one AdamW step (parameters, m, v, loss, grad_norm),
    as tests/jax_tp_a2a_ref.py computes them with the reference; only
    where the model size divides the experts (else the path is the dense
    dispatch, which run_lm covers)."""
    cfg = port_config("qwen3")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, impl="a2a", capacity_factor=A2A_NODROP_CF))
    params = interop.lm_params(unflatten(data["p"]), device="cpu")
    specs = sh.lm_param_specs(cfg, False)
    tokens = torch.from_numpy(data["b"]["tokens"])
    lo, hi = _rows(mesh)(tokens.shape[0])
    mine = {"tokens": tokens[lo:hi]}
    out = {}
    with sh.use_mesh(mesh, sharded=True):
        local = sh.shard_tree(params, specs, mesh)
        leaves, spec, xs = train_loop._grad_leaves(local)
        loss = tf.loss_fn(pytree.tree_unflatten(xs, spec), mine, cfg)
        torch.autograd.backward(loss, inputs=xs)
        grads = [torch.zeros_like(x) if x.grad is None else x.grad
                 for x in xs]
        out["loss"] = train_loop._spec_mean(
            grads, train_loop.spec_leaves(specs, local),
            loss.detach()).numpy()
        g = sh.gather_tree(pytree.tree_unflatten(grads, spec), specs, mesh,
                           params)
        out.update({f"grad/{k}": v for k, v in _np(g).items()})
        opt = AdamWConfig(lr=LR)
        step = make_train_step(partial(tf.loss_fn, cfg=cfg), opt,
                               donate=False, grad_specs=specs)
        new_p, new_s, metrics = step(local, adamw_init(local, opt), mine)
        out["step/loss"] = metrics["loss"].numpy()
        out["step/grad_norm"] = metrics["grad_norm"].numpy()
        for name, tree in (("params", new_p), ("m", new_s["m"]),
                           ("v", new_s["v"])):
            whole = sh.gather_tree(tree, specs, mesh, params)
            out.update({f"{name}/{k}": v for k, v in _np(whole).items()})
    return out


def run_dlrm(data: dict, mesh) -> dict:
    cfg = port_config("dlrm")
    params = interop.dlrm_params(unflatten(data["p"]), device="cpu")
    specs = sh.dlrm_param_specs(params, False)
    batch = {k: torch.from_numpy(v) for k, v in data["b"].items()
             if k != "candidates"}
    b = batch["dense"].shape[0]
    lo, hi = _rows(mesh)(b)
    out = {}
    with sh.use_mesh(mesh, sharded=True):
        local = sh.shard_tree(params, specs, mesh)
        mine = {k: v[lo:hi] for k, v in batch.items()}
        out["logits"] = _gather_rows(dlrm.forward(local, mine, cfg), mesh,
                                     b).detach().numpy()
        out["serve"] = _gather_rows(dlrm.serve_step(local, mine, cfg), mesh,
                                    b).numpy()
        # the candidate bank over every axis, as the retrieval plan lays it
        cands = torch.from_numpy(data["b"]["candidates"])
        piece = sh.local_shard(cands, P(("data", "model"), None), mesh)
        scores, idx = dlrm.retrieval_step(
            local, {"dense": batch["dense"][:1], "candidates": piece,
                    "n_candidates": cands.shape[0]}, cfg, top_k=TOP_K)
        out["retrieval/scores"] = scores.numpy()
        out["retrieval/idx"] = idx.numpy()
        leaves, spec, xs = train_loop._grad_leaves(local)
        loss = dlrm.loss_fn(pytree.tree_unflatten(xs, spec), mine, cfg)
        torch.autograd.backward(loss, inputs=xs)
        grads = [x.grad for x in xs]
        loss = train_loop._spec_mean(
            grads, train_loop.spec_leaves(specs, local), loss.detach())
        out["loss"] = loss.numpy()
        g = sh.gather_tree(pytree.tree_unflatten(grads, spec), specs, mesh,
                           params)
        out.update({f"grad/{k}": v for k, v in _np(g).items()})
        opt = AdamWConfig(lr=LR)
        step = make_train_step(partial(dlrm.loss_fn, cfg=cfg), opt,
                               donate=False, grad_specs=specs)
        new_p, new_s, metrics = step(local, adamw_init(local, opt), mine)
        out["step/loss"] = metrics["loss"].numpy()
        out["step/grad_norm"] = metrics["grad_norm"].numpy()
        for name, tree in (("params", new_p), ("m", new_s["m"]),
                           ("v", new_s["v"])):
            whole = sh.gather_tree(tree, specs, mesh, params)
            out.update({f"{name}/{k}": v for k, v in _np(whole).items()})
    return out


def load(path: Path) -> dict:
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    return {"p": {k[2:]: v for k, v in flat.items() if k.startswith("p/")},
            "b": {k[2:]: v for k, v in flat.items() if k.startswith("b/")}}


def main(in_dir: str, out_dir: str, dp: int, tp: int) -> int:
    torch.set_num_threads(1)
    mesh = cdist.init_mesh((dp, tp), ("data", "model"), "cpu")
    for case in CASES:
        data = load(Path(in_dir) / f"{case}.npz")
        out = run_dlrm(data, mesh) if case == "dlrm" else \
            run_lm(case, data, mesh)
        if case == "qwen3" and 16 % tp == 0:
            out.update({f"a2a/{k}": v for k, v in run_a2a(data,
                                                          mesh).items()})
        if cdist.rank() == 0:
            np.savez(Path(out_dir) / f"{case}.npz", **out)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2], int(sys.argv[3]),
                  int(sys.argv[4])))
