"""Train a PNA GNN with CPAA PageRank features (the port's counterpart of
`examples/train_gnn.py`).

    PYTHONPATH=src python -m repro_torch.launch.train_gnn --steps 300 \\
        [--batch-nodes 64] [--device cpu]

The flow is the example's:
  * CPAA (the engine auto picks for the graph) computes PageRank once; it
    becomes (a) an input feature and (b) the importance weights of the
    neighbour sampler;
  * the minibatch pipeline (graph.sampler + train.data) feeds fixed-shape
    sampled subgraphs;
  * AdamW steps (`make_train_step`, donate=False) with a checkpoint at
    mid-run, then restore and replay.
Where the example replays the batch its checkpoint had already consumed,
this replays the next one (`data_step` = the step to take) and holds the
replay to the original step bit for bit. Without `--device` it runs on
cuda and raises on a host without a GPU.
"""
from __future__ import annotations

import argparse
import tempfile
import time
from functools import partial

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.core.engine import select_engine
from repro_torch.core.pagerank import cpaa
from repro_torch.device import resolve_device
from repro_torch.graph import generators
from repro_torch.graph.structure import Graph
from repro_torch.models.gnn import pna
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.data import GraphBatchPipeline
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.train_loop import make_train_step

__all__ = ["pagerank_task", "fit", "replay", "tree_max_gap", "run", "main"]


def pagerank_task(g: Graph, device=None, seed: int = 0):
    """(PageRank float64 [n], features [n, 9], targets [n, 2], delta):
    CPAA (c = 0.85, tol 1e-6) on the engine auto picks, on `device`; the
    features are 8 N(0, 1) columns and n * PageRank; the targets are
    log(n * PageRank) and the mean of the neighbours' first feature;
    delta is the mean log-degree (PNA's scaler normalizer)."""
    eng = select_engine(g, mode="auto", device=resolve_device(device))
    pr = cpaa(eng, 0.85, 1e-6).pi.cpu().numpy().astype(float)
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(g.n, 8)).astype(np.float32)
    feats = np.concatenate(
        [base, (pr[:, None] * g.n).astype(np.float32)], axis=1)  # PR feature
    # target: log PageRank + mean of neighbour features (learnable signal)
    deg = np.maximum(g.deg, 1)
    nbr_mean = np.zeros((g.n, 1), np.float32)
    np.add.at(nbr_mean, g.dst, base[g.src, :1])
    nbr_mean /= deg[:, None]
    targets = np.concatenate(
        [np.log(pr[:, None] * g.n).astype(np.float32), nbr_mean], axis=1)
    return pr, feats, targets, float(np.log1p(deg).mean())


def fit(step, params, opt, pipe: GraphBatchPipeline, steps: int, ckpt_dir,
        async_save: bool = False, log=None, log_every: int = 50) -> dict:
    """`steps` train steps over pipe.batch(0 .. steps-1). After step
    steps // 2 the state is saved (metadata data_step = the next step);
    the params and metrics of that next step are kept as `reference` for
    `replay`. Returns the final state, per-step losses and grad norms,
    host ms per batch (sampler + remap), device ms per step (CUDA events;
    wall ms on the CPU), the checkpoint's step and `reference`."""
    if steps < 2:
        raise ValueError("the checkpoint drill needs at least 2 steps")
    mid = steps // 2
    on_cuda = pipe.device.type == "cuda"
    losses, gnorms, host_ms, timers, thread = [], [], [], [], None
    reference = None
    for i in range(steps):
        t0 = time.perf_counter()
        arrays = pipe.batch_arrays(i)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        batch = {k: torch.from_numpy(v).to(pipe.device)
                 for k, v in arrays.items()}
        if on_cuda:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        else:
            t0 = time.perf_counter()
        params, opt, metrics = step(params, opt, batch)
        if on_cuda:
            ev[1].record()
            timers.append(ev)
        else:
            timers.append((time.perf_counter() - t0) * 1e3)
        losses.append(metrics["loss"])
        gnorms.append(metrics["grad_norm"])
        if log is not None and i % log_every == 0:
            log(f"step {i:4d}  loss {float(metrics['loss']):.4f}  "
                f"gnorm {float(metrics['grad_norm']):.3f}")
        if i == mid:
            thread = ckpt.save(ckpt_dir, i + 1, {"params": params, "opt": opt},
                               metadata={"data_step": i + 1},
                               async_=async_save)
        elif i == mid + 1:
            reference = (params, metrics)
    if thread is not None:
        thread.join()
    if on_cuda:
        torch.cuda.synchronize()
        device_ms = [a.elapsed_time(b) for a, b in timers]
    else:
        device_ms = timers
    return {"params": params, "opt": opt,
            "losses": [float(x) for x in losses],
            "grad_norms": [float(x) for x in gnorms], "host_ms": host_ms,
            "device_ms": device_ms, "ckpt_step": mid + 1,
            "reference": reference}


def replay(step, ckpt_dir, tree_like, pipe: GraphBatchPipeline):
    """Restore the newest checkpoint into `tree_like`'s structure and
    devices and take its data_step again: (params, metrics, data_step)."""
    restored, meta = ckpt.restore(ckpt_dir, tree_like)
    params, _, metrics = step(restored["params"], restored["opt"],
                              pipe.batch(meta["data_step"]))
    return params, metrics, meta["data_step"]


def tree_max_gap(a, b) -> float:
    """Largest |a - b| over the leaves of two trees of one structure."""
    return max(float((x.detach() - y.detach()).abs().max())
               for x, y in zip(pytree.tree_leaves(a), pytree.tree_leaves(b)))


def run(steps: int = 300, batch_nodes: int = 64, device=None,
        log=print) -> dict:
    """The example's run: a 2,000-node Barabasi-Albert graph, PNA with 3
    layers of width 32, fanouts (8, 5), AdamW lr 2e-3 / wd 0.01."""
    dev = resolve_device(device)
    g = generators.powerlaw_ba(2_000, 4, seed=0)
    log(f"graph: n={g.n} m={g.m}")
    log("computing PageRank with CPAA ...")
    pr, feats, targets, delta = pagerank_task(g, dev)
    cfg = pna.PNAConfig(name="pna-example", n_layers=3, d_hidden=32,
                        d_in=feats.shape[1], d_out=targets.shape[1],
                        delta=delta)
    params = pna.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    opt_cfg = AdamWConfig(lr=2e-3, weight_decay=0.01)
    opt = adamw_init(params, opt_cfg)
    step = make_train_step(partial(pna.loss_fn, cfg=cfg), opt_cfg,
                           num_microbatches=1, donate=False)
    # PPR-weighted neighbour sampling — the paper's algorithm in the pipeline
    pipe = GraphBatchPipeline(g, feats, targets, batch_nodes, fanouts=(8, 5),
                              seed=1, ppr_weights=pr, device=dev)
    with tempfile.TemporaryDirectory(prefix="repro_torch_gnn_") as ckpt_dir:
        out = fit(step, params, opt, pipe, steps, ckpt_dir, log=log)
        log(f"checkpoint saved at step {out['ckpt_step']} -> {ckpt_dir}")
        rp, rm, data_step = replay(
            step, ckpt_dir, {"params": out["params"], "opt": out["opt"]},
            pipe)
    ref_params, ref_metrics = out["reference"]
    gap = tree_max_gap(ref_params, rp)
    out["replay_bitwise"] = gap == 0.0 and bool(
        torch.equal(ref_metrics["loss"], rm["loss"]))
    log(f"restore+replay of step {data_step}: "
        f"{'bit-exact' if out['replay_bitwise'] else 'DIFFERS'} "
        f"(max param gap {gap:.3e})")
    losses = out["losses"]
    k = max(1, min(20, len(losses) // 2))
    first, last = np.mean(losses[:k]), np.mean(losses[-k:])
    log(f"loss: first-{k} avg {first:.4f} -> last-{k} avg {last:.4f} "
        f"({'improved' if last < first else 'NOT improved'})")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch-nodes", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    run(args.steps, args.batch_nodes, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
