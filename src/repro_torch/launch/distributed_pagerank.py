"""Distributed CPAA over torch.distributed — the paper's Algorithm 1 with
the vertex-to-thread assignment replaced by 1D/2D edge partitions and
collectives (the port's counterpart of `examples/distributed_pagerank.py`).

    PYTHONPATH=src python -m repro_torch.launch.distributed_pagerank \\
        [--scale 0.5] [--device cpu]
    PYTHONPATH=src torchrun --nproc-per-node 2 \\
        -m repro_torch.launch.distributed_pagerank --device cpu

The sharded solve is an ordinary engine: build it from a graph and hand it
to `cpaa` like any other engine. Under torchrun (WORLD_SIZE > 1) every
rank runs this SPMD program over one process group (NCCL on cuda, gloo on
the CPU), as `launch/serve.py` does; without torchrun the engines run at
world size 1 on a single-rank group started in process. Rank 0 alone
prints. Without `--device` it runs on cuda and raises on a host without a
GPU.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch.distributed as dist

from repro_torch.core import distributed
from repro_torch.core.chebyshev import make_schedule
from repro_torch.core.engine import (Sharded1DEngine, Sharded2DEngine,
                                     factor_grid, select_engine)
from repro_torch.core.pagerank import cpaa
from repro_torch.device import resolve_device
from repro_torch.graph import generators
from repro_torch.graph.ops import device_graph

__all__ = ["run", "main"]


def _rel_err(pi, pi_ref) -> float:
    return float(np.max(np.abs(pi - pi_ref) / pi_ref))


def run(device=None, scale: float = 0.5, log=print) -> dict:
    """The example's run on `device` (None = cuda) over the default process
    group (started here, and destroyed on return, when none is
    initialized). Returns what rank 0 prints: the world size, the graph's
    size, the 1D and 2D engines' max relative error against the
    single-device solve, edges per rank, the 2D grid and auto's pick."""
    dev = resolve_device(device)
    started = not dist.is_initialized()
    distributed.init_process_group(dev)
    try:
        ws = distributed.world_size()
        if distributed.rank() != 0:
            log = _quiet
        log(f"ranks: {ws} ({dist.get_backend()} on {dev.type})")
        if ws == 1:
            log("single rank — run under torchrun --nproc-per-node N for "
                "the real demo")
        g = generators.paper_dataset("delaunay-n21", scale=scale)
        log(f"graph: n={g.n}, m={g.m}")
        sched = make_schedule(0.85, 1e-6)
        pi_ref = cpaa(device_graph(g, device=dev),
                      schedule=sched).pi.cpu().numpy().astype(float)

        # ---- 1D row partition (paper-faithful decomposition)
        eng1 = Sharded1DEngine.from_graph(g, lane=8, device=dev)
        pi1 = cpaa(eng1, schedule=sched).pi.cpu().numpy().astype(float)
        err1 = _rel_err(pi1, pi_ref)
        log(f"1D sharded engine:   max rel err vs single-device {err1:.2e} "
            f"({eng1.src.shape[0]} edges on rank 0)")

        # ---- 2D grid partition (beyond-paper: O(n) -> O(n/R + n/C) comm)
        grid = factor_grid(ws)
        eng2 = Sharded2DEngine.from_graph(g, grid=grid, lane=8, device=dev)
        pi2 = cpaa(eng2, schedule=sched).pi.cpu().numpy().astype(float)
        err2 = _rel_err(pi2, pi_ref)
        log(f"2D sharded engine:   max rel err vs single-device {err2:.2e} "
            f"(grid {grid}, {eng2.src_local.shape[0]} edges on rank 0)")

        # ---- what the heuristic would do for a graph this size
        auto = select_engine(g, lane=8, device=dev)
        log(f"select_engine(auto) on {ws} rank(s) picks: {auto.name}")
        return {"world_size": ws, "n": g.n, "m": g.m, "err_1d": err1,
                "err_2d": err2, "grid": grid, "auto": auto.name,
                "pi_ref": pi_ref, "pi_1d": pi1, "pi_2d": pi2}
    finally:
        if started:
            dist.destroy_process_group()


def _quiet(msg: str) -> None:
    pass


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=0.5,
                    help="paper_dataset('delaunay-n21', scale) (default 0.5)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; LOCAL_RANK's card "
                         "under torchrun)")
    args = ap.parse_args(argv)
    return run(args.device, args.scale)


if __name__ == "__main__":
    main()
