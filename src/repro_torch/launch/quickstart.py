"""Quickstart: PageRank on an undirected graph with CPAA vs baselines (the
port's counterpart of `examples/quickstart.py`).

    PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cpu]

The flow is the example's: a 1,200-vertex triangulated mesh, the CPAA
schedule at tol 1e-6 against the dense float64 solve, then power,
forward push and Monte Carlo against the same solve, the top-5 vertices,
and a batched personalized PageRank of 3 seeds in one solve. Without
`--device` it runs on cuda and raises on a host without a GPU.
"""
from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from repro_torch.core.chebyshev import make_schedule, sigma_c
from repro_torch.core.pagerank import (cpaa, forward_push, monte_carlo,
                                       power, true_pagerank_dense)
from repro_torch.device import resolve_device
from repro_torch.graph import generators
from repro_torch.graph.ops import device_graph

__all__ = ["run", "main"]


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().astype(float)


def run(device=None, c: float = 0.85, log=print) -> dict:
    """The example's run on `device` (None = cuda). Returns what it prints:
    the schedule's rounds, each solver's max relative error against the
    dense solve and its round count, the top-5 vertices, each PPR seed's
    self-mass and top neighbour, and the CPAA and PPR vectors."""
    dev = resolve_device(device)
    g = generators.tri_mesh(30, 40)
    log(f"graph: n={g.n} vertices, m={g.m} directed edges, "
        f"avg degree {g.avg_degree:.2f}")
    dg = device_graph(g, device=dev)

    sched = make_schedule(c, tol=1e-6)
    power_guess = int(math.ceil(math.log(1e-6) / math.log(c)))
    log(f"damping c={c}: CPAA schedule has {sched.rounds} rounds "
        f"(sigma_c={sigma_c(c):.4f}; Power needs ~{power_guess} rounds for "
        "the same tolerance)")

    res = cpaa(dg, c=c, schedule=sched)
    pi = _host(res.pi)
    truth = true_pagerank_dense(g, c)
    errors = {"cpaa": float(np.max(np.abs(pi - truth) / truth))}
    iterations = {"cpaa": int(res.iterations)}
    log(f"CPAA max relative error vs direct solve: {errors['cpaa']:.2e} in "
        f"{res.iterations} rounds")

    for name, r in (("power", power(dg, c=c, tol=1e-12)),
                    ("forward-push", forward_push(dg, c=c,
                                                  rounds=sched.rounds)),
                    ("monte-carlo", monte_carlo(dg, c=c, walks_per_node=32))):
        errors[name] = float(np.max(np.abs(_host(r.pi) - truth) / truth))
        iterations[name] = int(r.iterations)
        log(f"{name:>13}: max rel err {errors[name]:.2e} "
            f"({iterations[name]} rounds)")

    top = np.argsort(-pi, kind="stable")[:5]
    log(f"top-5 vertices: {list(zip(top.tolist(), np.round(pi[top], 6)))}")

    # batched personalized PageRank: B columns in one solve
    seeds = [0, g.n // 2, g.n - 1]
    p = np.zeros((g.n, len(seeds)), np.float32)
    for j, s in enumerate(seeds):
        p[s, j] = 1.0
    ppr = _host(cpaa(dg, c=c, schedule=sched,
                     p=torch.from_numpy(p).to(dev)).pi)
    ppr_rows = []
    for j, s in enumerate(seeds):
        col = ppr[:, j]
        nbr = int(np.argsort(-col, kind="stable")[1])
        ppr_rows.append((s, float(col[s]), nbr))
        log(f"PPR from seed {s}: self-mass={col[s]:.4f}, "
            f"top neighbour={nbr}")
    return {"n": g.n, "m": g.m, "rounds": sched.rounds, "errors": errors,
            "iterations": iterations, "top5": top.tolist(), "ppr": ppr_rows,
            "pi": pi, "ppr_pi": ppr, "truth": truth}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    return run(args.device)


if __name__ == "__main__":
    main()
