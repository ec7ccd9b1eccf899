"""Serving launcher for the port's online Personalized-PageRank service.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch pagerank-serve \
        --smoke --requests 64 [--max-batch N] [--engine MODE] \
        [--adaptive | --fixed-rounds] [--device cuda|cpu]

Builds the service from `configs/pagerank_serve.py`, submits seeded
queries (about 10% of them repeated to exercise the cache), drains them,
and prints the per-graph engine, the rounds used against the Formula 8
bound, and the number of queries served. The device defaults to cuda.
Edge updates (`--updates`) come with the updates slice and are rejected.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import replace

import numpy as np

from repro_torch.configs import pagerank_serve

ARCHS = {pagerank_serve.NAME: pagerank_serve}


def serve_pagerank(mod, args) -> dict:
    """Seeded query workload through the PPR micro-batching service.
    Returns the service's stats plus the per-graph engines."""
    from repro_torch.serve.pagerank_service import PPRQuery

    cfg = mod.serve_config(smoke=args.smoke)
    if args.max_batch:
        cfg = replace(cfg, max_batch=args.max_batch)
    if args.engine:
        cfg = replace(cfg, engine=args.engine)
    if args.adaptive is not None:
        cfg = replace(cfg, adaptive=args.adaptive)
    svc = mod.make_service(cfg, device=args.device)
    names = svc.registry.names()
    engines = {name: svc.registry.get(name).engine.name for name in names}
    print(f"device: {svc.registry.device}")
    print(f"warm graphs + engines: {engines}")
    rng = np.random.default_rng(0)
    queries = []
    for i in range(args.requests):
        name = names[int(rng.integers(0, len(names)))]
        n = svc.registry.get(name).n
        seeds = tuple(int(s) for s in
                      rng.choice(n, int(rng.integers(1, 4)), replace=False))
        queries.append(PPRQuery(qid=i, graph=name, seeds=seeds, c=cfg.c,
                                tol=cfg.tol, top_k=min(8, cfg.max_top_k)))
    repeats = [PPRQuery(qid=args.requests + j, graph=q.graph, seeds=q.seeds,
                        c=q.c, tol=q.tol, top_k=q.top_k)
               for j, q in enumerate(queries[:max(1, args.requests // 10)])]
    t0 = time.perf_counter()
    results = {}
    for q in queries:
        svc.submit(q)
    results.update(svc.run_until_drained())
    for q in repeats:
        svc.submit(q)
    results.update(svc.run_until_drained())
    dt = time.perf_counter() - t0
    st = svc.stats
    mode = "adaptive" if svc.adaptive else "fixed"
    print(f"served {len(results)} queries in {dt:.3f}s ({mode}): "
          f"{st['solves']} solves, {st['cache_hits']} cache hits")
    print(f"rounds used {st['rounds_used']} / bound {st['rounds_bound']}")
    return dict(st, served=len(results), engines=engines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=None,
                    help="micro-batch width override (default from config)")
    ap.add_argument("--engine", default=None,
                    choices=["auto", "tuned", "coo", "hub-tail", "block_ell",
                             "fused", "sharded-1d", "sharded-2d"],
                    help="solve-engine override (default from config); "
                         "tuned, hub-tail and sharded-* are not ported yet "
                         "and raise")
    ap.add_argument("--adaptive", dest="adaptive", action="store_true",
                    default=None,
                    help="residual-controlled ticks (default from config)")
    ap.add_argument("--fixed-rounds", dest="adaptive", action="store_false",
                    help="always run the a-priori round count per tick")
    ap.add_argument("--device", default=None,
                    help="torch device for graphs and solves (default cuda)")
    ap.add_argument("--updates", type=int, default=0,
                    help="edge-update batches: not ported yet, must be 0")
    args = ap.parse_args(argv)
    if args.updates:
        raise SystemExit("--updates: edge updates are not ported to "
                         "repro_torch yet (ROADMAP A6)")
    return serve_pagerank(ARCHS[args.arch], args)


if __name__ == "__main__":
    main()
