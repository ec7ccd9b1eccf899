"""Serving launcher for the port's online Personalized-PageRank service.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch pagerank-serve \
        --smoke --requests 64 --updates 2 [--max-batch N] [--engine MODE] \
        [--adaptive | --fixed-rounds] [--scheduler fifo|deadline] \
        [--async-dispatch] [--device cuda|cpu]

Builds the service from `configs/pagerank_serve.py`, submits seeded
queries, drains them, applies `--updates` single-edge insert batches
(alternating over the graphs), submits about 10% of the queries again and
drains, then prints the per-graph engine, the rounds used against the
Formula 8 bound and the service counters. The device defaults to cuda.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import replace

import numpy as np

from repro_torch.configs import pagerank_serve

ARCHS = {pagerank_serve.NAME: pagerank_serve}


def _parse_tenants(specs) -> tuple:
    """--tenant name:priority:deadline_s[:max_depth] rows."""
    rows = []
    for spec in specs:
        parts = spec.split(":")
        if len(parts) not in (3, 4):
            raise SystemExit(f"--tenant {spec!r}: expected "
                             "name:priority:deadline_s[:max_depth]")
        name, prio, dl = parts[0], int(parts[1]), parts[2]
        depth = int(parts[3]) if len(parts) == 4 else None
        rows.append((name, prio,
                     None if dl in ("inf", "none", "") else float(dl), depth))
    return tuple(rows)


def _config(mod, args):
    """The config with every command-line override applied."""
    cfg = mod.serve_config(smoke=args.smoke)
    if args.max_batch:
        cfg = replace(cfg, max_batch=args.max_batch)
    if args.engine:
        cfg = replace(cfg, engine=args.engine)
    if args.weight_dtype:
        cfg = replace(cfg, weight_dtype=None
                      if args.weight_dtype == "float32" else args.weight_dtype)
    if args.adaptive is not None:
        cfg = replace(cfg, adaptive=args.adaptive)
    if args.update_mode:
        cfg = replace(cfg, update_mode=args.update_mode)
    if args.invalidation_radius is not None:
        # negative = blanket flush
        cfg = replace(cfg, invalidation_radius=args.invalidation_radius
                      if args.invalidation_radius >= 0 else None)
    if args.scheduler:
        cfg = replace(cfg, scheduler=args.scheduler)
    if args.tenant:
        cfg = replace(cfg, tenants=_parse_tenants(args.tenant))
    if args.deadline is not None:
        cfg = replace(cfg, default_deadline_s=args.deadline
                      if args.deadline > 0 else None)
    if args.admission_depth is not None:
        cfg = replace(cfg, admission_depth=args.admission_depth
                      if args.admission_depth > 0 else None)
    if args.slack_margin is not None:
        cfg = replace(cfg, slack_margin_s=args.slack_margin)
    if args.async_dispatch is not None:
        cfg = replace(cfg, async_dispatch=args.async_dispatch)
    return cfg


def serve_pagerank(mod, args) -> dict:
    """Mixed query/update workload through the PPR micro-batching service.
    Returns the service's stats plus the per-graph engines."""
    from repro_torch.serve.pagerank_service import PPRQuery

    cfg = _config(mod, args)
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
    results.update(svc.run_until_drained())   # warm the cache before churn
    for u in range(args.updates):
        name = names[u % len(names)]
        # rg.n, not rg.host.n: reading .host after an in-place patch would
        # materialize the lazy host Graph on every batch
        n = svc.registry.get(name).n
        edge = (int(rng.integers(0, n // 2)), int(rng.integers(n // 2, n)))
        svc.update_graph(name, insert=[edge])
    for q in repeats:
        svc.submit(q)
    results.update(svc.run_until_drained())
    dt = time.perf_counter() - t0
    st = svc.stats
    mode = "adaptive" if svc.adaptive else "fixed"
    dispatch = "async" if svc.async_dispatch else "sync"
    print(f"served {len(results)} queries in {dt:.3f}s ({mode}, "
          f"{svc.policy} scheduler, {dispatch} dispatch, "
          f"{svc.registry.update_mode} updates): {st['solves']} solves, "
          f"{st['cache_hits']} cache hits")
    print(f"rounds used {st['rounds_used']} / bound {st['rounds_bound']}")
    print(f"updates {st['updates']} ({st['incremental_updates']} "
          f"incremental, {st['noop_updates']} no-op); cache dropped "
          f"{st['cache_dropped']}, retained {st['cache_retained']}, "
          f"refreshed {st['refreshes']}; deadline misses "
          f"{st['deadline_misses']}, held ticks {st['held_ticks']}")
    return dict(st, served=len(results), engines=engines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--updates", type=int, default=0,
                    help="edge-update batches between the two drains")
    ap.add_argument("--max-batch", type=int, default=None,
                    help="micro-batch width override (default from config)")
    ap.add_argument("--engine", default=None,
                    choices=["auto", "tuned", "coo", "hub-tail", "block_ell",
                             "fused", "sharded-1d", "sharded-2d"],
                    help="solve-engine override (default from config); "
                         "tuned and sharded-* are not ported yet and raise")
    ap.add_argument("--weight-dtype", default=None,
                    choices=["float32", "bfloat16"],
                    help="packed edge-weight storage dtype (accumulation "
                         "stays f32; default from config)")
    ap.add_argument("--adaptive", dest="adaptive", action="store_true",
                    default=None,
                    help="residual-controlled ticks (default from config)")
    ap.add_argument("--fixed-rounds", dest="adaptive", action="store_false",
                    help="always run the a-priori round count per tick")
    ap.add_argument("--update-mode", default=None,
                    choices=["incremental", "rebuild"],
                    help="edge-update path: patch the device arrays in "
                         "place or rebuild per batch (default from config)")
    ap.add_argument("--invalidation-radius", type=int, default=None,
                    help="drop only cached results seeded within this many "
                         "hops of an update; negative = blanket flush "
                         "(default from config)")
    ap.add_argument("--scheduler", default=None, choices=["fifo", "deadline"],
                    help="query scheduling policy (default from config)")
    ap.add_argument("--tenant", action="append", default=None,
                    metavar="NAME:PRIO:DL[:DEPTH]",
                    help="declare a tenant class, repeatable: name, "
                         "priority, default latency budget in seconds (inf "
                         "= no SLO), optional admission depth")
    ap.add_argument("--deadline", type=float, default=None,
                    help="default latency budget in seconds for queries "
                         "whose tenant declares none (<= 0 = unbounded)")
    ap.add_argument("--admission-depth", type=int, default=None,
                    help="per-tenant queued-query bound (<= 0 = unbounded)")
    ap.add_argument("--slack-margin", type=float, default=None,
                    help="deadline safety margin in seconds")
    ap.add_argument("--async-dispatch", dest="async_dispatch",
                    action="store_true", default=None,
                    help="overlap host batching for tick k+1 with the "
                         "device work of tick k")
    ap.add_argument("--sync-dispatch", dest="async_dispatch",
                    action="store_false",
                    help="dispatch and fence each batch in its own tick")
    ap.add_argument("--device", default=None,
                    help="torch device for graphs and solves (default cuda)")
    args = ap.parse_args(argv)
    return serve_pagerank(ARCHS[args.arch], args)


if __name__ == "__main__":
    main()
