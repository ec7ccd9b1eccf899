"""Online personalized-PageRank serving demo: a mixed query/update workload
(the port's counterpart of `examples/serve_pagerank.py`).

    PYTHONPATH=src python -m repro_torch.launch.serve_pagerank [--device cpu]

Walks through the service surface: two warm graphs in the registry, 24
seed-set queries drained as micro-batches, a cache hit on a repeat, an
edge insert that bumps the graph's epoch and invalidates its cached
results, and the re-query on the new epoch. Without `--device` it runs on
cuda and raises on a host without a GPU.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.graph import generators
from repro_torch.serve import GraphRegistry, PageRankService, PPRQuery

__all__ = ["run", "main"]


def run(device=None, log=print) -> dict:
    """The example's run on `device` (None = cuda). Returns what it prints:
    the query count, the results by qid, the repeat's answer, the epoch
    after the insert, the re-query, the top-k score drift, the service's
    stats and the cache's."""
    dev = resolve_device(device)
    registry = GraphRegistry(device=dev)
    registry.register("mesh", generators.tri_mesh(40, 50))
    registry.register("social", generators.powerlaw_ba(1500, 4, seed=1))
    svc = PageRankService(registry, max_batch=16, cache_capacity=1024,
                          max_top_k=8)
    for name in registry.names():
        g = registry.get(name).host
        log(f"graph {name!r}: n={g.n}, m={g.m}, epoch=0, "
            f"engine {type(registry.get(name).engine).__name__}")

    # -- a burst of queries drains as micro-batches -------------------------
    rng = np.random.default_rng(0)
    queries = []
    for i in range(24):
        name = "mesh" if i % 2 else "social"
        n = registry.get(name).host.n
        seeds = tuple(int(s) for s in rng.choice(n, 2, replace=False))
        queries.append(PPRQuery(qid=i, graph=name, seeds=seeds, top_k=5))
    for q in queries:
        svc.submit(q)
    results = svc.run_until_drained()
    st = svc.stats
    log(f"\n{len(queries)} queries -> {st['solves']} batched solves "
        f"(avg B={st['solved_queries'] / st['solves']:.1f})")
    r0 = results[0]
    log(f"query 0 (graph={r0.graph}, seeds={queries[0].seeds}): "
        f"top-5 vertices {r0.indices.tolist()} "
        f"scores {np.round(r0.scores, 4).tolist()}")

    # -- repeats are served from the LRU cache ------------------------------
    again = svc.submit(PPRQuery(qid=100, graph=r0.graph,
                                seeds=queries[0].seeds, top_k=5))
    log(f"\nrepeat of query 0: cached={again.cached} "
        f"(solves still {svc.stats['solves']})")

    # -- an edge-update batch bumps the epoch and invalidates ---------------
    hub = int(r0.indices[0])
    n0 = registry.get(r0.graph).host.n
    far = (hub + n0 // 2) % n0
    epoch = svc.update_graph(r0.graph, insert=[(hub, far)])
    log(f"\ninserted edge ({hub}, {far}) on {r0.graph!r}: epoch -> {epoch}, "
        f"cache invalidations={svc.cache.invalidations}")
    fresh = svc.query(r0.graph, queries[0].seeds, top_k=5)
    log(f"re-query after update: cached={fresh.cached}, "
        f"epoch={fresh.epoch}, top-5 {fresh.indices.tolist()}")
    drift = float(np.max(np.abs(fresh.scores - r0.scores)))
    log(f"top-k score drift from the update: {drift:.2e}")

    stats, cache = svc.stats, svc.cache.stats()
    log(f"\nfinal stats: {stats}")
    log(f"cache: {cache}")
    return {"queries": queries, "results": results, "again": again,
            "epoch": epoch, "fresh": fresh, "drift": drift,
            "stats": stats, "cache": cache}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    return run(args.device)


if __name__ == "__main__":
    main()
