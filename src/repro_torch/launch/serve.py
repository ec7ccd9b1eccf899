"""Serving launcher of the port: batched greedy decoding for the LM
archs, or the online Personalized-PageRank service.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b \
        --smoke --requests 8 [--max-batch N] [--max-len L] \
        [--max-new-tokens T] [--device cuda|cpu]

    PYTHONPATH=src python -m repro_torch.launch.serve --arch pagerank-serve \
        --smoke --requests 64 --updates 2 [--max-batch N] [--engine MODE] \
        [--tune-cache PATH] [--tune-budget S] [--tune-require-cached] \
        [--adaptive | --fixed-rounds] [--scheduler fifo|deadline] \
        [--async-dispatch] [--metrics-port P] [--metrics-json PATH] \
        [--profile-dir DIR] [--device cuda|cpu] [--mesh-grid RxC]

    torchrun --nproc-per-node N -m repro_torch.launch.serve \
        --arch pagerank-serve --smoke --engine sharded-2d --mesh-grid RxC

`--arch` resolves through `configs.registry.get` (KeyError for a name it
does not know); an arch that is neither an LM nor pagerank-serve exits
with the reference's message. The LM serving path runs under no mesh, as
the reference's does, so an all-to-all MoE config serves densely.

An LM arch (h2o-danube-1.8b, granite-moe-3b-a800m, deepseek-7b,
qwen2.5-32b, qwen3-moe-235b-a22b) builds random weights from generator
seed 0 (`--smoke`: the arch's reduced config), a `ServeEngine` of
`--max-batch` slots (default 4) of `--max-len` positions, and drains
`--requests` requests with prompts of 3-15 seeded tokens, then prints
the requests, tokens, seconds and tokens per second.

For pagerank-serve it builds the service from
`configs/pagerank_serve.py`, submits seeded queries, drains them, applies
`--updates` single-edge insert batches (alternating over the graphs),
submits about 10% of the queries again and drains, then prints the
per-graph engine, the rounds used against the Formula 8 bound, the
service counters and the metrics summary. With
`--metrics-json` the final snapshot is written and validated (an invalid
one exits non-zero); `--metrics-port` serves /metrics and /metrics.json
while the workload runs; `--profile-dir` wraps the workload in the
PyTorch profiler and writes a Chrome trace there. The device defaults to
cuda.

Under torchrun (WORLD_SIZE > 1) every rank starts the process group
(NCCL on cuda, gloo on cpu) and builds the same service; rank 0 runs the
workload and prints, the other ranks follow its plans (the service's
lockstep) until it closes. `--engine sharded-1d | sharded-2d` shards each
graph over the ranks, `--mesh-grid RxC` sets sharded-2d's grid (R * C =
N); auto shards a graph once it clears the sharding bar.
"""
from __future__ import annotations

import argparse
import os
import time
from dataclasses import replace

import numpy as np
import torch.distributed as dist

from repro_torch.configs.registry import get
from repro_torch.core.distributed import init_process_group, rank


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
    if args.tune_cache:
        cfg = replace(cfg, tune_cache=args.tune_cache)
    if args.tune_budget is not None:
        cfg = replace(cfg, tune_budget_s=args.tune_budget)
    if args.tune_require_cached:
        cfg = replace(cfg, tune_require_cached=True)
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
    if args.mesh_grid:
        r, _, c = args.mesh_grid.lower().partition("x")
        if not (r.isdigit() and c.isdigit()):
            raise SystemExit(f"--mesh-grid {args.mesh_grid!r}: expected RxC")
        cfg = replace(cfg, mesh_grid=(int(r), int(c)))
    return cfg


def serve_lm(mod, args) -> dict:
    """Seeded requests through a ServeEngine over random weights, drained;
    returns {"requests", "tokens", "seconds", "tok_s", "engine",
    "requests_done"}."""
    import torch

    from repro_torch.device import resolve_device
    from repro_torch.models import transformer as tf
    from repro_torch.serve.engine import Request, ServeEngine

    dev = resolve_device(args.device)
    cfg = mod.smoke_config() if args.smoke else mod.full_config()
    params = tf.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    engine = ServeEngine(params, cfg, args.max_batch or 4, args.max_len,
                         device=dev)
    del params       # the engine holds its compute-dtype copy
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab,
                                        int(rng.integers(3, 16))).astype(
                                            np.int32),
                    max_new_tokens=args.max_new_tokens)
            for i in range(args.requests)]
    t0 = time.perf_counter()
    engine.run_until_drained(reqs)
    dt = time.perf_counter() - t0
    total = sum(len(r.out_tokens) for r in reqs)
    print(f"served {len(reqs)} requests, {total} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s) on {dev}")
    return {"requests": len(reqs), "tokens": total, "seconds": dt,
            "tok_s": total / dt, "engine": engine, "requests_done": reqs}


def serve_pagerank(mod, args) -> dict:
    """Mixed query/update workload through the PPR micro-batching service.
    Returns the service's stats plus the per-graph engines on rank 0, and
    {"followed": plans run} on the other ranks."""
    cfg = _config(mod, args)
    svc = mod.make_service(cfg, device=args.device)
    if rank() != 0:
        return {"followed": svc.follow()}
    try:
        return _workload(svc, cfg, args)
    finally:
        svc.close()


def _workload(svc, cfg, args) -> dict:
    """Rank 0's side of `serve_pagerank`."""
    from repro_torch.serve.pagerank_service import PPRQuery

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
    from repro_torch.obs import (MetricsServer, render_summary,
                                 validate_snapshot, write_snapshot)
    from repro_torch.obs.trace import profiled

    server = None
    if args.metrics_port is not None:
        server = MetricsServer(svc.metrics.registry, port=args.metrics_port,
                               convergence=svc.metrics.convergence,
                               tracer=svc.metrics.tracer).start()
        print(f"metrics: http://127.0.0.1:{server.port}/metrics "
              f"(and /metrics.json)")
    try:
        t0 = time.perf_counter()
        results = {}
        with profiled(args.profile_dir):
            for q in queries:
                svc.submit(q)
            results.update(svc.run_until_drained())  # warm before churn
            for u in range(args.updates):
                name = names[u % len(names)]
                # rg.n, not rg.host.n: reading .host after an in-place patch
                # would materialize the lazy host Graph on every batch
                n = svc.registry.get(name).n
                edge = (int(rng.integers(0, n // 2)),
                        int(rng.integers(n // 2, n)))
                svc.update_graph(name, insert=[edge])
            for q in repeats:
                svc.submit(q)
            results.update(svc.run_until_drained())
        dt = time.perf_counter() - t0
    finally:
        if server is not None:
            server.stop()
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
    # one snapshot feeds the summary below and the JSON dump
    meta = {"elapsed_s": dt, "arch": args.arch, "mode": mode,
            "scheduler": svc.policy, "async_dispatch": svc.async_dispatch,
            "update_mode": svc.registry.update_mode, "engines": engines,
            "device": str(svc.registry.device), "served": len(results)}
    if svc.registry.tuner is not None:
        meta["tune_decisions"] = dict(svc.registry.tuner.decision_counts)
    snap = svc.snapshot(meta)
    if args.metrics_json:
        write_snapshot(args.metrics_json, svc.metrics.registry,
                       convergence=svc.metrics.convergence,
                       tracer=svc.metrics.tracer, meta=meta)
        errs = validate_snapshot(snap)
        if errs:
            raise SystemExit("metrics snapshot failed validation:\n  "
                             + "\n  ".join(errs))
        print(f"metrics snapshot -> {args.metrics_json}")
    print(render_summary(snap))
    return dict(st, served=len(results), engines=engines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    help="an LM arch or pagerank-serve (configs/registry.py)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--updates", type=int, default=0,
                    help="edge-update batches between the two drains")
    ap.add_argument("--max-batch", type=int, default=None,
                    help="LM: engine slots (default 4); pagerank: "
                         "micro-batch width override (default from config)")
    ap.add_argument("--max-len", type=int, default=64,
                    help="LM: positions per engine slot")
    ap.add_argument("--max-new-tokens", type=int, default=8,
                    help="LM: tokens decoded per request")
    ap.add_argument("--engine", default=None,
                    choices=["auto", "tuned", "coo", "hub-tail", "block_ell",
                             "fused", "sharded-1d", "sharded-2d"],
                    help="solve-engine override (default from config); "
                         "tuned measures the engine per graph through the "
                         "tuning store; sharded-* shard each graph over "
                         "the ranks (run under torchrun for more than one)")
    ap.add_argument("--mesh-grid", default=None, metavar="RxC",
                    help="sharded-2d's rank grid, R * C = world size "
                         "(default: the most-square factorization)")
    ap.add_argument("--tune-cache", default=None, metavar="PATH",
                    help="tuning-store path for --engine tuned (default "
                         "$REPRO_TORCH_TUNE_CACHE or ~/.cache/repro_torch/"
                         "tuning.json)")
    ap.add_argument("--tune-budget", type=float, default=None,
                    metavar="SECONDS",
                    help="per-graph measurement budget for --engine tuned "
                         "(default from config)")
    ap.add_argument("--tune-require-cached", action="store_true",
                    help="--engine tuned never measures: a store miss takes "
                         "the heuristic's engine")
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
    ap.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                    help="serve Prometheus text at /metrics and the JSON "
                         "snapshot at /metrics.json on this port while the "
                         "workload runs (0 = ephemeral)")
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="write the final metrics snapshot (metrics, "
                         "convergence telemetry, recent traces) as JSON, "
                         "validated before exit")
    ap.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="wrap the workload in torch.profiler and write a "
                         "Chrome trace to DIR")
    ap.add_argument("--device", default=None,
                    help="torch device for weights, graphs and solves "
                         "(default cuda)")
    args = ap.parse_args(argv)
    mod = get(args.arch)
    if getattr(mod, "FAMILY", None) == "lm":
        return serve_lm(mod, args)
    if not hasattr(mod, "serve_config"):
        raise SystemExit(
            f"--arch {args.arch} (family {getattr(mod, 'FAMILY', '?')}) is "
            f"not servable; use an LM arch or pagerank-serve")
    started = False
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 and \
            not dist.is_initialized():
        init_process_group(args.device)   # torchrun: one process per rank
        started = True
    try:
        return serve_pagerank(mod, args)
    finally:
        if started:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
