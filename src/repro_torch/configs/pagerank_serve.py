"""pagerank-serve — the online PPR query service as a config (port of
`repro.configs.pagerank_serve`).

`PPRServeConfig`, `full_config`, `smoke_config` and `serve_config` are
copies of the reference's; `make_service` builds the port's registry and
service on a device (None = cuda), with the engine (measured selection
"tuned" and its `tune_*` knobs included), ingestion chunk, update, cache,
refresh, metrics-detail, scheduling and sharded-engine knobs
(`mesh_grid`, `partition_lane`) wired as in the reference. With a sharded
engine every rank calls `make_service`; rank 0 then drives the service
and the other ranks run its `follow()` loop. It has no cells: an online
workload, not an (arch x shape) cell.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.graph import generators

NAME = "pagerank-serve"
FAMILY = "pagerank"


@dataclass(frozen=True)
class PPRServeConfig:
    # (registry name, generators.PAPER_DATASETS key, scale)
    graphs: tuple[tuple[str, str, float], ...]
    c: float = 0.85
    tol: float = 1e-4
    max_batch: int = 32
    cache_capacity: int = 4096
    max_top_k: int = 16
    # solve-engine format: "auto", "tuned" (measured selection through the
    # port's tuning store), "coo", "hub-tail", "block_ell", "fused",
    # "sharded-1d", "sharded-2d" (auto shards at world size >= 2 once a
    # graph clears the sharding bar)
    engine: str = "auto"
    # tuned mode only: tuning-store path (None = $REPRO_TORCH_TUNE_CACHE or
    # ~/.cache/repro_torch/tuning.json), per-graph measurement budget in
    # seconds, and whether a store miss falls back to the heuristic
    tune_cache: str | None = None
    tune_budget_s: float = 2.0
    tune_require_cached: bool = False
    # packed storage dtype for COO edge weights and hub/tail's inv_deg
    # ("bfloat16"); None = f32
    weight_dtype: str | None = None
    # host->device transfer chunk (edges) at registration; None = one shot
    ingest_chunk_edges: int | None = None
    # sharded-2d's (R, C) grid (None = most-square factorization of the
    # world size) and the sharded partitions' padding lane
    mesh_grid: tuple[int, int] | None = None
    partition_lane: int = 128
    # residual-controlled ticks (the Formula 8 round count stays the cap)
    adaptive: bool = True
    adaptive_chunk: int | None = None
    update_mode: str = "incremental"
    invalidation_radius: int | None = 2
    refresh_batch: int = 8
    refresh_rounds: int = 8
    # observability depth: True arms latency/stage histograms, per-query
    # traces and convergence telemetry; False keeps only the counters
    metrics_detail: bool = True
    scheduler: str = "fifo"
    # tenant classes as (name, priority, deadline_s, max_depth) rows
    tenants: tuple[tuple[str, int, float | None, int | None], ...] = ()
    default_deadline_s: float | None = None
    admission_depth: int | None = None
    slack_margin_s: float = 0.0
    async_dispatch: bool = False


def full_config() -> PPRServeConfig:
    """Production-shaped point: two warm graphs, 128-wide micro-batches."""
    return PPRServeConfig(
        graphs=(("naca", "NACA0015", 1.0), ("kmer", "kmer-V2", 1.0)),
        max_batch=128, cache_capacity=65536, max_top_k=32)


def smoke_config() -> PPRServeConfig:
    return PPRServeConfig(graphs=(("mesh", "NACA0015", 0.12),),
                          max_batch=8, cache_capacity=256, max_top_k=8)


def serve_config(smoke: bool = False) -> PPRServeConfig:
    return smoke_config() if smoke else full_config()


def cells():
    return []  # online serving workload; not an (arch x shape) cell


def make_service(cfg: PPRServeConfig, device=None):
    """Registry with every configured graph warm + the service over it, on
    `device` (None = cuda; raises without a GPU)."""
    from repro_torch.serve.graph_registry import GraphRegistry
    from repro_torch.serve.pagerank_service import PageRankService, \
        ServeMetrics
    from repro_torch.serve.scheduler import TenantSpec
    reg = GraphRegistry(device=device, engine=cfg.engine,
                        batch_hint=cfg.max_batch,
                        update_mode=cfg.update_mode,
                        weight_dtype=cfg.weight_dtype,
                        ingest_chunk_edges=cfg.ingest_chunk_edges,
                        tune_cache=cfg.tune_cache,
                        tune_budget_s=cfg.tune_budget_s,
                        tune_require_cached=cfg.tune_require_cached,
                        grid=cfg.mesh_grid,
                        partition_lane=cfg.partition_lane)
    for name, dataset, scale in cfg.graphs:
        reg.register(name, generators.paper_dataset(dataset, scale))
    tenants = [TenantSpec(name=n, priority=p,
                          deadline_s=math.inf if d is None else float(d),
                          max_depth=md)
               for n, p, d, md in cfg.tenants]
    svc = PageRankService(reg, max_batch=cfg.max_batch,
                          cache_capacity=cfg.cache_capacity,
                          max_top_k=cfg.max_top_k,
                          adaptive=cfg.adaptive,
                          adaptive_chunk=cfg.adaptive_chunk,
                          invalidation_radius=cfg.invalidation_radius,
                          refresh_batch=cfg.refresh_batch,
                          refresh_rounds=cfg.refresh_rounds,
                          metrics=ServeMetrics(detail=cfg.metrics_detail),
                          scheduler=cfg.scheduler, tenants=tenants,
                          default_deadline_s=cfg.default_deadline_s,
                          admission_depth=cfg.admission_depth,
                          slack_margin_s=cfg.slack_margin_s,
                          async_dispatch=cfg.async_dispatch)
    reg.schedule(cfg.c, cfg.tol)  # precompute the coefficient vector
    return svc
