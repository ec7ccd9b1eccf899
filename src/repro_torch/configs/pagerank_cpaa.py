"""cpaa-pagerank — the paper's own workload as a config (port of
`repro.configs.pagerank_cpaa`).

Shapes (synthetic, matched to the paper's dataset families at cluster
scale):
  pr_mesh_67m      n=2^26, deg 6 (NACA/M6/NLR-like mesh), 1D partition
  pr_kmer_550m     n=5.5e8, deg 2.13 (kmer-V2 x10), 1D partition
  pr_mesh_67m_b128 n=2^26, deg 6, 128 personalization columns (the
                   batched-SpMM adaptation)
  pr_mesh_67m_2d   n=2^26, deg 6, 2D grid partition (beyond-paper comm
                   optimization: all-gather O(n) -> O(n/R + n/C))

Rounds: 12 (= ERR < 1e-3 at c=0.85, the paper's Table 2 operating point).

The constants, `SHAPES`, the abstract partitions, `full_config`,
`smoke_config` and `model_flops` are copies of the reference's;
`smoke_run` solves on a device through the port's `select_engine`;
`cells` lists one cell per shape. `build` is a cell's dry-run plan: the
fixed-round distributed CPAA over edge arrays stacked as the production
mesh's partition ([n_dev, E] or [R, C, E]); `static["step_builder"](mesh)`
makes the step for a mesh:
  * of more than one rank (the production mesh, on a fake world in
    `launch/dryrun.py`): the reference's production step, each rank on
    its own pieces of the vectors and its [1, E] / [1, 1, E] edge slice
    (`core.distributed.cpaa_local_1d` / `_2d`; the 2D grid on the
    mesh's (rows, "model") view, `grid_view`, rows ("pod", "data") on
    two pods);
  * of one rank (the card): the whole-vector builders
    (`cpaa_distributed_1d` / `_2d`) over all the shards merged into one,
    on the first call with them, the merged copy reused after.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import Cell, DryRunPlan, meta
from repro_torch.core import distributed as dist
from repro_torch.core.chebyshev import make_schedule
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import P

NAME = "cpaa-pagerank"
FAMILY = "pagerank"

C = 0.85
TOL = 1e-3
LANE = 128
IMBALANCE = 1.15   # per-rank edge-count padding factor
# solve-engine format ("auto" | "tuned" | "coo" | "block_ell" | "fused" |
# "sharded-1d" | "sharded-2d"); smoke_run and local solves route through
# core/engine.select_engine — "auto" shards when the process group has
# >= 2 ranks and the graph clears the collective-amortization bar; "tuned"
# consults the core/autotune measured-selection store instead.
ENGINE = "auto"
# sharded-engine mesh knobs for smoke_run/local solves: (R, C) grid for
# sharded-2d (None = most-square factorization of the world size) and the
# partition padding lane.
MESH_GRID = None
PARTITION_LANE = 128
# residual-controlled solves: exit when the measured chunked L1 residual
# reaches TOL instead of always running the a-priori round count (which
# stays the hard cap); None chunk = core.chebyshev.default_chunk(C, TOL).
ADAPTIVE = True
ADAPTIVE_CHUNK = None

SHAPES = {
    "pr_mesh_67m": dict(kind="pagerank", n=1 << 26, deg=6.0, batch=None,
                        partition="1d"),
    "pr_kmer_550m": dict(kind="pagerank", n=550_000_000, deg=2.13,
                         batch=None, partition="1d"),
    "pr_mesh_67m_b128": dict(kind="pagerank", n=1 << 26, deg=6.0, batch=128,
                             partition="1d"),
    "pr_mesh_67m_2d": dict(kind="pagerank", n=1 << 26, deg=6.0, batch=None,
                           partition="2d"),
    # beyond-paper: bf16 wire format for the row all-gather (halves the
    # dominant collective; reductions stay f32). Rank-stable for tol>=1e-2
    # targets.
    "pr_mesh_67m_2d_bf16": dict(kind="pagerank", n=1 << 26, deg=6.0,
                                batch=None, partition="2d",
                                comm_dtype="bfloat16"),
    # beyond-paper: 2D partition x 128 personalization columns
    "pr_mesh_67m_2d_b128": dict(kind="pagerank", n=1 << 26, deg=6.0,
                                batch=128, partition="2d"),
}


@dataclass(frozen=True)
class _AbstractPart1D:
    n: int
    n_orig: int
    n_dev: int
    rows_per_dev: int
    edges_per_dev: int


@dataclass(frozen=True)
class _AbstractPart2D:
    n: int
    n_orig: int
    grid: tuple[int, int]
    rows_per_chunk: int
    cols_per_chunk: int
    sub: int
    edges_per_dev: int


def _round_up(x, q):
    return ((x + q - 1) // q) * q


def abstract_partition_1d(n_orig: int, m: int, n_dev: int) -> _AbstractPart1D:
    n = _round_up(n_orig, n_dev * LANE)
    e_pad = _round_up(int(m / n_dev * IMBALANCE), LANE)
    return _AbstractPart1D(n=n, n_orig=n_orig, n_dev=n_dev,
                           rows_per_dev=n // n_dev, edges_per_dev=e_pad)


def abstract_partition_2d(n_orig: int, m: int, grid) -> _AbstractPart2D:
    r, c = grid
    n = _round_up(n_orig, r * c * LANE)
    e_pad = _round_up(int(m / (r * c) * IMBALANCE), LANE)
    return _AbstractPart2D(n=n, n_orig=n_orig, grid=grid,
                           rows_per_chunk=n // r, cols_per_chunk=n // c,
                           sub=n // (r * c), edges_per_dev=e_pad)


def full_config():
    return {"c": C, "tol": TOL, "rounds": make_schedule(C, TOL).rounds,
            "engine": ENGINE, "mesh_grid": MESH_GRID,
            "partition_lane": PARTITION_LANE,
            "adaptive": ADAPTIVE, "adaptive_chunk": ADAPTIVE_CHUNK}


def smoke_config():
    return full_config()


def cells():
    return [Cell(shape=s, kind="pagerank") for s in SHAPES]


def model_flops(n: int, m: int, rounds: int, batch: int | None) -> float:
    """Paper §4.2.3: m mults + (m + 2n) adds per iteration (per column)."""
    b = batch or 1
    return rounds * (2.0 * m + 2.0 * n) * b


def _merge_1d(part, src, dst_local, weight):
    """A block of k stacked 1D shards [k, E] (rows_per_dev rows each) as
    one shard of k * rows_per_dev rows: chunk-local destinations offset by
    their shard's first row, every array flattened."""
    off = torch.arange(src.shape[0], dtype=torch.int32,
                       device=src.device) * part.rows_per_dev
    return (src.reshape(-1), (dst_local + off[:, None]).reshape(-1),
            weight.reshape(-1))


def _merge_2d(part, src_local, dst_local, weight):
    """The [R, C, E] shards of a 2D partition as the one shard of the
    (1, 1) grid, whose column layout is the identity: the nested column
    index back to the global vertex, destinations offset by their row
    chunk."""
    r, c = part.grid
    rows, sub = part.rows_per_chunk, part.sub
    dev = src_local.device
    r_off = torch.arange(r, dtype=torch.int64, device=dev)[:, None, None]
    c_off = torch.arange(c, dtype=torch.int64, device=dev)[None, :, None]
    s = src_local.to(torch.int64)
    src = (s // sub) * rows + c_off * sub + s % sub
    dst = dst_local.to(torch.int64) + r_off * rows
    return (src.to(torch.int32).reshape(-1),
            dst.to(torch.int32).reshape(-1), weight.reshape(-1))


def _merged_once(solve, merge):
    """step(p, *edges) = solve(p, *merge(*edges)), the merge made on the
    first call with a given set of edge tensors and reused while the same
    tensors come back: the merge is a change of the arguments' layout, not
    the solver's work, so the dry-run's warm-up pays it and its counted
    and timed steps do not."""
    memo = {"edges": (), "merged": None}

    def step(p, *edges):
        if len(edges) != len(memo["edges"]) or any(
                a is not b for a, b in zip(edges, memo["edges"])):
            memo["edges"], memo["merged"] = (), None   # old copy freed
            memo["merged"], memo["edges"] = merge(*edges), edges
        return solve(p, *memo["merged"])
    return step


def build(shape: str, multi_pod: bool, _rounds: int | None = None):
    """The dry-run plan of one cell. `static["make_args"](seed, device)`
    draws the stacked partition: sources uniform over the real vertices,
    destinations uniform over each shard's rows, weights 1 / deg; p is the
    uniform personalization (1 / n on every real vertex)."""
    info = SHAPES[shape]
    n, m = info["n"], int(info["n"] * info["deg"])
    sched = make_schedule(C, TOL) if _rounds is None \
        else make_schedule(C, rounds=_rounds)
    batched = info["batch"] is not None
    cdt = info.get("comm_dtype")
    cdt = getattr(torch, cdt) if cdt else None

    if info["partition"] == "1d":
        n_dev = 512 if multi_pod else 256
        part = abstract_partition_1d(n, m, n_dev)
        axes = ("pod", "data", "model") if multi_pod else ("data", "model")
        stack = (n_dev,)
        rows, src_hi = part.rows_per_dev, n

        def step_builder(mesh):
            if mesh.size() > 1:
                return dist.cpaa_local_1d(mesh, part, sched)
            one = _AbstractPart1D(n=part.n, n_orig=part.n_orig, n_dev=1,
                                  rows_per_dev=part.n,
                                  edges_per_dev=n_dev * part.edges_per_dev)
            solve = dist.cpaa_distributed_1d(mesh, one, sched)
            return _merged_once(solve, lambda *e: _merge_1d(part, *e))

        vec_spec = P(axes, None) if batched else P(axes)
        specs = (vec_spec, P(axes), P(axes), P(axes))
    else:
        grid = (32, 16) if multi_pod else (16, 16)
        part = abstract_partition_2d(n, m, grid)
        row_axis = ("pod", "data") if multi_pod else ("data",)
        stack = grid
        rows, src_hi = part.rows_per_chunk, part.cols_per_chunk

        def step_builder(mesh):
            if mesh.size() > 1:
                return dist.cpaa_local_2d(
                    dist.grid_view(mesh, row_axis, "model"), part, sched,
                    comm_dtype=cdt)
            one = _AbstractPart2D(n=part.n, n_orig=part.n_orig, grid=(1, 1),
                                  rows_per_chunk=part.n,
                                  cols_per_chunk=part.n, sub=part.n,
                                  edges_per_dev=(grid[0] * grid[1]
                                                 * part.edges_per_dev))
            solve = dist.cpaa_distributed_2d(mesh, one, sched,
                                             comm_dtype=cdt)
            return _merged_once(solve, lambda *e: _merge_2d(part, *e))

        es = P(row_axis, "model")
        vec_spec = P("model", None) if batched else P("model")
        specs = (vec_spec, es, es, es)

    e = part.edges_per_dev
    vec_shape = (part.n, info["batch"]) if batched else (part.n,)
    args = (meta(vec_shape, torch.float32),
            meta((*stack, e), torch.int32),
            meta((*stack, e), torch.int32),
            meta((*stack, e), torch.float32))

    def make_args(seed: int = 0, device=None):
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        p = torch.zeros(vec_shape, device=dev)
        p[:n] = 1.0 / n
        src = torch.randint(0, min(src_hi, n), (*stack, e), generator=gen,
                            device=dev, dtype=torch.int32)
        dst = torch.randint(0, rows, (*stack, e), generator=gen, device=dev,
                            dtype=torch.int32)
        weight = torch.full((*stack, e), 1.0 / info["deg"], device=dev)
        return p, src, dst, weight

    def probe(L, M):
        return build(shape, multi_pod, _rounds=L)

    plan = DryRunPlan(step=None, abstract_args=args, in_specs=specs,
                      static={"step_builder": step_builder,
                              "make_args": make_args,
                              "compute_dtype": "float32",
                              "out_abstract": meta(vec_shape,
                                                   torch.float32),
                              # the one-rank copy of the edges it keeps
                              "temp_abstract": args[1:]},
                      model_flops=model_flops(n, m, sched.rounds,
                                              info["batch"]),
                      note=f"rounds={sched.rounds} "
                           f"partition={info['partition']}")
    if _rounds is None:
        plan.cost_model = {"L": sched.rounds, "M": 1, "probe": probe}
    return plan


def smoke_run(seed: int = 0, device=None) -> dict:
    """CPAA (fixed + residual-controlled) on a small mesh graph against the
    float64 direct solve, on `device` (None = cuda; raises without a GPU);
    reports the adaptive solver's round savings. At world size >= 2 every
    rank calls it (auto then shards)."""
    import numpy as np
    from repro_torch.core.engine import select_engine
    from repro_torch.core.pagerank import cpaa, cpaa_adaptive, \
        true_pagerank_dense
    from repro_torch.graph import generators
    del seed   # the graph is deterministic, as in the reference
    g = generators.tri_mesh(9, 11)
    eng = select_engine(g, mode=ENGINE, grid=MESH_GRID, lane=PARTITION_LANE,
                        device=device)
    pi = cpaa(eng, C, 1e-8).pi.cpu().numpy().astype(float)
    pi_true = true_pagerank_dense(g, C)
    res_a = cpaa_adaptive(eng, C, 1e-8, chunk=ADAPTIVE_CHUNK)
    err_a = np.max(np.abs(res_a.pi.cpu().numpy().astype(float) - pi_true)
                   / pi_true)
    return {"max_rel_err": np.float32(np.max(np.abs(pi - pi_true)
                                             / pi_true)),
            "adaptive_max_rel_err": np.float32(err_a),
            "adaptive_rounds": np.float32(res_a.iterations),
            "adaptive_rounds_bound": np.float32(res_a.rounds_bound),
            "loss": np.float32(0.0),
            "engine": eng.name}
