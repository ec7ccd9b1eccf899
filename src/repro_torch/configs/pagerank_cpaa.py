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
`cells` lists one cell per shape. The reference's `build` (the dry-run
plan) waits for the dry-run tooling.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import Cell
from repro_torch.core.chebyshev import make_schedule

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
