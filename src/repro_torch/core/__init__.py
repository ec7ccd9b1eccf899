"""CPAA (PageRank via Chebyshev polynomial approximation) in PyTorch, plus
the paper's baselines, measured engine selection and the sharded engines
over torch.distributed."""
from repro_torch.core.chebyshev import (
    ChebSchedule,
    beta,
    chunk_tail_ratio,
    coefficient,
    coefficients,
    default_chunk,
    err_bound,
    make_schedule,
    power_rounds_for_tolerance,
    rounds_for_tolerance,
    sigma_c,
)
from repro_torch.core.autotune import (
    Autotuner,
    TuningStore,
    WorkloadKey,
    default_tuner,
    graph_fingerprint,
    pick_winner,
)
from repro_torch.core.engine import (
    BlockEllEngine,
    CooEngine,
    FusedBlockEllEngine,
    HubTailEngine,
    Sharded1DEngine,
    Sharded2DEngine,
    ShardedEngine,
    as_engine,
    factor_grid,
    heuristic_mode,
    select_engine,
)
from repro_torch.core.pagerank import (
    PageRankResult,
    cpaa,
    cpaa_adaptive,
    cpaa_adaptive_fixed,
    cpaa_fixed,
    degree_prior,
    forward_push,
    monte_carlo,
    power,
    power_refine,
    true_pagerank_dense,
)

__all__ = [
    "ChebSchedule", "beta", "chunk_tail_ratio", "coefficient", "coefficients",
    "default_chunk", "err_bound", "make_schedule",
    "power_rounds_for_tolerance", "rounds_for_tolerance", "sigma_c",
    "BlockEllEngine", "CooEngine", "FusedBlockEllEngine", "HubTailEngine",
    "ShardedEngine", "Sharded1DEngine", "Sharded2DEngine", "as_engine",
    "factor_grid",
    "heuristic_mode", "select_engine",
    "PageRankResult", "cpaa", "cpaa_adaptive", "cpaa_adaptive_fixed",
    "cpaa_fixed", "degree_prior", "forward_push", "monte_carlo", "power",
    "power_refine", "true_pagerank_dense",
    "Autotuner", "TuningStore", "WorkloadKey", "default_tuner",
    "graph_fingerprint", "pick_winner",
]
