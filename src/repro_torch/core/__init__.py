"""CPAA (PageRank via Chebyshev polynomial approximation) in PyTorch."""
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
from repro_torch.core.engine import (
    BlockEllEngine,
    CooEngine,
    FusedBlockEllEngine,
    HubTailEngine,
    as_engine,
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
    power_refine,
)

__all__ = [
    "ChebSchedule", "beta", "chunk_tail_ratio", "coefficient", "coefficients",
    "default_chunk", "err_bound", "make_schedule",
    "power_rounds_for_tolerance", "rounds_for_tolerance", "sigma_c",
    "BlockEllEngine", "CooEngine", "FusedBlockEllEngine", "HubTailEngine",
    "as_engine",
    "heuristic_mode", "select_engine",
    "PageRankResult", "cpaa", "cpaa_adaptive", "cpaa_adaptive_fixed",
    "cpaa_fixed", "degree_prior", "power_refine",
]
