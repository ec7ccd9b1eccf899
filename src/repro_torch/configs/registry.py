"""Architecture registry (port of `repro.configs.registry`): `--arch <id>`
resolves here.

The 10 assigned architectures (40 assigned cells) plus the paper's own
workload (cpaa-pagerank, extra cells) and the online PageRank service.
"""
from __future__ import annotations

from repro_torch.configs import (deepseek_7b, dimenet, dlrm_rm2,
                                 granite_moe_3b, graphcast, h2o_danube_1_8b,
                                 meshgraphnet, pagerank_cpaa, pagerank_serve,
                                 pna, qwen2_5_32b, qwen3_moe_235b)

__all__ = ["ARCHS", "EXTRA_ARCHS", "ALL_ARCHS", "get", "all_cells"]

ARCHS = {
    "qwen2.5-32b": qwen2_5_32b,
    "h2o-danube-1.8b": h2o_danube_1_8b,
    "deepseek-7b": deepseek_7b,
    "granite-moe-3b-a800m": granite_moe_3b,
    "qwen3-moe-235b-a22b": qwen3_moe_235b,
    "graphcast": graphcast,
    "pna": pna,
    "dimenet": dimenet,
    "meshgraphnet": meshgraphnet,
    "dlrm-rm2": dlrm_rm2,
}

EXTRA_ARCHS = {
    "cpaa-pagerank": pagerank_cpaa,
    "pagerank-serve": pagerank_serve,
}

ALL_ARCHS = {**ARCHS, **EXTRA_ARCHS}


def get(name: str):
    """The config module registered as `name`.

    Raises:
        KeyError: `name` is not registered (the message lists the names).
    """
    if name not in ALL_ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ALL_ARCHS)}")
    return ALL_ARCHS[name]


def all_cells(include_extra: bool = True):
    """[(arch, Cell)] for every (architecture x shape) combination."""
    archs = ALL_ARCHS if include_extra else ARCHS
    out = []
    for name, mod in archs.items():
        for cell in mod.cells():
            out.append((name, cell))
    return out
