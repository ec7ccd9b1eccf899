from repro_torch.graph.structure import (Graph, BlockEll, EdgeDelta,
                                         block_fill_rate, build_block_ell,
                                         edge_delta, reorder_bfs)
from repro_torch.graph import datasets, generators, ops

__all__ = ["Graph", "BlockEll", "EdgeDelta", "block_fill_rate",
           "build_block_ell", "edge_delta", "reorder_bfs", "datasets",
           "generators", "ops"]
