from repro_torch.graph.structure import (Graph, BlockEll, block_fill_rate,
                                         build_block_ell, reorder_bfs)
from repro_torch.graph import datasets, generators, ops

__all__ = ["Graph", "BlockEll", "block_fill_rate", "build_block_ell",
           "reorder_bfs", "datasets", "generators", "ops"]
