"""Meshes for model code (port of `repro.distributed`): see `sharding`."""
from repro_torch.distributed.sharding import (axis_index, axis_size,
                                              current_mesh, use_mesh)

__all__ = ["use_mesh", "current_mesh", "axis_size", "axis_index"]
