"""The mesh that model code runs under (port of what the reference's
all-to-all MoE reads from `repro.distributed.sharding`).

The reference asks JAX for the active mesh (`_current_mesh`: a `with
mesh:` block) and runs the expert-parallel MoE under `shard_map` over its
"model" axis. The port is SPMD over ranks: every process runs the model
on its own shard, and the mesh is a torch `DeviceMesh` whose dimensions
carry the reference's axis names, ("data", "model"), built by
`core.distributed.init_mesh(shape, ("data", "model"), device)` (NCCL on
cuda, which raises without a GPU; gloo on the CPU). `use_mesh(mesh)`
makes it the active mesh and `current_mesh()` reads it.

Under a mesh, each rank feeds the model its shard of the batch: the rows
of its "data" coordinate, the same rows on every rank of a "model" group
(the reference's token spec `P(("data",), None, None)`). The port takes
no data-parallel mean of the ranks' gradients yet, so `make_train_step`
refuses a mesh of more than one rank.

`shard_map_compat` has no counterpart: the port is SPMD already. The
spec builders (`lm_param_specs` ... `dlrm_param_specs`) wait for the
dry-run tooling.
"""
from __future__ import annotations

import contextlib

__all__ = ["use_mesh", "current_mesh", "axis_size", "axis_index"]

_ACTIVE: list = []     # stack of the meshes entered with use_mesh


@contextlib.contextmanager
def use_mesh(mesh):
    """Make `mesh` the active mesh inside the block (None: no mesh, so
    model code takes its single-rank paths). Process-wide, so the
    autograd engine's threads see it too; nests."""
    _ACTIVE.append(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.pop()


def current_mesh():
    """The innermost mesh of `use_mesh`, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def _names(mesh) -> tuple:
    return tuple(mesh.mesh_dim_names or ())


def axis_size(mesh, name: str) -> int:
    """Ranks along dimension `name` of `mesh` (1 when it has none)."""
    names = _names(mesh)
    return int(mesh.mesh.shape[names.index(name)]) if name in names else 1


def axis_index(mesh, name: str) -> int:
    """This rank's coordinate along dimension `name` (0 when it has none)."""
    return int(mesh.get_local_rank(name)) if name in _names(mesh) else 0
