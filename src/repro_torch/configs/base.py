"""The registry's cell and the dry-run plan (port of `repro.configs.base`).

Every architecture module exposes:
  full_config()   the assigned configuration
  smoke_config()  a reduced config of the same family (CPU tests)
  cells()         its list of Cell(shape, kind, skip_reason, extra)
  build(shape, multi_pod) -> DryRunPlan for the full config
  smoke_run(seed, device)  one reduced run, returning its outputs

`DryRunPlan` carries what `launch/dryrun.py` needs: the step callable,
abstract arguments and the `P` spec trees of their sharding. Abstract
arguments are tensors on the `meta` device (the counterpart of
`jax.ShapeDtypeStruct`): shape and dtype, no storage, so a plan of the
235B-parameter config builds anywhere. `static["make_args"](seed,
device)` builds the real arguments of the same shapes through the
builders' non-abstract branches (integer leaves in range: ids < vocab,
senders < n, edge sources < rows). Where a plan can state them,
`static["out_abstract"]` holds the outputs its step allocates beside
the arguments and `static["temp_abstract"]` the buffers it cannot run
without (a train step's float32 gradients): the dry-run's fit check
counts both. Under the production mesh, `local_args(mesh)` is a rank's
own pieces of the arguments, which the step runs sharded.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["Cell", "DryRunPlan", "abstract_tree", "abstract_call", "meta",
           "grad_abstract"]


@dataclass(frozen=True)
class Cell:
    shape: str
    # train | prefill | decode | serve | retrieval | pagerank
    kind: str
    skip_reason: str | None = None
    extra: bool = False      # beyond the 40 assigned cells (perf variants)


@dataclass
class DryRunPlan:
    step: Callable | None          # positional-args step function
    abstract_args: tuple           # meta-tensor trees
    in_specs: tuple                # P trees (same structure)
    out_specs: Any = None          # optional P tree for outputs
    donate: tuple = ()             # donated arg indices
    static: dict = field(default_factory=dict)
    # analytic FLOPs for one step (MODEL_FLOPS in the roofline tables)
    model_flops: float = 0.0
    note: str = ""
    # The reference's correction for XLA counting loop bodies once:
    # {"L": layers, "M": microbatches, "probe": fn(L, M) -> DryRunPlan}.
    # A counted eager run sees every trip of every loop, so
    # launch/dryrun.py uses it, as the reference does, only on the
    # production mesh, where it cuts a deep step's counting time.
    cost_model: dict | None = None

    def local_args(self, mesh) -> tuple:
        """This rank's arguments under the production mesh `mesh`: its
        pieces of the abstract arguments under `in_specs`
        (`sharding.shard_tree`, on meta tensors), with the scalars the
        plan states (`static["scalar_args"]`: index -> value, e.g. a
        decode step's cache_len) as host tensors. What the step, run under
        `use_mesh(mesh, sharded=True)`, takes."""
        from repro_torch.distributed.sharding import shard_tree
        args = list(shard_tree(tuple(self.abstract_args),
                               tuple(self.in_specs), mesh))
        for i, v in self.static.get("scalar_args", {}).items():
            args[i] = torch.tensor(v, dtype=self.abstract_args[i].dtype)
        return tuple(args)


def meta(shape, dtype) -> torch.Tensor:
    """One abstract leaf: a meta tensor of `shape` and `dtype`."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def abstract_tree(tree):
    """Every tensor leaf of `tree` as a meta tensor of its shape and
    dtype."""
    return pytree.tree_map(
        lambda x: meta(x.shape, x.dtype) if isinstance(x, torch.Tensor)
        else x, tree)


class _OnMeta(TorchDispatchMode):
    """Every op that names a device runs on `meta` instead: factories
    allocate nothing, and ops on meta tensors only propagate shapes."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if "device" in kwargs:
            kwargs["device"] = torch.device("meta")
        return func(*args, **kwargs)


def abstract_call(fn, *args, **kwargs):
    """fn(*args, **kwargs) with every tensor it makes on `meta`: the shapes
    and dtypes of an initializer's output without allocating it (random
    draws on meta tensors take a CPU generator and draw nothing)."""
    with _OnMeta():
        out = fn(*args, **kwargs)
    return abstract_tree(out)


def grad_abstract(aparams):
    """The float32 gradient tree of abstract parameters (meta)."""
    return pytree.tree_map(lambda x: meta(x.shape, torch.float32), aparams)
