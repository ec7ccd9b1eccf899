"""Distributed CPAA — the paper's Algorithm 1 over `torch.distributed`
(port of `repro.core.distributed`).

The paper assigns vertex sets S_j to K CPU threads; within one Chebyshev
round every vertex computes independently and the k -> k+1 dependency is a
barrier. Here the same decomposition is an edge-partitioned SpMV run SPMD
(one process per rank, each holding its own shard) with explicit
collectives on the groups of a `torch.distributed.device_mesh.DeviceMesh`,
the counterpart of the reference's `jax.sharding.Mesh`:

  1D ("row", paper-faithful layout):
      rank d owns all edges with dst in row-chunk d.
      Per round: all-gather x (n floats) -> local gather/index_add_.
      Collective volume/rank/round ~ n.

  2D ("grid", beyond-paper optimization):
      rank (r, c) owns edges with dst in row-chunk r and src in nested
      column group c (see graph.partition.Partition2D). x is sharded over
      the column axis (replicated down each grid column). Per round:
        partial[r,c] = A[r,c] @ x[c]                        (local)
        y sub-chunk  = reduce-scatter(partial, col group)   (~ n/R moved)
        x'[c]        = all-gather(sub-chunks, row group)    (~ n/C moved)
      The nested column layout makes the output layout equal the input
      layout, so the recurrence iterates with no extra reshuffles.

This module owns process-group start-up (`init_mesh`), the SHARD-LOCAL
SpMV bodies (`spmv_1d_shard`, `spmv_2d_shard`), the placement of this
rank's partition slice, and the per-engine collective counters. The
Chebyshev recurrence lives in `core.pagerank.cpaa_fixed` and reaches these
bodies through the `Sharded1DEngine` / `Sharded2DEngine` wrappers in
`core.engine`. `cpaa_distributed_1d` / `cpaa_distributed_2d` are the
array-passing builders: they wrap the passed shards in an engine and run
the shared solver on the whole vector. `cpaa_local_1d` / `cpaa_local_2d`
are the reference's production convention: each rank passes and gets
back its own piece of the vectors (`P(axes)`, or `P("model")` down the
grid columns) and its [1, E] / [1, 1, E] slice of the stacked edge
arrays, with no whole-vector trip at either end; `grid_view` gives a
mesh of more than two axes the 2-D (rows, columns) view the grid
partition needs.

A shard body runs the port's own gather + `index_add_`
(`graph.ops.edge_matmul`), the same code as `CooEngine`. The bf16
`comm_dtype` narrows only the wire; reductions stay in the solve dtype.
A cuda mesh runs on NCCL and never on gloo: gloo takes CUDA tensors for
some collectives by staging them through the host, which would hide the
device collective, so a cuda mesh without NCCL raises. No device tensor
ever crosses gloo; the one gloo group beside NCCL, `host_group()`, carries
only pickled host objects (the serve tier's lockstep plans), so rank 0
never waits on the card to tell the others what comes next.
"""
from __future__ import annotations

import contextlib
import datetime
import os
import warnings

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.chebyshev import ChebSchedule
from repro_torch.device import resolve_device
from repro_torch.graph.ops import edge_matmul
from repro_torch.graph.partition import Partition1D, Partition2D, \
    col_layout_perm

__all__ = [
    "init_process_group",
    "init_fake_world",
    "fake_world",
    "destroy_world",
    "init_mesh",
    "world_size",
    "rank",
    "host_group",
    "broadcast_object",
    "all_true",
    "spmv_1d_shard",
    "spmv_2d_shard",
    "cpaa_distributed_1d",
    "cpaa_distributed_2d",
    "cpaa_local_1d",
    "cpaa_local_2d",
    "grid_view",
    "put_partition_1d",
    "put_partition_2d",
    "pad_personalization",
    "col_layout_perm",
    "collective_counts",
    "reset_collective_counts",
]

# all_gather_into_tensor / reduce_scatter_tensor exist in every torch the
# port runs on; newer releases deprecate them for *_single names that older
# ones lack, and wrap them unchanged. One name everywhere, the notice muted.
warnings.filterwarnings(
    "ignore", category=FutureWarning,
    message=r"`torch\.distributed\.(all_gather_into_tensor|"
            r"reduce_scatter_tensor)` is deprecated")

# (engine, site, op, mesh dim) -> [calls, bytes]. site: "apply" (the SpMV's
# own collectives), "reduce" (the solvers' column-sum / max hooks),
# "layout" (from_internal's gather of the whole vector); the all-to-all
# MoE counts its trips under tag "moe" (`models.moe`).
COLLECTIVES: dict[tuple[str, str, str, str], list[int]] = {}


def _count(tag, site: str, op: str, dim: str, nbytes: int) -> None:
    if tag is None:
        return
    c = COLLECTIVES.setdefault((tag, site, op, dim), [0, 0])
    c[0] += 1
    c[1] += int(nbytes)


def collective_counts() -> dict[str, dict[str, int]]:
    """{"engine/site/op/dim": {"calls": N, "bytes": B}} since the last
    reset. Bytes are the full buffer of the collective: an all-gather's
    output, a reduce-scatter's input, an all-reduce's tensor."""
    return {"/".join(k): {"calls": v[0], "bytes": v[1]}
            for k, v in sorted(COLLECTIVES.items())}


def reset_collective_counts() -> None:
    COLLECTIVES.clear()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# ------------------------------------------------------------ process group --

def world_size() -> int:
    """The initialized default group's world size, or 1 without a group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def rank() -> int:
    """This process's rank in the default group, or 0 without a group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


_HOST_GROUP: list = [None, None]    # [the default group it serves, group]


def host_group():
    """The world's host-only channel: a gloo group over every rank that
    carries pickled host objects (plans, decisions, flags) and never a
    device tensor. On cuda the default group is NCCL, whose object
    collectives copy the pickle to the card behind the work already queued
    on the stream; this channel never waits on the card. Created on first
    use, which every rank reaches in the same order (SPMD)."""
    if _HOST_GROUP[0] is not dist.group.WORLD:
        _HOST_GROUP[:] = [dist.group.WORLD, dist.new_group(backend="gloo")]
    return _HOST_GROUP[1]


def broadcast_object(obj):
    """Rank 0's `obj` on every rank (pickled over `host_group()`); `obj`
    itself at world size 1. Every rank must call it."""
    if world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=host_group())
    return box[0]


def all_true(flag: bool) -> bool:
    """True on every rank iff `flag` is true on every rank (over
    `host_group()`). Every rank must call it."""
    if world_size() == 1:
        return bool(flag)
    flags = [None] * world_size()
    dist.all_gather_object(flags, bool(flag), group=host_group())
    return all(flags)


def init_process_group(device=None) -> torch.device:
    """Start the default process group for `device` (None = cuda; raises
    without a GPU) unless one is initialized, and return the device. See
    `init_mesh` for how it starts and which backend it takes. A fake world
    (`init_fake_world`) serves any device.

    Raises:
        RuntimeError: NCCL unavailable for cuda, or the initialized default
            group's backend does not serve `device`.
    """
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda" and not dist.is_nccl_available():
        raise RuntimeError("repro_torch: a cuda mesh needs NCCL, which this "
                           "torch build lacks (gloo is never used on cuda)")
    if not dist.is_initialized():
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://")
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1,
                                    timeout=datetime.timedelta(minutes=10))
    have = str(dist.get_backend())
    if backend not in have and have != "fake":
        raise RuntimeError(f"repro_torch: a {dev.type} mesh needs a "
                           f"{backend} process group; the default group "
                           f"runs {have!r}")
    return dev


def init_fake_world(world_size: int, rank: int = 0) -> None:
    """Make this process rank `rank` of a world of `world_size` ranks on
    torch's fake backend (`torch.testing._internal.distributed.fake_pg`):
    every collective returns at once without moving a byte, an all-gather
    leaving each chunk a copy of the input and an all-reduce its input as
    it is. One process then runs one rank's program of a mesh it does not
    have, on meta tensors (the production dry-run) or on real ones (one
    rank's device work). The port's collective wrappers (`all_gather`,
    `reduce_scatter`, `all_reduce`, `all_to_all`) run on it unchanged and
    are counted as on any group. A default group already running is
    destroyed first (a mesh built over it is dropped from the cache).

    The fake backend is torch's own: the port keeps no fake world of its
    own at the wrapper layer."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=int(rank),
                            world_size=int(world_size))


def destroy_world() -> None:
    """Destroy the default group, if one is running (the next
    `init_process_group` starts a new one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0):
    """`init_fake_world` for the block; the fake group is destroyed after
    it (the next `init_process_group` then starts a real one)."""
    init_fake_world(world_size, rank)
    try:
        yield
    finally:
        destroy_world()


_MESHES: dict[tuple, object] = {}


def init_mesh(shape, names, device=None):
    """The `DeviceMesh` of `shape` with dimension `names` on `device`'s
    type (None = cuda; raises without a GPU), starting the default process
    group first when none is initialized:

      * under torchrun (RANK and WORLD_SIZE set) from its environment
        (MASTER_ADDR / MASTER_PORT), on cuda binding this process to card
        LOCAL_RANK;
      * otherwise a single-rank group on an in-process store (no network).

    The backend is nccl for cuda and gloo for cpu. A cuda mesh never runs on
    a gloo group: without NCCL, or over a default group started on another
    backend, it raises. Meshes are cached per (device type, shape, names)
    for the life of the default group, since building one creates process
    groups collectively.

    Raises:
        RuntimeError: NCCL unavailable for a cuda mesh, or the initialized
            default group's backend does not serve `device`.
    """
    dev = init_process_group(device)
    shape = tuple(int(s) for s in shape)
    names = tuple(names)
    if int(np.prod(shape)) != dist.get_world_size():
        raise ValueError(f"mesh shape {shape} does not cover the world of "
                         f"{dist.get_world_size()} ranks")
    key = (dev.type, shape, names)
    cached = _MESHES.get(key)
    if cached is not None and cached[0] is dist.group.WORLD:
        return cached[1]
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh(dev.type, shape, mesh_dim_names=names)
    _MESHES[key] = (dist.group.WORLD, mesh)
    return mesh


def mesh_device(mesh) -> torch.device:
    """The torch device a mesh's tensors live on (this rank's card on cuda,
    bound by `init_mesh`)."""
    return resolve_device(mesh.device_type)


def flat_rank(mesh) -> tuple[object, int, int]:
    """(group, index, size) of this rank over ALL of the mesh's ranks, in
    the mesh's row-major order: a 1-D mesh's own group, or the default
    group for a multi-dimensional mesh (which covers the world)."""
    if mesh.ndim == 1:
        return mesh.get_group(0), int(mesh.get_local_rank(0)), mesh.size()
    flat = mesh.mesh.flatten().tolist()
    return dist.group.WORLD, flat.index(dist.get_rank()), mesh.size()


def grid_view(mesh, rows: tuple, col: str):
    """`mesh` as the 2-D (rows, col) mesh of a grid partition: the mesh
    itself when it has exactly those two axes, else a mesh over the same
    ranks whose first dimension flattens the `rows` axes in row-major
    order (("pod", "data") of the (2, 16, 16) production mesh: 32 rows).
    The axes must be the mesh's, rows first. Every rank must call it (a
    new mesh makes its groups collectively).

    Raises:
        ValueError: the axes are not the mesh's in that order, or the mesh
            does not lay its ranks out in row-major order.
    """
    names = tuple(mesh.mesh_dim_names or ())
    rows = (rows,) if isinstance(rows, str) else tuple(rows)
    if names != rows + (col,):
        raise ValueError(f"a grid view of mesh axes {names} needs rows "
                         f"{rows} then column {col!r}")
    if len(rows) == 1:
        return mesh
    if mesh.mesh.flatten().tolist() != list(range(mesh.size())):
        raise ValueError("a grid view needs a mesh of row-major ranks")
    shape = tuple(int(s) for s in mesh.mesh.shape)
    return init_mesh((int(np.prod(shape[:-1])), shape[-1]),
                     ("+".join(rows), col), mesh.device_type)


def grid_coordinate(mesh) -> tuple[int, int]:
    """This rank's (r, c) on a 2-D mesh."""
    if mesh.ndim != 2:
        raise ValueError(f"a 2-D grid needs a 2-D mesh, got {mesh.ndim}-D")
    r, c = mesh.get_coordinate()
    return int(r), int(c)


# ------------------------------------------------------- shard collectives --

def all_gather(x: torch.Tensor, group, *, tag=None, site: str = "apply",
               dim: str = "world") -> torch.Tensor:
    """Concatenate every group rank's x along dim 0, in group-rank order."""
    x = x.contiguous()
    out = x.new_empty((x.shape[0] * dist.get_world_size(group),)
                      + tuple(x.shape[1:]))
    _count(tag, site, "all_gather", dim, _nbytes(out))
    dist.all_gather_into_tensor(out, x, group=group)
    return out


def reduce_scatter(x: torch.Tensor, group, *, tag=None, site: str = "apply",
                   dim: str = "world") -> torch.Tensor:
    """Sum x over the group and keep this rank's dim-0 slice of the sum."""
    x = x.contiguous()
    out = x.new_empty((x.shape[0] // dist.get_world_size(group),)
                      + tuple(x.shape[1:]))
    _count(tag, site, "reduce_scatter", dim, _nbytes(x))
    dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM, group=group)
    return out


def all_reduce(x: torch.Tensor, group, op, *, tag=None, site: str = "reduce",
               dim: str = "world") -> torch.Tensor:
    """In-place all-reduce of x over the group (the result is bitwise the
    same on every rank); returns x."""
    _count(tag, site, "all_reduce", dim, _nbytes(x))
    dist.all_reduce(x, op=op, group=group)
    return x


def all_to_all(x: torch.Tensor, group, *, tag=None, site: str = "apply",
               dim: str = "world") -> torch.Tensor:
    """Equal splits along dim 0: chunk i of x goes to group rank i, and
    chunk j of the result came from group rank j."""
    x = x.contiguous()
    out = torch.empty_like(x)
    _count(tag, site, "all_to_all", dim, _nbytes(x))
    dist.all_to_all_single(out, x, group=group)
    return out


def pad_personalization(p: np.ndarray, n_pad: int) -> np.ndarray:
    out = np.zeros((n_pad,) + p.shape[1:], p.dtype)
    out[: p.shape[0]] = p
    return out


# ------------------------------------------------------- shard-local SpMV --

def spmv_1d_shard(x_sh, src, dst_local, weight, *, group, rows,
                  comm_dtype=None, tag=None, dim: str = "world"):
    """One 1D-partition SpMV on THIS rank's shard.

    x_sh:  [rows] or [rows, B] — this rank's row chunk of x.
    src, dst_local, weight: [E] — this rank's edge shard (global src ids,
    chunk-local dst, 1/deg[src] with 0 on padding).
    Returns this rank's row chunk of y = P x.
    """
    out_dtype = x_sh.dtype
    if comm_dtype is not None:   # compress the wire format only
        x_sh = x_sh.to(comm_dtype)
    x_full = all_gather(x_sh, group, tag=tag, dim=dim).to(out_dtype)
    return edge_matmul(src, dst_local, weight, x_full, rows)


def spmv_2d_shard(x_col, src_local, dst_local, weight, *, row_group,
                  col_group, rows, comm_dtype=None, tag=None):
    """One 2D-partition SpMV on THIS rank's shard.

    x_col: [n/C] or [n/C, B] — this rank's column chunk (nested layout,
    replicated down the grid column). Edge arrays are [E].
    Returns the updated column chunk: a reduce-scatter over the column
    group (the reduction stays in the solve dtype), then an all-gather
    over the row group (optionally narrowed to `comm_dtype` on the wire).
    """
    out_dtype = x_col.dtype
    partial = edge_matmul(src_local, dst_local, weight, x_col, rows)
    y_sub = reduce_scatter(partial, col_group, tag=tag, dim="col")
    if comm_dtype is not None:
        y_sub = y_sub.to(comm_dtype)
    return all_gather(y_sub, row_group, tag=tag, dim="row").to(out_dtype)


# ---------------------------------------------------------------- 1D (row) --

def put_partition_1d(part: Partition1D, mesh) -> tuple[torch.Tensor, ...]:
    """This rank's [d] slice of the stacked 1D partition, on the mesh's
    device: (src, dst_local, weight)."""
    _, d, _ = flat_rank(mesh)
    dev = mesh_device(mesh)
    return tuple(torch.from_numpy(np.ascontiguousarray(a[d])).to(dev)
                 for a in (part.src, part.dst_local, part.weight))


def _solve(eng, sched: ChebSchedule, p, dtype, adaptive, tol, chunk):
    from repro_torch.core.chebyshev import default_chunk
    from repro_torch.core.pagerank import cpaa_adaptive_fixed, cpaa_fixed
    p = p.to(dtype)
    if adaptive:
        tol = float(sched.err_bound) if tol is None else float(tol)
        chunk = default_chunk(sched.c, tol) if chunk is None else chunk
        pi, _, _, _ = cpaa_adaptive_fixed(eng, p, sched.c, tol,
                                          max_rounds=sched.rounds,
                                          chunk=chunk)
        return pi
    coeffs = torch.as_tensor(sched.coeffs, dtype=dtype).to(p.device)
    pi, _ = cpaa_fixed(eng, coeffs, p, rounds=sched.rounds)
    return pi


def cpaa_distributed_1d(mesh, part: Partition1D, sched: ChebSchedule,
                        dtype=torch.float32, comm_dtype=None,
                        adaptive: bool = False, tol: float | None = None,
                        chunk: int | None = None):
    """1D distributed CPAA (the array-passing call convention).

    Returned fn(p, src, dst_local, weight) -> pi, called on every rank:
      p:   [n] (or [n, B]) with n = part.n (padded), the whole vector on
           every rank (`pad_personalization`).
      edge arrays: this rank's shard (`put_partition_1d`).
      pi:  [n] (or [n, B]), the whole vector on every rank, column-
           normalized over the real vertices.

    `dtype` is the compute dtype: p is cast to it on entry (`comm_dtype`
    narrows only the wire). `adaptive=True` swaps the fixed-round
    recurrence for `cpaa_adaptive_fixed` (exit when the chunked L1 residual
    drops under `tol`, default the schedule's err_bound; the schedule's
    round count stays the cap). Its residual sums are all-reduced over
    the world by the engine's column-sum hook.
    """
    from repro_torch.core.engine import Sharded1DEngine

    def solve(p, src, dst_local, weight):
        # n_orig == n_pad: the caller's vectors are already padded, so the
        # layout round-trip is a slice and a gather
        eng = Sharded1DEngine(mesh=mesh, src=src, dst_local=dst_local,
                              weight=weight, n_orig=part.n, n_pad=part.n,
                              rows_per_dev=part.rows_per_dev,
                              comm_dtype=comm_dtype)
        return _solve(eng, sched, p, dtype, adaptive, tol, chunk)

    return solve


# --------------------------------------------------------------- 2D (grid) --

def put_partition_2d(part: Partition2D, mesh) -> tuple[torch.Tensor, ...]:
    """This rank's [r, c] slice of the stacked 2D partition, on the mesh's
    device: (src_local, dst_local, weight)."""
    r, c = grid_coordinate(mesh)
    if tuple(mesh.shape) != tuple(part.grid):
        raise ValueError(f"mesh {tuple(mesh.shape)} != partition grid "
                         f"{part.grid}")
    dev = mesh_device(mesh)
    return tuple(torch.from_numpy(np.ascontiguousarray(a[r, c])).to(dev)
                 for a in (part.src_local, part.dst_local, part.weight))


def cpaa_distributed_2d(mesh, part: Partition2D, sched: ChebSchedule,
                        dtype=torch.float32, comm_dtype=None,
                        adaptive: bool = False, tol: float | None = None,
                        chunk: int | None = None):
    """2D distributed CPAA (the array-passing call convention).

    Returned fn(p_col, src_local, dst_local, weight) -> pi_col, on every
    rank:
      p_col: [n] (or [n, B]) in COLUMN layout (original[col_layout_perm]),
             the whole vector on every rank.
      edge arrays: this rank's shard (`put_partition_2d`).
      pi_col: the whole vector in column layout on every rank; invert with
             argsort(col_layout_perm).

    `dtype` / `comm_dtype` / `adaptive` / `tol` / `chunk` follow the 1D
    builder's convention. The engine runs with perm=None: vectors stay in
    column layout end to end.
    """
    from repro_torch.core.engine import Sharded2DEngine

    def solve(p_col, src_local, dst_local, weight):
        eng = Sharded2DEngine(mesh=mesh, src_local=src_local,
                              dst_local=dst_local, weight=weight, perm=None,
                              inv_perm=None, n_orig=part.n, n_pad=part.n,
                              rows_per_chunk=part.rows_per_chunk,
                              comm_dtype=comm_dtype)
        return _solve(eng, sched, p_col, dtype, adaptive, tol, chunk)

    return solve


# ------------------------------------------------------------- rank-local --

def _fixed_local(eng, sched: ChebSchedule, p, dtype):
    from repro_torch.core.pagerank import cpaa_fixed_local
    p = p.to(dtype)
    coeffs = torch.as_tensor(sched.coeffs, dtype=dtype).to(p.device)
    return cpaa_fixed_local(eng, coeffs, p, rounds=sched.rounds)


def cpaa_local_1d(mesh, part, sched: ChebSchedule, dtype=torch.float32,
                  comm_dtype=None):
    """1D distributed CPAA in the reference's production layout.

    Returned fn(p, src, dst_local, weight) -> pi, called on every rank:
      p:   [rows_per_dev] (or [rows_per_dev, B]), this rank's piece of the
           padded vector under P(axes) (the mesh flattened row-major).
      edge arrays: [1, E], this rank's slice of the stacked [n_dev, E]
           partition under P(axes).
      pi:  this rank's piece, column-normalized over every rank's rows.

    Fixed rounds; each round all-gathers x (n floats per column), the
    normalization all-reduces the column sums; nothing gathers the whole
    vector. `part` needs `n` and `rows_per_dev`.
    """
    from repro_torch.core.engine import Sharded1DEngine

    def solve(p, src, dst_local, weight):
        eng = Sharded1DEngine(mesh=mesh, src=src[0], dst_local=dst_local[0],
                              weight=weight[0], n_orig=part.n, n_pad=part.n,
                              rows_per_dev=part.rows_per_dev,
                              comm_dtype=comm_dtype)
        return _fixed_local(eng, sched, p, dtype)

    return solve


def cpaa_local_2d(mesh, part, sched: ChebSchedule, dtype=torch.float32,
                  comm_dtype=None):
    """2D distributed CPAA in the reference's production layout, on the
    2-D (rows, columns) mesh of the grid (`grid_view`).

    Returned fn(p_col, src_local, dst_local, weight) -> pi_col, on every
    rank:
      p_col: [cols_per_chunk] (or [.., B]), this rank's column chunk of
             the padded vector in column layout (original[col_layout_perm])
             under P(col axis), the same down each grid column.
      edge arrays: [1, 1, E], this rank's slice of the stacked [R, C, E]
             partition.
      pi_col: this rank's column chunk, column-normalized over the grid
             row's chunks.

    Fixed rounds; each round reduce-scatters the partial rows over the
    column group (rows_per_chunk floats per column) and all-gathers the
    sub-chunks over the row group (cols_per_chunk floats). `part` needs
    `n` and `rows_per_chunk`.
    """
    from repro_torch.core.engine import Sharded2DEngine

    def solve(p_col, src_local, dst_local, weight):
        eng = Sharded2DEngine(mesh=mesh, src_local=src_local[0, 0],
                              dst_local=dst_local[0, 0],
                              weight=weight[0, 0], perm=None, inv_perm=None,
                              n_orig=part.n, n_pad=part.n,
                              rows_per_chunk=part.rows_per_chunk,
                              comm_dtype=comm_dtype)
        return _fixed_local(eng, sched, p_col, dtype)

    return solve
