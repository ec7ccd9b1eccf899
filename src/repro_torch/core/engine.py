"""SpMM engines: the solver hot path behind one interface (PyTorch port of
`repro.core.engine`).

Every PageRank round is one application of P = A D^{-1} plus O(n) vector
work. How P x is computed is a format choice, so it lives behind an engine:

  * CooEngine           — gather + `index_add_` over the COO edge list with
                          the 1/deg[src] weights folded into a per-edge
                          array. Works for any graph and any batch.
  * HubTailEngine       — degree split for scale-free graphs: edges into
                          hubs go through fixed-width column panels (a
                          gather + row-sum), the rest through COO's
                          gather + `index_add_`.
  * BlockEllEngine      — the block-ELL SpMM kernel (`kernels/bsr_spmm`):
                          vertices BFS-reordered so edges cluster into BxB
                          tiles, each tile a dense product. The engine owns
                          the perm/padding round-trip, so callers see
                          original vertex ids.
  * FusedBlockEllEngine — BlockEllEngine whose Chebyshev round is the fused
                          `cheb_step` kernel (5nB bytes per round instead of
                          8nB).
  * ShardedEngine       — the paper's Algorithm 1 vertex-set decomposition
                          over `torch.distributed` (`core.distributed` shard
                          bodies), one process per rank: `Sharded1DEngine`
                          owns a 1D row partition (all-gather x per round,
                          ~n floats per rank), `Sharded2DEngine` an (R, C)
                          grid partition (reduce-scatter + all-gather,
                          ~n/R + n/C floats per rank). Each rank holds its
                          own edge shard and its own slice of the solve
                          vectors; the engine owns the mesh, the partition
                          placement and (2D) the nested column layout, so
                          callers pass and receive whole vectors in
                          original vertex ids.

Solvers call:

    x  = eng.to_internal(p)        # once per solve: layout in
    y  = eng.apply(x)              # per round: y = P x
    t, acc = eng.cheb_round(y, t, acc, ck)   # per round: vector work
    pi = eng.from_internal(acc)    # once per solve: layout out

The adaptive solver's round and chunk go through two more hooks, the
same on every engine (`_AdaptivePasses`): `cheb_round_masked` (the
`cheb_step_masked` kernel: the round in place, frozen columns zeroed) and
`chunk_residual` (the `cheb_residual` kernel: the normalized snapshot and
its L1 residual, summed over ranks by `sum_over_ranks`). The block-ELL
engines' `with_kernels(False)` takes their plain versions on any device.

Mass invariant (the adaptive solver depends on it): the internal layout is
a permutation of the caller's vertices plus ZERO-mass padding rows that stay
zero through every `apply`/`cheb_round`, so column sums and L1 norms on
internal-layout arrays equal the external ones. The solvers take those
sums and maxima through the engine's `colsum` / `amax` hooks: local on one
device; on a sharded engine an all-reduce over the ranks that together
hold one copy of the vector (the world for 1D, the column group for 2D,
whose vectors are replicated down the grid rows). Every rank then reads
the same reduced values, so host decisions (`any(active)`, the stop
round) agree across ranks.

Refresh protocol (edge updates): `eng.refresh(g, delta, dg=...)` returns
the engine for the updated graph. COO needs nothing when the registry
patched its own DeviceGraph in place; hub/tail rebuilds on the host (a
delta can move vertices across the hub bar); block-ELL re-tiles, reusing
its BFS perm when the delta touched at most REFRESH_PERM_MAX_TOUCHED of
the vertices.

Measured selection ("tuned") goes through `core.autotune`. `select_engine`
shards in auto mode when the initialized process group has >= 2 ranks and
the graph clears `SHARDED_MIN_N` (2D when >= 4 ranks and n >= 4x the bar).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.distributed import (all_gather, all_reduce,
                                          collective_counts, flat_rank,
                                          grid_coordinate, init_mesh,
                                          put_partition_1d, put_partition_2d,
                                          reset_collective_counts,
                                          spmv_1d_shard, spmv_2d_shard,
                                          world_size)
from repro_torch.device import resolve_device
from repro_torch.graph.ops import DeviceGraph, as_torch_dtype, \
    check_int32_range, device_graph, spmm, spmv, upload
from repro_torch.graph.partition import (col_layout_perm, partition_1d,
                                         partition_2d)
from repro_torch.graph.structure import (BlockEll, Graph, block_fill_rate,
                                         build_block_ell)
from repro_torch.kernels.bsr_spmm.ops import bsr_spmm
from repro_torch.kernels.bsr_spmm.ref import bsr_spmm_ref
from repro_torch.kernels.cheb_step.ops import cheb_residual, cheb_step, \
    cheb_step_masked
from repro_torch.kernels.cheb_step.ref import cheb_residual_ref, \
    cheb_step_masked_ref, cheb_step_ref

__all__ = [
    "CooEngine",
    "HubTailEngine",
    "BlockEllEngine",
    "FusedBlockEllEngine",
    "ShardedEngine",
    "Sharded1DEngine",
    "Sharded2DEngine",
    "as_engine",
    "auto_shard_mode",
    "heuristic_mode",
    "select_engine",
    "factor_grid",
    "ENGINE_MODES",
    "SHARDED_MODES",
    "SHARDED_MIN_N",
    "apply_counts",
    "reset_apply_counts",
    "collective_counts",
    "reset_collective_counts",
]

# hub bar of the degree split (the reference's HubTailEngine.DEFAULT_MIN_DEG)
HUB_MIN_DEG = 32

SHARDED_MODES = ("sharded_1d", "sharded_2d")
ENGINE_MODES = ("auto", "tuned", "coo", "hub_tail", "block_ell",
                "fused") + SHARDED_MODES

# Per-engine apply() execution counts (eager: every call is one SpMM).
APPLY_COUNTS: dict[str, int] = {}


def _count_apply(name: str) -> None:
    APPLY_COUNTS[name] = APPLY_COUNTS.get(name, 0) + 1


def apply_counts() -> dict[str, int]:
    """Copy of the per-engine apply() execution counters."""
    return dict(APPLY_COUNTS)


def reset_apply_counts() -> None:
    APPLY_COUNTS.clear()


def _default_cheb_round(y, t, acc, ck):
    """Unfused three-term recurrence + accumulation."""
    t_next = 2.0 * y - t
    return t_next, acc + ck * t_next


class _AdaptivePasses:
    """The adaptive loop's vector passes (`cpaa_adaptive_fixed`), the same
    on every engine: on the card the `cheb_step_masked` and
    `cheb_residual` kernels, on the CPU (and with `use_kernel` off) their
    plain versions. `sum_over_ranks` is the engine's own."""

    use_kernel = True   # the block-ELL engines switch it per instance

    def cheb_round_masked(self, y, t, acc, ck, active):
        """The masked round in place: t'' over y (this engine's fresh
        `apply` output), acc' over acc; frozen columns get t'' = 0."""
        if self.use_kernel:
            return cheb_step_masked(y, t, acc, ck, active)
        return cheb_step_masked_ref(y, t, acc, ck, active)

    def chunk_residual(self, acc, snap):
        """Per-column L1 residual of the normalized acc against snap,
        summed over the ranks; snap becomes the normalized acc."""
        if self.use_kernel:
            return cheb_residual(acc, snap, self.sum_over_ranks)
        return cheb_residual_ref(acc, snap, self.sum_over_ranks)


class _LocalReductions(_AdaptivePasses):
    """The solvers' reduction hooks on a single-device engine, whose
    internal-layout arrays hold the whole vector: plain local reductions."""

    def sum_over_ranks(self, x: torch.Tensor) -> torch.Tensor:
        """A per-rank partial sum reduced over ranks: the identity here."""
        return x

    def colsum(self, a: torch.Tensor) -> torch.Tensor:
        """Column sums of an internal-layout [n] / [n, B] array."""
        return a.sum(dim=0)

    def amax(self, a: torch.Tensor) -> torch.Tensor:
        """Max over every entry of an internal-layout array."""
        return a.max()

    def ranking_layout(self, x: torch.Tensor):
        """(rows, n_valid, ids) to rank an internal-layout [n, B] array by
        vertex (`kernels.topk.topk_columns`): row r < n_valid holds vertex
        ids[r], or vertex r where ids is None; later rows are padding. Here
        the internal layout is vertex order."""
        return x, self.n, None


class CooEngine(_LocalReductions):
    """index_add_ over the COO edge list with precomputed edge weights."""

    name = "coo"

    def __init__(self, dg: DeviceGraph):
        self.dg = dg

    @property
    def n(self) -> int:
        return self.dg.n

    @property
    def dtype(self) -> torch.dtype:
        return self.dg.inv_deg.dtype

    @property
    def device(self) -> torch.device:
        return self.dg.device

    def to_internal(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def from_internal(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        _count_apply(self.name)
        return spmv(self.dg, x) if x.ndim == 1 else spmm(self.dg, x)

    def cheb_round(self, y, t, acc, ck):
        return _default_cheb_round(y, t, acc, ck)

    def refresh(self, g: Graph | None, delta=None, *, dg: DeviceGraph,
                **kw) -> "CooEngine":
        """Refresh after an edge-update batch: when the caller patched this
        engine's own DeviceGraph in place (the incremental path) the engine
        is already current; another dg swaps in."""
        return self if dg is self.dg else CooEngine(dg)


class HubTailEngine(_LocalReductions):
    """Degree-split SpMM engine for skewed (power-law) graphs at scale.

    On a scale-free graph the hubs — the top few percent of vertices by
    degree — receive most of the edges. The split sends each edge down the
    path its DESTINATION's degree earns:

      * hub rows (deg >= hub_min_deg, degree-sorted descending) are packed
        into fixed-width int32 column panels `panel_cols` [P, W]; a round
        gathers the panel columns, row-sums them, and reduces the per-panel
        partials with one small `index_add_` over [P] -> [H];
      * tail rows keep COO's gather + `index_add_` over the other edges.

    P = A D^{-1} is applied in FACTORED form: xd = x * inv_deg once per
    round (O(n)), so neither path stores per-edge weights. Panel padding
    holds the sentinel column id n, which indexes a zero row appended to
    xd inside `apply`, so padding adds exactly 0.0 (the mass invariant);
    the internal layout is the identity.

    `inv_deg` may be packed (bf16); it is upcast to the solve dtype before
    the multiply, so accumulation stays at full precision. On CUDA the
    `index_add_`s add with atomics: the order of the sums is not fixed.
    """

    name = "hub_tail"
    DEFAULT_MIN_DEG = HUB_MIN_DEG   # hub bar: deg >= 32
    DEFAULT_PANEL_WIDTH = 32        # columns per panel

    def __init__(self, inv_deg: torch.Tensor, tail_src: torch.Tensor,
                 tail_dst: torch.Tensor, panel_cols: torch.Tensor,
                 panel_hub: torch.Tensor, hub_ids: torch.Tensor, n_orig: int,
                 hub_min_deg: int, panel_width: int,
                 acc_dtype=torch.float32):
        self.inv_deg = inv_deg         # [n] weight dtype (packed ok)
        self.tail_src = tail_src       # [m_tail] int32
        self.tail_dst = tail_dst       # [m_tail] int32
        self.panel_cols = panel_cols   # [P, W] int32, sentinel n = padding
        self.panel_hub = panel_hub     # [P] int32 hub rank of each panel
        self.hub_ids = hub_ids         # [H] int32 vertex id per hub rank
        self.n_orig = n_orig
        self.hub_min_deg = hub_min_deg
        self.panel_width = panel_width
        self.acc_dtype = as_torch_dtype(acc_dtype)

    @classmethod
    def from_graph(cls, g: Graph, hub_min_deg: int | None = None,
                   panel_width: int | None = None, dtype=torch.float32,
                   weight_dtype=None, device=None) -> "HubTailEngine":
        """Host build in numpy, then one transfer: degree-sort the hubs,
        lexsort their edges by (hub rank, src) for gather locality, pack
        into W-wide panels. O(m log m). `device` None means cuda."""
        dev = resolve_device(device)
        check_int32_range(g.n, g.m, what="HubTailEngine")
        thr = cls.DEFAULT_MIN_DEG if hub_min_deg is None else int(hub_min_deg)
        width = cls.DEFAULT_PANEL_WIDTH if panel_width is None \
            else int(panel_width)
        dtype = as_torch_dtype(dtype)
        wdtype = dtype if weight_dtype is None \
            else as_torch_dtype(weight_dtype)
        n = g.n
        src = g.src
        dst = g.dst
        deg = np.bincount(src, minlength=n)
        inv_deg = 1.0 / np.maximum(deg, 1)

        hub_mask_v = deg >= thr
        hub_ids = np.flatnonzero(hub_mask_v)
        hub_ids = hub_ids[np.argsort(-deg[hub_ids],
                                     kind="stable")].astype(np.int32)
        n_hubs = int(hub_ids.size)
        hub_rank = np.full(n, -1, np.int64)
        hub_rank[hub_ids] = np.arange(n_hubs)
        is_hub = hub_mask_v[dst]
        hsrc = src[is_hub]
        hr = hub_rank[dst[is_hub]]
        tail_src = np.ascontiguousarray(src[~is_hub])
        tail_dst = np.ascontiguousarray(dst[~is_hub])
        order = np.lexsort((hsrc, hr))
        hsrc, hr = hsrc[order], hr[order]
        hdeg = np.bincount(hr, minlength=n_hubs)
        panels_per_hub = np.maximum((hdeg + width - 1) // width, 1)
        n_panels = int(panels_per_hub.sum())
        cols = np.full((n_panels, width), n, np.int32)  # n -> zero sentinel
        panel_hub = np.repeat(np.arange(n_hubs, dtype=np.int32),
                              panels_per_hub)
        panel_base = np.concatenate([[0], np.cumsum(panels_per_hub)[:-1]])
        starts = np.concatenate([[0], np.cumsum(hdeg)[:-1]])
        pos = panel_base[hr] * width + (np.arange(hsrc.size) - starts[hr])
        cols.ravel()[pos] = hsrc
        return cls(inv_deg=upload(inv_deg, wdtype, dev),
                   tail_src=upload(tail_src, torch.int32, dev),
                   tail_dst=upload(tail_dst, torch.int32, dev),
                   panel_cols=upload(cols, torch.int32, dev),
                   panel_hub=upload(panel_hub, torch.int32, dev),
                   hub_ids=upload(hub_ids, torch.int32, dev),
                   n_orig=n, hub_min_deg=thr, panel_width=width,
                   acc_dtype=dtype)

    @property
    def n(self) -> int:
        return self.n_orig

    @property
    def n_hubs(self) -> int:
        return self.hub_ids.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        # the SOLVE dtype, not the packed storage dtype: solvers build p and
        # the carries from it, and those stay at accumulation precision
        return self.acc_dtype

    @property
    def weight_dtype(self) -> torch.dtype:
        return self.inv_deg.dtype

    @property
    def device(self) -> torch.device:
        return self.inv_deg.device

    def to_internal(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def from_internal(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        _count_apply(self.name)
        inv = self.inv_deg
        if inv.dtype != x.dtype:
            inv = inv.to(x.dtype)   # packed storage -> full-precision mul
        rest = tuple(x.shape[1:])
        xd = x * (inv if x.ndim == 1 else inv[:, None])
        # sentinel row n: panel padding gathers exactly 0.0
        xd = torch.cat([xd, xd.new_zeros((1,) + rest)])
        y = xd.new_zeros((self.n_orig,) + rest).index_add_(
            0, self.tail_dst, xd.index_select(0, self.tail_src))
        n_panels, width = self.panel_cols.shape
        part = xd.index_select(0, self.panel_cols.reshape(-1)).reshape(
            (n_panels, width) + rest).sum(dim=1)
        hub_y = xd.new_zeros((self.n_hubs,) + rest).index_add_(
            0, self.panel_hub, part)
        return y.index_add_(0, self.hub_ids, hub_y)

    def cheb_round(self, y, t, acc, ck):
        return _default_cheb_round(y, t, acc, ck)

    def refresh(self, g: Graph, delta=None, *, dg=None,
                **kw) -> "HubTailEngine":
        """Rebuild for the updated graph with the same split knobs. A delta
        can move vertices across the hub bar, so the refresh is a full host
        rebuild; the registry's padded DeviceGraph is not consulted."""
        return type(self).from_graph(g, hub_min_deg=self.hub_min_deg,
                                     panel_width=self.panel_width,
                                     dtype=self.acc_dtype,
                                     weight_dtype=self.inv_deg.dtype,
                                     device=self.device)


class BlockEllEngine(_LocalReductions):
    """Block-ELL SpMM engine over BFS-reordered, block-padded vertices.

    Internal layout: [n_pad] (or [n_pad, B]) float32 in BFS order, where
    n_pad = n_row_blocks * block >= n. Padding rows carry zero mass and stay
    zero through every round (empty slots have all-zero values), so
    `from_internal` is a plain inverse-permutation gather of the first rows.

    Every round goes through the kernel wrappers, which launch the CUDA
    kernels on CUDA tensors and take the plain versions on CPU tensors.
    `with_kernels(False)` gives the one engine that calls the plain
    versions on any device: the on-card reference a kernel solve is held
    against.
    """

    name = "block_ell"

    def __init__(self, block_cols: torch.Tensor, values: torch.Tensor,
                 perm: torch.Tensor, inv_perm: torch.Tensor, n_orig: int,
                 block: int, fill_rate: float | None = None):
        self.block_cols = block_cols   # [n_rb, S] int32
        self.values = values           # [n_rb, S, B, B] f32
        self.perm = perm               # [n_orig] int64 old id at BFS position
        self.inv_perm = inv_perm       # [n_orig] int64 BFS position of old id
        self.n_orig = n_orig
        self.block = block
        self.use_kernel = True
        self.fill_rate = fill_rate     # informational build statistic
        # the vertex of each internal row, for ranking in place
        self._rank_ids = perm.to(torch.int32)

    @classmethod
    def from_block_ell(cls, be: BlockEll, pad_slots_to_pow2: bool = False,
                       device=None) -> "BlockEllEngine":
        dev = resolve_device(device)
        block_cols, values = be.block_cols, be.values
        if pad_slots_to_pow2:
            s = 1
            while s < be.slots:
                s *= 2
            if s > be.slots:
                # extra slots point at the diagonal with zero values:
                # harmless by construction, and the padded S keeps shapes
                # stable when edge updates change the true slot count
                n_rb = be.n_row_blocks
                diag = np.tile(np.arange(n_rb, dtype=np.int32)[:, None],
                               (1, s - be.slots))
                block_cols = np.concatenate([block_cols, diag], axis=1)
                values = np.concatenate(
                    [values, np.zeros((n_rb, s - be.slots, be.block,
                                       be.block), np.float32)], axis=1)
        inv = np.empty(be.n_orig, np.int64)
        inv[be.perm] = np.arange(be.n_orig)
        return cls(block_cols=torch.from_numpy(
                       np.ascontiguousarray(block_cols)).to(dev),
                   values=torch.from_numpy(
                       np.ascontiguousarray(values)).to(dev),
                   perm=torch.from_numpy(
                       np.asarray(be.perm, np.int64)).to(dev),
                   inv_perm=torch.from_numpy(inv).to(dev),
                   n_orig=be.n_orig, block=be.block,
                   fill_rate=be.fill_rate)

    @classmethod
    def from_graph(cls, g: Graph, block: int = 128, reorder: bool = True,
                   pad_slots_to_pow2: bool = False, perm=None,
                   device=None) -> "BlockEllEngine":
        dev = resolve_device(device)   # fail before the host build
        return cls.from_block_ell(build_block_ell(g, block=block,
                                                  reorder=reorder, perm=perm),
                                  pad_slots_to_pow2=pad_slots_to_pow2,
                                  device=dev)

    def with_kernels(self, use_kernel: bool) -> "BlockEllEngine":
        """The same engine (shared tensors) with kernels on or off."""
        eng = type(self)(self.block_cols, self.values, self.perm,
                         self.inv_perm, self.n_orig, self.block,
                         fill_rate=self.fill_rate)
        eng.use_kernel = use_kernel
        return eng

    @property
    def n(self) -> int:
        return self.n_orig

    @property
    def n_pad(self) -> int:
        return self.block_cols.shape[0] * self.block

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    @property
    def device(self) -> torch.device:
        return self.values.device

    def to_internal(self, x: torch.Tensor) -> torch.Tensor:
        xp = x.to(torch.float32).index_select(0, self.perm)
        pad = self.n_pad - self.n_orig
        if pad:
            xp = torch.cat([xp, xp.new_zeros((pad,) + tuple(x.shape[1:]))])
        return xp

    def from_internal(self, x: torch.Tensor) -> torch.Tensor:
        return x.index_select(0, self.inv_perm)

    def ranking_layout(self, x: torch.Tensor):
        """(x, n_orig, perm as int32): internal row r holds vertex perm[r]
        in BFS order; the rows from n_orig on are the block padding."""
        return x, self.n_orig, self._rank_ids

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        _count_apply(self.name)
        if self.use_kernel:
            return bsr_spmm(self.block_cols, self.values, x)
        squeeze = x.ndim == 1
        y = bsr_spmm_ref(self.block_cols, self.values,
                         x[:, None] if squeeze else x)
        return y[:, 0] if squeeze else y

    def cheb_round(self, y, t, acc, ck):
        return _default_cheb_round(y, t, acc, ck)

    # a localized delta barely moves tile fill, so the cached BFS perm stays
    # good and the rebuild skips the host BFS; past this touched fraction
    # the locality argument is gone and the BFS runs again
    REFRESH_PERM_MAX_TOUCHED = 0.25

    def refresh(self, g: Graph, delta=None, *,
                dg: DeviceGraph | None = None, stable_shapes: bool = True,
                **kw) -> "BlockEllEngine":
        """Re-tile for the updated graph on the host and upload. When the
        delta touched at most REFRESH_PERM_MAX_TOUCHED of the vertices the
        BFS perm is reused (any perm is valid; only the fill is at stake);
        a delocalized delta (or none) runs the BFS again. The kernels
        setting carries over."""
        perm = None
        if delta is not None and \
                delta.touched.size <= self.REFRESH_PERM_MAX_TOUCHED * g.n:
            perm = self.perm.cpu().numpy()
        eng = type(self).from_graph(g, block=self.block,
                                    pad_slots_to_pow2=stable_shapes,
                                    perm=perm, device=self.device)
        return eng if self.use_kernel else eng.with_kernels(False)


class FusedBlockEllEngine(BlockEllEngine):
    """Block-ELL SpMM + the fused Chebyshev-update kernel in every round of
    a fixed-round solve (`cheb_round`). The adaptive loop's rounds and
    residuals (`cheb_round_masked`, `chunk_residual`) are
    `BlockEllEngine`'s, so on an adaptive tick the two engines run the
    same code."""

    name = "block_ell_fused"

    def cheb_round(self, y, t, acc, ck):
        if self.use_kernel:
            return cheb_step(y, t, acc, ck)
        return cheb_step_ref(y, t, acc, ck)


def factor_grid(n_dev: int) -> tuple[int, int]:
    """Most-square (R, C) with R * C == n_dev and R <= C (wider column axis
    keeps the all-gathered sub-chunks small): 8 -> (2, 4), 16 -> (4, 4)."""
    r = int(math.isqrt(n_dev))
    while n_dev % r:
        r -= 1
    return (r, n_dev // r)


def _check_mesh(mesh, dev: torch.device) -> None:
    if mesh.device_type != dev.type:
        raise ValueError(f"mesh runs on {mesh.device_type!r}, engine device "
                         f"is {dev}")


class ShardedEngine(_AdaptivePasses):
    """Shared surface of the rank-sharded engines (see module docstring).

    SPMD: every rank builds the same engine over its own shard and calls
    every method in the same order, since `apply`, `from_internal` and the
    reduction hooks run collectives. `to_internal` takes the WHOLE vector
    (every rank passes the same one) and keeps this rank's slice;
    `from_internal` gathers the whole vector back on every rank, as the
    reference returns a global array, so a top-k after it stays local.
    The Chebyshev update runs on the local slices. Collectives are counted
    per engine name in `core.distributed` (`collective_counts`).
    """

    def cheb_round(self, y, t, acc, ck):
        return _default_cheb_round(y, t, acc, ck)

    @property
    def n(self) -> int:
        return self.n_orig

    @property
    def dtype(self) -> torch.dtype:
        return self.weight.dtype

    @property
    def device(self) -> torch.device:
        return self.weight.device

    def sum_over_ranks(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's partial sum (column sums of its slice) all-reduced,
        in place, over the ranks that together hold one copy of the
        vector."""
        return all_reduce(x, self.reduce_group, dist.ReduceOp.SUM,
                          tag=self.name, dim=self.reduce_dim)

    def colsum(self, a: torch.Tensor) -> torch.Tensor:
        """Column sums of an internal-layout slice, all-reduced over the
        ranks that together hold one copy of the vector."""
        return self.sum_over_ranks(a.sum(dim=0))

    def amax(self, a: torch.Tensor) -> torch.Tensor:
        """Max over every entry of the vector, all-reduced like colsum."""
        return all_reduce(a.max(), self.reduce_group, dist.ReduceOp.MAX,
                          tag=self.name, dim=self.reduce_dim)

    def ranking_layout(self, x: torch.Tensor):
        """(whole x in vertex order, n, None): a rank's slice does not hold
        the whole vector, so `from_internal` gathers it (the all-gather) and
        every rank ranks the whole."""
        return self.from_internal(x), self.n, None


class Sharded1DEngine(ShardedEngine):
    """Row-partitioned CPAA engine (the paper-faithful decomposition).

    Rank d owns every edge whose dst falls in row-chunk d; each round
    all-gathers x (~n floats per rank) and computes its local rows.
    Internal layout: this rank's [rows_per_dev] (or [rows_per_dev, B])
    chunk of the original vertex order zero-padded to
    n_pad = rows_per_dev * n_dev. A multi-dimensional mesh is flattened in
    row-major order.
    """

    name = "sharded_1d"
    reduce_dim = "world"

    def __init__(self, mesh, src: torch.Tensor, dst_local: torch.Tensor,
                 weight: torch.Tensor, n_orig: int, n_pad: int,
                 rows_per_dev: int, comm_dtype=None, lane: int = 128):
        self.mesh = mesh
        self.group, self.index, self.n_dev = flat_rank(mesh)
        if n_pad != rows_per_dev * self.n_dev:
            raise ValueError(f"n_pad {n_pad} != rows_per_dev {rows_per_dev}"
                             f" x {self.n_dev} ranks")
        self.src = src                 # [E] int32, global src ids
        self.dst_local = dst_local     # [E] int32, chunk-local dst
        self.weight = weight           # [E] f32, 1/deg[src] (0 on padding)
        self.n_orig = n_orig
        self.n_pad = n_pad
        self.rows_per_dev = rows_per_dev
        self.comm_dtype = None if comm_dtype is None \
            else as_torch_dtype(comm_dtype)
        self.lane = lane
        self.reduce_group = self.group

    @classmethod
    def from_graph(cls, g: Graph, mesh=None, lane: int = 128,
                   dtype=torch.float32, comm_dtype=None,
                   device=None) -> "Sharded1DEngine":
        """Partition on the host (every rank builds the same partition) and
        put this rank's slice on `device` (None = cuda). mesh None = a 1-D
        mesh over the whole world (`init_mesh`, which starts a single-rank
        group when none is initialized)."""
        dev = resolve_device(device)
        if mesh is None:
            mesh = init_mesh((world_size(),), ("dev",), device=dev)
        _check_mesh(mesh, dev)
        check_int32_range(g.n, g.m, what="Sharded1DEngine")
        part = partition_1d(g, mesh.size(), lane=lane)
        src, dst_local, weight = put_partition_1d(part, mesh)
        return cls(mesh=mesh, src=src, dst_local=dst_local,
                   weight=weight.to(as_torch_dtype(dtype)), n_orig=g.n,
                   n_pad=part.n, rows_per_dev=part.rows_per_dev,
                   comm_dtype=comm_dtype, lane=lane)

    def to_internal(self, x: torch.Tensor) -> torch.Tensor:
        pad = self.n_pad - x.shape[0]
        if pad:
            x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
        lo = self.index * self.rows_per_dev
        return x[lo:lo + self.rows_per_dev].contiguous()

    def from_internal(self, x: torch.Tensor) -> torch.Tensor:
        full = all_gather(x, self.group, tag=self.name, site="layout")
        return full[:self.n_orig] if self.n_orig != self.n_pad else full

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        _count_apply(self.name)
        return spmv_1d_shard(x, self.src, self.dst_local, self.weight,
                             group=self.group, rows=self.rows_per_dev,
                             comm_dtype=self.comm_dtype, tag=self.name)

    def refresh(self, g: Graph, delta=None, *, dg=None, lane=None,
                **kw) -> "Sharded1DEngine":
        """Rebuild the row partition for the updated graph on the SAME
        mesh (lane, dtypes and device kept). Every rank must call it."""
        return type(self).from_graph(g, mesh=self.mesh,
                                     lane=self.lane if lane is None else lane,
                                     dtype=self.weight.dtype,
                                     comm_dtype=self.comm_dtype,
                                     device=self.device)


class Sharded2DEngine(ShardedEngine):
    """Grid-partitioned CPAA engine (beyond-paper collective optimization).

    Rank (r, c) owns edges with dst in row-chunk r and src in nested column
    group c; per round the partial row results are reduce-scattered over
    the column group (~n/R floats) and the new column chunks all-gathered
    over the row group (~n/C floats) — see `graph.partition.Partition2D`.

    Internal layout: this rank's column chunk c of the nested COLUMN
    layout, `padded(x)[perm]` with perm = col_layout_perm(n_pad, grid)
    ([n_pad / C] rows, the same on every rank of grid column c). With
    perm=None (the `cpaa_distributed_2d` convention) callers pass and
    receive column-layout vectors themselves.
    """

    name = "sharded_2d"
    reduce_dim = "col"

    def __init__(self, mesh, src_local: torch.Tensor,
                 dst_local: torch.Tensor, weight: torch.Tensor,
                 perm: torch.Tensor | None, inv_perm: torch.Tensor | None,
                 n_orig: int, n_pad: int, rows_per_chunk: int,
                 comm_dtype=None, lane: int = 128):
        self.mesh = mesh
        self.coord = grid_coordinate(mesh)
        self.row_group = mesh.get_group(0)   # ranks (*, c)
        self.col_group = mesh.get_group(1)   # ranks (r, *)
        self.src_local = src_local     # [E] int32 (col-chunk-local src)
        self.dst_local = dst_local     # [E] int32 (row-chunk-local dst)
        self.weight = weight           # [E] f32
        self.perm = perm               # [n_pad] column-layout gather, or None
        self.inv_perm = inv_perm       # [n_pad] inverse gather, or None
        self.n_orig = n_orig
        self.n_pad = n_pad
        self.rows_per_chunk = rows_per_chunk
        self.cols_per_chunk = n_pad // int(mesh.shape[1])
        self.comm_dtype = None if comm_dtype is None \
            else as_torch_dtype(comm_dtype)
        self.lane = lane
        self._lo = lo = self.coord[1] * self.cols_per_chunk
        self._perm_local = None if perm is None \
            else perm[lo:lo + self.cols_per_chunk]
        self._inv_orig = None if inv_perm is None else inv_perm[:n_orig]
        # the vectors are sharded over col and replicated down row: a sum
        # over the world would count each entry R times
        self.reduce_group = self.col_group

    @classmethod
    def from_graph(cls, g: Graph, mesh=None,
                   grid: tuple[int, int] | None = None, lane: int = 128,
                   dtype=torch.float32, comm_dtype=None,
                   device=None) -> "Sharded2DEngine":
        """Partition on the host and put this rank's [r, c] slice on
        `device` (None = cuda). mesh None = an (R, C) mesh named
        ("row", "col") over the world, (R, C) = `grid` or the most-square
        factorization of the world size."""
        dev = resolve_device(device)
        if mesh is None:
            grid = factor_grid(world_size()) if grid is None \
                else tuple(grid)
            mesh = init_mesh(grid, ("row", "col"), device=dev)
        _check_mesh(mesh, dev)
        if mesh.ndim != 2 or \
                (grid is not None and tuple(grid) != tuple(mesh.shape)):
            raise ValueError(f"sharded_2d needs a 2-D mesh of grid {grid}, "
                             f"got {tuple(mesh.shape)}")
        check_int32_range(g.n, g.m, what="Sharded2DEngine")
        grid = tuple(int(s) for s in mesh.shape)
        part = partition_2d(g, grid, lane=lane)
        src_local, dst_local, weight = put_partition_2d(part, mesh)
        perm = col_layout_perm(part.n, grid)
        return cls(mesh=mesh, src_local=src_local, dst_local=dst_local,
                   weight=weight.to(as_torch_dtype(dtype)),
                   perm=torch.from_numpy(perm).to(dev),
                   inv_perm=torch.from_numpy(np.argsort(perm)).to(dev),
                   n_orig=g.n, n_pad=part.n,
                   rows_per_chunk=part.rows_per_chunk,
                   comm_dtype=comm_dtype, lane=lane)

    def to_internal(self, x: torch.Tensor) -> torch.Tensor:
        if self._perm_local is None:
            return x[self._lo:self._lo + self.cols_per_chunk].contiguous()
        pad = self.n_pad - x.shape[0]
        if pad:
            x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
        return x.index_select(0, self._perm_local)

    def from_internal(self, x: torch.Tensor) -> torch.Tensor:
        full = all_gather(x, self.col_group, tag=self.name, site="layout",
                          dim="col")
        return full if self._inv_orig is None \
            else full.index_select(0, self._inv_orig)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        _count_apply(self.name)
        return spmv_2d_shard(x, self.src_local, self.dst_local, self.weight,
                             row_group=self.row_group,
                             col_group=self.col_group,
                             rows=self.rows_per_chunk,
                             comm_dtype=self.comm_dtype, tag=self.name)

    def refresh(self, g: Graph, delta=None, *, dg=None, lane=None,
                **kw) -> "Sharded2DEngine":
        """Rebuild the grid partition for the updated graph on the SAME
        mesh (grid, lane, dtypes and device kept). Every rank must call
        it."""
        return type(self).from_graph(g, mesh=self.mesh,
                                     lane=self.lane if lane is None else lane,
                                     dtype=self.weight.dtype,
                                     comm_dtype=self.comm_dtype,
                                     device=self.device)


def as_engine(obj) -> CooEngine | HubTailEngine | BlockEllEngine:
    """Coerce a DeviceGraph to the COO engine; pass engines through."""
    if isinstance(obj, DeviceGraph):
        return CooEngine(obj)
    if hasattr(obj, "apply") and hasattr(obj, "to_internal"):
        return obj
    raise TypeError(f"expected DeviceGraph or Engine, got {type(obj)!r}")


def _default_min_fill(device: torch.device) -> float:
    # cuda takes the reference's accelerator bar (0.01, chosen for the TPU
    # and not yet measured on the card: ROADMAP "measure min_fill for
    # cuda"); the CPU keeps the reference's off-TPU bar, where the plain
    # einsum spends real flops on zero fill.
    return 0.01 if device.type == "cuda" else 0.05


# auto mode only shards graphs at least this large: below it one rank's
# SpMV is faster than any per-round collective (1D moves ~n floats per rank
# per round, 2D ~n/R + n/C but needs a still larger n, 4x this bar, to
# amortize its two collective phases and the grid padding). The
# reference's bar, set for the TPU and not yet measured across cards.
SHARDED_MIN_N = 1 << 16

# auto mode considers the hub/tail split only past this size and only when
# hubs (deg >= HUB_MIN_DEG) receive at least this fraction of all edges
# (the reference's HUB_TAIL_MIN_N / HUB_TAIL_MIN_EDGE_FRAC, set on a CPU
# and not yet measured on the card)
HUB_TAIL_MIN_N = 1 << 17
HUB_TAIL_MIN_EDGE_FRAC = 0.4


def _hub_edge_fraction(g: Graph, thr: int) -> float:
    """Fraction of directed edges whose destination has deg >= thr."""
    deg = g.deg
    m = max(int(g.m), 1)
    return float(deg[deg >= thr].sum()) / m


def auto_shard_mode(g: Graph, *, mesh=None,
                    sharded_min_n: int | None = None) -> str | None:
    """Auto mode's sharding branch alone: "sharded_2d" / "sharded_1d" when
    auto shards `g`, else None. The device count is the mesh's size, else
    the initialized process group's world size (1 without a group): with
    >= 2 ranks and g.n >= `sharded_min_n` (default SHARDED_MIN_N) it
    shards — 2D when >= 4 ranks, n >= 4x the bar and the mesh (if given)
    has two dimensions, 1D rows otherwise."""
    n_dev = mesh.size() if mesh is not None else world_size()
    thr = SHARDED_MIN_N if sharded_min_n is None else sharded_min_n
    if n_dev < 2 or g.n < thr:
        return None
    if n_dev >= 4 and g.n >= 4 * thr and (mesh is None or mesh.ndim >= 2):
        return "sharded_2d"
    return "sharded_1d"


def _auto_choice(g: Graph, batch: int | None = None, *, block: int = 128,
                 min_fill: float | None = None, device=None, mesh=None,
                 sharded_min_n: int | None = None, probe_cache=None):
    """The zero-cost heuristic's decision WITHOUT building anything:
    (mode, perm), perm being the BFS permutation when the fill probe ran
    fresh (reused by the block-ELL build; None on a probe-cache hit or a
    non-tiled pick). `probe_cache` is any object with get_fill(g, block) /
    put_fill(g, block, fill) — see core.autotune.

    It shards first when `auto_shard_mode` says so.
    """
    dev = torch.device("cuda" if device is None else device)
    shard = auto_shard_mode(g, mesh=mesh, sharded_min_n=sharded_min_n)
    if shard is not None:
        return shard, None
    if g.n >= HUB_TAIL_MIN_N and \
            _hub_edge_fraction(g, HUB_MIN_DEG) >= HUB_TAIL_MIN_EDGE_FRAC:
        return "hub_tail", None
    if g.n < 2 * block or (batch is not None and batch < 8 and g.n < 8 * block):
        return "coo", None
    # the probe cache remembers the fill per (graph fingerprint, block), so
    # re-probes of an already-seen shape skip the host BFS + tile census
    fill = perm = None
    if probe_cache is not None:
        fill = probe_cache.get_fill(g, block)
    if fill is None:
        fill, perm = block_fill_rate(g, block=block)
        if probe_cache is not None:
            probe_cache.put_fill(g, block, fill)
    threshold = _default_min_fill(dev) if min_fill is None else min_fill
    if fill < threshold:
        return "coo", None
    return "fused", perm


def heuristic_mode(g: Graph, batch: int | None = None, *, block: int = 128,
                   min_fill: float | None = None, device=None, mesh=None,
                   sharded_min_n: int | None = None,
                   probe_cache=None) -> str:
    """What `select_engine(mode="auto")` picks for (g, batch) on `device`
    (None = cuda), as a mode string, without building the engine — the
    zero-cost tier the autotuner measures against (and ties back toward)."""
    return _auto_choice(g, batch, block=block, min_fill=min_fill,
                        device=device, mesh=mesh,
                        sharded_min_n=sharded_min_n,
                        probe_cache=probe_cache)[0]


def select_engine(g: Graph, batch: int | None = None, mode: str = "auto", *,
                  dg: DeviceGraph | None = None, dtype=torch.float32,
                  block: int = 128, min_fill: float | None = None,
                  stable_shapes: bool = False, weight_dtype=None,
                  device=None, mesh=None,
                  grid: tuple[int, int] | None = None, lane: int = 128,
                  comm_dtype=None, sharded_min_n: int | None = None,
                  tuner=None, probe_cache=None):
    """Pick and build the solve engine for a graph (host side, once per
    epoch).

    mode: "coo" | "hub_tail" | "block_ell" | "fused" | "sharded_1d" |
    "sharded_2d" force a format (dashes accepted: "hub-tail"); "auto" first
    counts the ranks (the mesh's size, else the process group's world
    size) — with >= 2 and g.n >= `sharded_min_n` it shards (see
    `_auto_choice`) — then, on one rank, takes hub/tail for large skewed
    graphs (n >= HUB_TAIL_MIN_N and hubs receiving
    >= HUB_TAIL_MIN_EDGE_FRAC of the edges), COO for tiny graphs and the
    fused block-ELL engine when the tile fill clears `min_fill` (default
    0.01 on cuda, 0.05 on cpu), COO otherwise. "tuned" replaces
    the guess with a measurement: the workload-bucketed autotuner
    (core.autotune) consults its persistent store and, on a miss, times the
    feasible candidates on `device` and picks the measured winner
    (tie-break toward the heuristic's choice for that device).
    dg: reuse an existing DeviceGraph for the COO path (the registry passes
    its padded device graph). stable_shapes pads the ELL slot count to a
    power of two. weight_dtype packs the COO edge weights and hub/tail's
    inv_deg (bf16 halves them; accumulation stays in `dtype`); the tile
    engines keep f32 values. device None means cuda (raises without a
    GPU).
    mesh / grid / lane / comm_dtype / sharded_min_n: the sharded engines'
    knobs — a `DeviceMesh` to run on (default: `init_mesh` over the whole
    world, starting a single-rank group when none is initialized), the
    (R, C) grid for sharded_2d, the partition padding lane, an optional
    wire dtype for the all-gathers (bf16 halves them; reductions stay
    f32), and auto's sharding bar. The sharded modes are SPMD: every rank
    calls `select_engine` with the same arguments.
    tuner: the `core.autotune.Autotuner` mode="tuned" consults (None = the
    process-wide default over `$REPRO_TORCH_TUNE_CACHE`).
    probe_cache: fill-probe cache for auto mode (get_fill/put_fill; None =
    probe every call — the serving registry threads the process cache).
    """
    dev = resolve_device(device)
    mode = mode.replace("-", "_")
    if mode not in ENGINE_MODES:
        raise ValueError(f"engine mode {mode!r} not in {ENGINE_MODES}")
    perm = None
    if mode == "tuned":
        from repro_torch.core.autotune import default_tuner  # no cycle
        t = default_tuner() if tuner is None else tuner
        dec = t.tune(g, batch=batch, dg=dg, dtype=dtype, block=block,
                     min_fill=min_fill, stable_shapes=stable_shapes,
                     weight_dtype=weight_dtype, device=dev, mesh=mesh,
                     grid=grid, lane=lane, comm_dtype=comm_dtype,
                     sharded_min_n=sharded_min_n)
        if dec.engine is not None:   # freshly measured winner: reuse as-is
            return dec.engine
        mode = dec.mode
    if mode == "auto":
        mode, perm = _auto_choice(g, batch, block=block, min_fill=min_fill,
                                  device=dev, mesh=mesh,
                                  sharded_min_n=sharded_min_n,
                                  probe_cache=probe_cache)
    if mode == "sharded_1d":
        return Sharded1DEngine.from_graph(g, mesh=mesh, lane=lane,
                                          dtype=dtype, comm_dtype=comm_dtype,
                                          device=dev)
    if mode == "sharded_2d":
        return Sharded2DEngine.from_graph(g, mesh=mesh, grid=grid, lane=lane,
                                          dtype=dtype, comm_dtype=comm_dtype,
                                          device=dev)
    if mode == "coo":
        return CooEngine(dg if dg is not None else
                         device_graph(g, as_torch_dtype(dtype),
                                      weight_dtype=weight_dtype, device=dev))
    if mode == "hub_tail":
        return HubTailEngine.from_graph(g, dtype=dtype,
                                        weight_dtype=weight_dtype,
                                        device=dev)
    cls = BlockEllEngine if mode == "block_ell" else FusedBlockEllEngine
    return cls.from_graph(g, block=block, pad_slots_to_pow2=stable_shapes,
                          perm=perm, device=dev)
