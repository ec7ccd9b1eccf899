"""SpMM engines: the solver hot path behind one interface (PyTorch port of
`repro.core.engine`).

Every PageRank round is one application of P = A D^{-1} plus O(n) vector
work. How P x is computed is a format choice, so it lives behind an engine:

  * CooEngine           — gather + `index_add_` over the COO edge list with
                          the 1/deg[src] weights folded into a per-edge
                          array. Works for any graph and any batch.
  * BlockEllEngine      — the block-ELL SpMM kernel (`kernels/bsr_spmm`):
                          vertices BFS-reordered so edges cluster into BxB
                          tiles, each tile a dense product. The engine owns
                          the perm/padding round-trip, so callers see
                          original vertex ids.
  * FusedBlockEllEngine — BlockEllEngine whose Chebyshev round is the fused
                          `cheb_step` kernel (5nB bytes per round instead of
                          8nB).

Solvers call:

    x  = eng.to_internal(p)        # once per solve: layout in
    y  = eng.apply(x)              # per round: y = P x
    t, acc = eng.cheb_round(y, t, acc, ck)   # per round: vector work
    pi = eng.from_internal(acc)    # once per solve: layout out

Mass invariant (the adaptive solver depends on it): the internal layout is
a permutation of the caller's vertices plus ZERO-mass padding rows that stay
zero through every `apply`/`cheb_round`, so column sums and L1 norms on
internal-layout arrays equal the external ones.

Not ported yet, each raising NotImplementedError that names its ROADMAP
item: the hub/tail engine (A3), measured selection ("tuned", A7) and the
sharded engines (A9). `refresh` (edge updates) comes with A6.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.graph.ops import DeviceGraph, as_torch_dtype, device_graph, \
    spmm, spmv
from repro_torch.graph.structure import (BlockEll, Graph, block_fill_rate,
                                         build_block_ell)
from repro_torch.kernels.bsr_spmm.ops import bsr_spmm
from repro_torch.kernels.bsr_spmm.ref import bsr_spmm_ref
from repro_torch.kernels.cheb_step.ops import cheb_step
from repro_torch.kernels.cheb_step.ref import cheb_step_ref

__all__ = [
    "CooEngine",
    "BlockEllEngine",
    "FusedBlockEllEngine",
    "as_engine",
    "heuristic_mode",
    "select_engine",
    "ENGINE_MODES",
    "UNPORTED_MODES",
    "apply_counts",
    "reset_apply_counts",
]

ENGINE_MODES = ("auto", "tuned", "coo", "hub_tail", "block_ell", "fused",
                "sharded_1d", "sharded_2d")

# modes of the reference that this port does not run yet -> ROADMAP item
UNPORTED_MODES = {
    "hub_tail": "A3 (HubTailEngine)",
    "tuned": "A7 (autotuner)",
    "sharded_1d": "A9 (sharded engines)",
    "sharded_2d": "A9 (sharded engines)",
}

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


class CooEngine:
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


class BlockEllEngine:
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


class FusedBlockEllEngine(BlockEllEngine):
    """Block-ELL SpMM + the fused Chebyshev-update kernel in every round."""

    name = "block_ell_fused"

    def cheb_round(self, y, t, acc, ck):
        if self.use_kernel:
            return cheb_step(y, t, acc, ck)
        return cheb_step_ref(y, t, acc, ck)


def as_engine(obj) -> CooEngine | BlockEllEngine:
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


# auto mode considers the hub/tail split only past this size and only when
# hubs (deg >= HUB_MIN_DEG) receive at least this fraction of all edges
# (the reference's HUB_TAIL_MIN_N / HUB_TAIL_MIN_EDGE_FRAC /
# HubTailEngine.DEFAULT_MIN_DEG)
HUB_TAIL_MIN_N = 1 << 17
HUB_TAIL_MIN_EDGE_FRAC = 0.4
HUB_MIN_DEG = 32


def _hub_edge_fraction(g: Graph, thr: int) -> float:
    """Fraction of directed edges whose destination has deg >= thr."""
    deg = g.deg
    m = max(int(g.m), 1)
    return float(deg[deg >= thr].sum()) / m


def _auto_choice(g: Graph, batch: int | None = None, *, block: int = 128,
                 min_fill: float | None = None, device=None):
    """The zero-cost heuristic's decision WITHOUT building anything:
    (mode, perm), perm being the BFS permutation of the fill probe (reused
    by the block-ELL build) or None.

    Auto counts only the one device it was given, so it never shards.
    """
    dev = torch.device("cuda" if device is None else device)
    if g.n >= HUB_TAIL_MIN_N and \
            _hub_edge_fraction(g, HUB_MIN_DEG) >= HUB_TAIL_MIN_EDGE_FRAC:
        return "hub_tail", None
    if g.n < 2 * block or (batch is not None and batch < 8 and g.n < 8 * block):
        return "coo", None
    fill, perm = block_fill_rate(g, block=block)
    threshold = _default_min_fill(dev) if min_fill is None else min_fill
    if fill < threshold:
        return "coo", None
    return "fused", perm


def heuristic_mode(g: Graph, batch: int | None = None, *, block: int = 128,
                   min_fill: float | None = None, device=None) -> str:
    """What `select_engine(mode="auto")` picks for (g, batch) on `device`
    (None = cuda), as a mode string, without building the engine."""
    return _auto_choice(g, batch, block=block, min_fill=min_fill,
                        device=device)[0]


def select_engine(g: Graph, batch: int | None = None, mode: str = "auto", *,
                  dg: DeviceGraph | None = None, dtype=torch.float32,
                  block: int = 128, min_fill: float | None = None,
                  stable_shapes: bool = False, weight_dtype=None,
                  device=None):
    """Pick and build the solve engine for a graph (host side, once per
    epoch).

    mode: "coo" | "block_ell" | "fused" force a format (dashes accepted);
    "auto" takes, on the one device it is given, COO for tiny graphs and
    the fused block-ELL engine when the tile fill clears `min_fill`
    (default 0.01 on cuda, 0.05 on cpu), COO otherwise. Modes the port
    does not run yet ("hub_tail", "tuned", "sharded_1d", "sharded_2d"),
    and an auto pick of hub_tail, raise NotImplementedError naming the
    ROADMAP item; no other engine is substituted.
    dg: reuse an existing DeviceGraph for the COO path (the registry passes
    its padded device graph). stable_shapes pads the ELL slot count to a
    power of two. device None means cuda (raises without a GPU).
    """
    dev = resolve_device(device)
    mode = mode.replace("-", "_")
    if mode not in ENGINE_MODES:
        raise ValueError(f"engine mode {mode!r} not in {ENGINE_MODES}")
    perm = None
    if mode == "auto":
        mode, perm = _auto_choice(g, batch, block=block, min_fill=min_fill,
                                  device=dev)
    if mode in UNPORTED_MODES:
        raise NotImplementedError(
            f"engine mode {mode!r} is not ported to repro_torch yet "
            f"(ROADMAP {UNPORTED_MODES[mode]})")
    if mode == "coo":
        return CooEngine(dg if dg is not None else
                         device_graph(g, as_torch_dtype(dtype),
                                      weight_dtype=weight_dtype, device=dev))
    cls = BlockEllEngine if mode == "block_ell" else FusedBlockEllEngine
    return cls.from_graph(g, block=block, pad_slots_to_pow2=stable_shapes,
                          perm=perm, device=dev)
