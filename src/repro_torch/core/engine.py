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

Solvers call:

    x  = eng.to_internal(p)        # once per solve: layout in
    y  = eng.apply(x)              # per round: y = P x
    t, acc = eng.cheb_round(y, t, acc, ck)   # per round: vector work
    pi = eng.from_internal(acc)    # once per solve: layout out

Mass invariant (the adaptive solver depends on it): the internal layout is
a permutation of the caller's vertices plus ZERO-mass padding rows that stay
zero through every `apply`/`cheb_round`, so column sums and L1 norms on
internal-layout arrays equal the external ones.

Refresh protocol (edge updates): `eng.refresh(g, delta, dg=...)` returns
the engine for the updated graph. COO needs nothing when the registry
patched its own DeviceGraph in place; hub/tail rebuilds on the host (a
delta can move vertices across the hub bar); block-ELL re-tiles, reusing
its BFS perm when the delta touched at most REFRESH_PERM_MAX_TOUCHED of
the vertices.

Measured selection ("tuned") goes through `core.autotune`. Not ported
yet, raising NotImplementedError that names its ROADMAP item: the sharded
engines (A10).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.graph.ops import DeviceGraph, as_torch_dtype, \
    check_int32_range, device_graph, spmm, spmv, upload
from repro_torch.graph.structure import (BlockEll, Graph, block_fill_rate,
                                         build_block_ell)
from repro_torch.kernels.bsr_spmm.ops import bsr_spmm
from repro_torch.kernels.bsr_spmm.ref import bsr_spmm_ref
from repro_torch.kernels.cheb_step.ops import cheb_step
from repro_torch.kernels.cheb_step.ref import cheb_step_ref

__all__ = [
    "CooEngine",
    "HubTailEngine",
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

# hub bar of the degree split (the reference's HubTailEngine.DEFAULT_MIN_DEG)
HUB_MIN_DEG = 32

ENGINE_MODES = ("auto", "tuned", "coo", "hub_tail", "block_ell", "fused",
                "sharded_1d", "sharded_2d")

# modes of the reference that this port does not run yet -> ROADMAP item
UNPORTED_MODES = {
    "sharded_1d": "A10 (sharded engines)",
    "sharded_2d": "A10 (sharded engines)",
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

    def refresh(self, g: Graph | None, delta=None, *, dg: DeviceGraph,
                **kw) -> "CooEngine":
        """Refresh after an edge-update batch: when the caller patched this
        engine's own DeviceGraph in place (the incremental path) the engine
        is already current; another dg swaps in."""
        return self if dg is self.dg else CooEngine(dg)


class HubTailEngine:
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
    """Block-ELL SpMM + the fused Chebyshev-update kernel in every round."""

    name = "block_ell_fused"

    def cheb_round(self, y, t, acc, ck):
        if self.use_kernel:
            return cheb_step(y, t, acc, ck)
        return cheb_step_ref(y, t, acc, ck)


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


def _auto_choice(g: Graph, batch: int | None = None, *, block: int = 128,
                 min_fill: float | None = None, device=None,
                 probe_cache=None):
    """The zero-cost heuristic's decision WITHOUT building anything:
    (mode, perm), perm being the BFS permutation when the fill probe ran
    fresh (reused by the block-ELL build; None on a probe-cache hit or a
    non-tiled pick). `probe_cache` is any object with get_fill(g, block) /
    put_fill(g, block, fill) — see core.autotune.

    Auto counts only the one device it was given, so it never shards.
    """
    dev = torch.device("cuda" if device is None else device)
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
                   min_fill: float | None = None, device=None,
                   probe_cache=None) -> str:
    """What `select_engine(mode="auto")` picks for (g, batch) on `device`
    (None = cuda), as a mode string, without building the engine — the
    zero-cost tier the autotuner measures against (and ties back toward)."""
    return _auto_choice(g, batch, block=block, min_fill=min_fill,
                        device=device, probe_cache=probe_cache)[0]


def select_engine(g: Graph, batch: int | None = None, mode: str = "auto", *,
                  dg: DeviceGraph | None = None, dtype=torch.float32,
                  block: int = 128, min_fill: float | None = None,
                  stable_shapes: bool = False, weight_dtype=None,
                  device=None, tuner=None, probe_cache=None):
    """Pick and build the solve engine for a graph (host side, once per
    epoch).

    mode: "coo" | "hub_tail" | "block_ell" | "fused" force a format
    (dashes accepted: "hub-tail"); "auto" takes, on the one device it is
    given, hub/tail for large skewed graphs (n >= HUB_TAIL_MIN_N and hubs
    receiving >= HUB_TAIL_MIN_EDGE_FRAC of the edges), COO for tiny graphs
    and the fused block-ELL engine when the tile fill clears `min_fill`
    (default 0.01 on cuda, 0.05 on cpu), COO otherwise. "tuned" replaces
    the guess with a measurement: the workload-bucketed autotuner
    (core.autotune) consults its persistent store and, on a miss, times the
    feasible candidates on `device` and picks the measured winner
    (tie-break toward the heuristic's choice for that device). The
    sharded modes ("sharded_1d", "sharded_2d") raise NotImplementedError
    naming the ROADMAP item; no other engine is substituted.
    dg: reuse an existing DeviceGraph for the COO path (the registry passes
    its padded device graph). stable_shapes pads the ELL slot count to a
    power of two. weight_dtype packs the COO edge weights and hub/tail's
    inv_deg (bf16 halves them; accumulation stays in `dtype`); the tile
    engines keep f32 values. device None means cuda (raises without a
    GPU).
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
                     weight_dtype=weight_dtype, device=dev)
        if dec.engine is not None:   # freshly measured winner: reuse as-is
            return dec.engine
        mode = dec.mode
    if mode == "auto":
        mode, perm = _auto_choice(g, batch, block=block, min_fill=min_fill,
                                  device=dev, probe_cache=probe_cache)
    if mode in UNPORTED_MODES:
        raise NotImplementedError(
            f"engine mode {mode!r} is not ported to repro_torch yet "
            f"(ROADMAP {UNPORTED_MODES[mode]})")
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
