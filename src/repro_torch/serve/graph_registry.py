"""Named, warm graphs for the online PPR query service (port of
`repro.serve.graph_registry`).

The registry owns serving-side graph state:

  * every graph is registered under a name and kept device-resident
    (`DeviceGraph`, edge arrays padded to a power-of-two bucket with
    zero-weight edges) so queries never pay a host->device transfer;
  * each registered graph carries a solve engine, built once per
    (graph, epoch) by `select_engine` with `stable_shapes=True` (ELL slots
    padded to a power of two) and reused by every tick;
  * each graph carries an epoch, stamped into every result-cache key;
  * `ChebSchedule`s are precomputed per (c, tol) with their coefficient
    vector on the device, and `adaptive_schedule` gives the round cap and
    residual-check chunk of the residual-controlled solve.

Edge updates come in two flavours, selected by `update_mode`:

  * **incremental** (default) — `apply_updates` computes the batch's
    `EdgeDelta` (O(batch log m), no pass over the edge set) and, when the
    changed slots fit the current edge bucket, PATCHES the device graph in
    place through the host `EdgeSlots` mirror; the engine is kept current
    by its `refresh(delta)` hook (free for COO, a host rebuild for
    hub/tail, a re-tile reusing the BFS perm for block-ELL);
  * **rebuild** — every batch takes the full path: the sorted key set is
    merged, `from_undirected_edges` rebuilds the host graph, and a fresh
    DeviceGraph + `select_engine` follow. The incremental mode falls back
    to exactly this when a batch overflows the bucket (which then grows).

A batch whose effective delta is EMPTY (duplicate inserts, deletes of
absent edges) changes nothing: no rebuild, no epoch bump. The chunked
ingestion, the autotuner and the metrics binding come with later slices.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.chebyshev import ChebSchedule, default_chunk, \
    make_schedule
from repro_torch.core.engine import CooEngine, select_engine
from repro_torch.device import resolve_device
from repro_torch.graph.ops import (DeviceGraph, EdgeSlots, as_torch_dtype,
                                   device_graph, patch_device_graph)
from repro_torch.graph.structure import EdgeDelta, Graph, edge_delta

__all__ = ["AdaptiveSchedule", "RegisteredGraph", "GraphRegistry",
           "UPDATE_MODES"]

UPDATE_MODES = ("incremental", "rebuild")


@dataclass(frozen=True)
class AdaptiveSchedule:
    """Operating point of one residual-controlled solve: the a-priori
    Formula 8 round count (a hard cap) and the residual-check period."""

    c: float
    tol: float
    max_rounds: int
    chunk: int


class RegisteredGraph:
    """One serving graph: host copy, device copy, the solve engine picked
    for it, and the epoch stamped into every cache key. `keys` is the
    sorted canonical undirected key set and `slots` the host mirror of the
    padded device arrays (None when the graph broke the symmetrized-edge
    contract, which forces rebuilds); `last_delta` /
    `last_update_incremental` record what the latest update batch did.

    `host` is a LAZY view after an in-place update: the COO serving path
    never reads the host Graph per batch, so the incremental path marks it
    stale and the next reader (a re-tiling refresh, a test oracle, the CSR
    walk) materializes it from the slot mirror."""

    def __init__(self, name: str, host: Graph, dg: DeviceGraph,
                 engine=None, epoch: int = 0, keys=None, slots=None):
        self.name = name
        self._host = host
        self._host_stale = False
        self.dg = dg
        self.engine = engine
        self.epoch = epoch
        self.keys = keys
        self.slots = slots
        self.last_delta: EdgeDelta | None = None
        self.last_update_incremental = False
        self._csr_cache = None

    @property
    def host(self) -> Graph:
        if self._host_stale:
            self._host = self.slots.to_graph()
            self._host_stale = False
        return self._host

    @host.setter
    def host(self, g: Graph) -> None:
        self._host = g
        self._host_stale = False

    @property
    def n(self) -> int:
        return self._host.n      # the vertex set is fixed at registration


def _undirected_keys(g: Graph) -> np.ndarray:
    """Canonical int64 keys lo * n + hi of the undirected edge set (each
    edge once; self loops — the isolated-vertex patch — excluded)."""
    lo = np.minimum(g.src, g.dst).astype(np.int64)
    hi = np.maximum(g.src, g.dst).astype(np.int64)
    keep = lo < hi
    return np.unique(lo[keep] * g.n + hi[keep])


def _edge_bucket(m: int, minimum: int = 1024) -> int:
    """Smallest power of two >= m (at least `minimum`): the padded device
    edge-array length."""
    b = minimum
    while b < m:
        b *= 2
    return b


def _edges_to_keys(n: int, edges) -> np.ndarray:
    """[(u, v), ...] -> canonical keys; validates vertex ids."""
    arr = np.asarray(list(edges), np.int64).reshape(-1, 2)
    if arr.size and (arr.min() < 0 or arr.max() >= n):
        raise ValueError(f"edge endpoint out of range [0, {n})")
    if np.any(arr[:, 0] == arr[:, 1]):
        raise ValueError("self loops are not valid undirected edges")
    lo = np.minimum(arr[:, 0], arr[:, 1])
    hi = np.maximum(arr[:, 0], arr[:, 1])
    return np.unique(lo * n + hi)


class GraphRegistry:
    """Name -> RegisteredGraph, plus the shared (c, tol) schedule cache.

    Args:
        device: where graphs, engines and solves live (None = cuda; raises
            without a GPU).
        dtype: accumulation dtype of device graphs and solves.
        engine: engine mode for `select_engine` ("auto", "coo",
            "hub_tail", "block_ell", "fused"; the unported modes raise).
        batch_hint: expected micro-batch width, steering auto selection.
        update_mode: "incremental" (in-place device patch when the batch
            fits the edge bucket) or "rebuild" (always the full path).
        weight_dtype: packed storage dtype for COO edge weights and
            hub/tail's inv_deg (None = `dtype`); accumulation stays in
            `dtype`.

    Invariant: `rg.engine` is always current for (graph, epoch) — every
    effective update refreshes or rebuilds it before the epoch bumps.
    """

    def __init__(self, device=None, dtype=torch.float32,
                 engine: str = "auto", batch_hint: int | None = None,
                 update_mode: str = "incremental", weight_dtype=None):
        if update_mode not in UPDATE_MODES:
            raise ValueError(f"update_mode {update_mode!r} not in "
                             f"{UPDATE_MODES}")
        self.device = resolve_device(device)
        self.update_mode = update_mode
        self.dtype = as_torch_dtype(dtype)
        self.engine_mode = engine
        self.batch_hint = batch_hint
        self.weight_dtype = None if weight_dtype is None \
            else as_torch_dtype(weight_dtype)
        self._graphs: dict[str, RegisteredGraph] = {}
        self._schedules: dict[tuple[float, float],
                              tuple[ChebSchedule, torch.Tensor]] = {}
        self._adaptive: dict[tuple[float, float, int | None],
                             AdaptiveSchedule] = {}

    def _build(self, g: Graph):
        """(DeviceGraph, engine, EdgeSlots) for one epoch of a graph. The
        COO engine reuses the padded device graph; block-ELL engines pad
        their slot count to a power of two. The EdgeSlots mirror is what
        later updates patch through (None, and a plain `device_graph`, for
        a graph that breaks the symmetrized-edge contract: those always
        rebuild)."""
        try:
            slots = EdgeSlots.from_graph(g, cap=_edge_bucket(g.m))
        except ValueError:
            slots = None
        if slots is not None:
            dg = slots.to_device(self.dtype, weight_dtype=self.weight_dtype,
                                 device=self.device)
        else:
            dg = device_graph(g, self.dtype, pad_edges_to=_edge_bucket(g.m),
                              weight_dtype=self.weight_dtype,
                              device=self.device)
        eng = select_engine(g, batch=self.batch_hint, mode=self.engine_mode,
                            dg=dg, dtype=self.dtype, stable_shapes=True,
                            weight_dtype=self.weight_dtype,
                            device=self.device)
        return dg, eng, slots

    # ---- graphs -----------------------------------------------------------
    def register(self, name: str, g: Graph) -> RegisteredGraph:
        """Register `g` under `name`: build its device graph + engine once
        and keep them warm (epoch 0).

        Raises:
            ValueError: the name is already registered.
        """
        if name in self._graphs:
            raise ValueError(f"graph {name!r} already registered")
        dg, eng, slots = self._build(g)
        rg = RegisteredGraph(name=name, host=g, dg=dg, engine=eng,
                             keys=_undirected_keys(g), slots=slots)
        self._graphs[name] = rg
        return rg

    def get(self, name: str) -> RegisteredGraph:
        """The registered graph for `name`.

        Raises:
            KeyError: unknown name (the message lists the known ones).
        """
        if name not in self._graphs:
            raise KeyError(f"unknown graph {name!r}; known: "
                           f"{sorted(self._graphs)}")
        return self._graphs[name]

    def names(self) -> list[str]:
        """Sorted names of every registered graph."""
        return sorted(self._graphs)

    # ---- dynamic updates --------------------------------------------------
    def apply_updates(self, name: str, insert=(), delete=()) -> RegisteredGraph:
        """Apply a batch of undirected edge inserts/deletes.

        Duplicate inserts and deletes of absent edges are no-ops; a batch
        whose EFFECTIVE delta is empty changes nothing — no rebuild, no
        epoch bump. The vertex set is fixed at registration.

        With `update_mode="incremental"` an effective batch that fits the
        current edge bucket is applied as an in-place device patch + engine
        refresh; otherwise (mode "rebuild", bucket overflow, or a graph
        without an EdgeSlots mirror) the full rebuild runs. Either way the
        epoch bumps once per effective batch, and `rg.last_delta` reports
        which edges and vertices moved.

        Raises:
            KeyError: unknown graph.
            ValueError: an endpoint out of range or a self loop.
        """
        rg = self.get(name)
        n = rg.n
        ins = _edges_to_keys(n, insert) if len(insert) else \
            np.empty(0, np.int64)
        dele = _edges_to_keys(n, delete) if len(delete) else \
            np.empty(0, np.int64)
        if rg.keys is None:
            rg.keys = _undirected_keys(rg.host)
        delta = edge_delta(n, rg.keys, ins, dele)
        rg.last_delta = delta
        rg.last_update_incremental = False
        if delta.is_noop:
            return rg

        patch = None
        if self.update_mode == "incremental" and rg.slots is not None:
            patch = rg.slots.apply_delta(delta)
        if patch is not None:
            patch_device_graph(rg.dg, patch)
            rg._host_stale = True   # materialized on next read, not per batch
            if isinstance(rg.engine, CooEngine):
                # the COO engine shares rg.dg, already patched in place:
                # refresh without materializing the host Graph
                rg.engine = rg.engine.refresh(None, delta, dg=rg.dg)
            else:
                rg.engine = rg.engine.refresh(rg.host, delta, dg=rg.dg,
                                              stable_shapes=True)
            # the mirror keeps the sorted key set; alias it (apply_delta
            # replaces, never mutates, its key array)
            rg.keys = rg.slots.ekeys
            rg.last_update_incremental = True
        else:
            # fallback: merge the sorted key set (searchsorted positions,
            # no set ops over m) and rebuild
            keys = np.delete(rg.keys,
                             np.searchsorted(rg.keys, delta.deleted))
            keys = np.insert(keys, np.searchsorted(keys, delta.inserted),
                             delta.inserted)
            g_new = Graph.from_undirected_edges(n, keys // n, keys % n)
            rg.host = g_new
            rg.dg, rg.engine, rg.slots = self._build(g_new)
            rg.keys = keys
        rg.epoch += 1
        rg._csr_cache = None
        return rg

    def hop_neighborhood(self, name: str, vertices, radius: int,
                         extra: int = 0):
        """Boolean [n] mask of every vertex within `radius` hops of
        `vertices` on the CURRENT host graph (radius 0 = the set itself).
        With `extra > 0`, returns (mask, outer_mask) where outer_mask
        extends the walk `extra` more hops — both rings from ONE BFS.

        A vectorized BFS over the always-current edge-slot mirror (no
        per-update CSR sort), falling back to a sorted-src host CSR cached
        per epoch for graphs without a mirror. This is the locality
        primitive behind selective cache invalidation.
        """
        rg = self.get(name)
        n = rg.n
        mask = np.zeros(n, bool)
        v = np.asarray(vertices, np.int64)
        total_hops = max(radius, 0) + max(extra, 0)
        if v.size:
            mask[v] = True
        # inner ring snapshot (taken mid-walk; pre-seeded when radius <= 0)
        inner = mask.copy() if extra > 0 and radius <= 0 else None

        def walk_slots():
            nonlocal mask
            src, dst, live = rg.slots.src, rg.slots.dst, rg.slots.live
            for _ in range(total_hops):
                hit = mask[src] & live
                grew = np.zeros(n, bool)
                grew[dst[hit]] = True
                grew &= ~mask
                if not grew.any():
                    return
                mask |= grew
                yield

        def walk_csr():
            if rg._csr_cache is None:
                g = rg.host
                order = np.argsort(g.src, kind="stable")
                counts = np.bincount(g.src, minlength=n).astype(np.int64)
                row_start = np.concatenate([np.zeros(1, np.int64),
                                            np.cumsum(counts)[:-1]])
                rg._csr_cache = (row_start, counts, g.dst[order])
            row_start, counts, dst_sorted = rg._csr_cache
            frontier = v
            for _ in range(total_hops):
                cnt = counts[frontier]
                total = int(cnt.sum())
                if total == 0:
                    return
                # flat gather of every frontier vertex's CSR range
                starts = np.repeat(row_start[frontier], cnt)
                offs = np.arange(total) - np.repeat(
                    np.cumsum(cnt) - cnt, cnt)
                nbrs = dst_sorted[starts + offs]
                new = np.unique(nbrs[~mask[nbrs]])
                if new.size == 0:
                    return
                mask[new] = True
                frontier = new
                yield

        hops_done = 0
        if v.size and total_hops:
            for _ in (walk_slots() if rg.slots is not None else walk_csr()):
                hops_done += 1
                if extra > 0 and hops_done == radius and inner is None:
                    inner = mask.copy()
        if extra <= 0:
            return mask
        return (mask if inner is None else inner), mask

    # ---- schedules --------------------------------------------------------
    def schedule(self, c: float, tol: float
                 ) -> tuple[ChebSchedule, torch.Tensor]:
        """Precomputed (ChebSchedule, device coefficient vector) for
        (c, tol)."""
        key = (float(c), float(tol))
        if key not in self._schedules:
            sched = make_schedule(c, tol)
            self._schedules[key] = (
                sched, torch.as_tensor(sched.coeffs, dtype=self.dtype)
                .to(self.device))
        return self._schedules[key]

    def adaptive_schedule(self, c: float, tol: float,
                          chunk: int | None = None) -> AdaptiveSchedule:
        """Adaptive-mode schedule for (c, tol): the a-priori round count as
        the hard cap plus the residual-check chunk (default sized by
        `default_chunk`)."""
        key = (float(c), float(tol), chunk)
        if key not in self._adaptive:
            sched, _ = self.schedule(c, tol)
            self._adaptive[key] = AdaptiveSchedule(
                c=float(c), tol=float(tol), max_rounds=sched.rounds,
                chunk=default_chunk(float(c), float(tol)) if chunk is None
                else int(chunk))
        return self._adaptive[key]
