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
    hub/tail, a re-tile reusing the BFS perm for block-ELL, a
    repartition on the same mesh for the sharded engines);
  * **rebuild** — every batch takes the full path: the sorted key set is
    merged, `from_undirected_edges` rebuilds the host graph, and a fresh
    DeviceGraph + `select_engine` follow. The incremental mode falls back
    to exactly this when a batch overflows the bucket (which then grows).

A batch whose effective delta is EMPTY (duplicate inserts, deletes of
absent edges) changes nothing: no rebuild, no epoch bump.

With `engine="tuned"` the registry owns an `Autotuner` (core/autotune.py)
whose store doubles as the fill-probe cache: each graph's engine is
measured once per shape class, and a rebuild keeps the winner while the
edge count stays in its log2 bucket. Every other mode shares the process
probe cache. `bind_metrics` points the build/update/BFS timings and the
per-graph gauges at the service's metrics registry. A graph whose arrays
are read-only (a memory-mapped dataset cache) is copied at registration,
before anything mutates or uploads from it; `ingest_chunk_edges` bounds
the host memory of the upload.

With the sharded engines (`engine="sharded-1d" | "sharded-2d"`, or auto
at world size >= 2) every rank holds a registry with the same graphs and
applies the same update batches in the same order (the service's
lockstep does that), since building and refreshing those engines is SPMD.
Such a graph keeps no whole-graph DeviceGraph on any card (`rg.dg` is
None): each rank's card holds its shard alone, and an update patches only
the host mirror before the engine repartitions.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.autotune import (Autotuner, TuningStore, log2_bucket,
                                       process_probe_cache)
from repro_torch.core.chebyshev import ChebSchedule, default_chunk, \
    make_schedule
from repro_torch.core.engine import (SHARDED_MODES, CooEngine,
                                     ShardedEngine, auto_shard_mode,
                                     select_engine)
from repro_torch.device import resolve_device
from repro_torch.graph.ops import (DeviceGraph, EdgeSlots, as_torch_dtype,
                                   device_graph, patch_device_graph)
from repro_torch.graph.structure import EdgeDelta, Graph, edge_delta
from repro_torch.obs.metrics import NULL_REGISTRY, MetricsRegistry

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
    """One serving graph: host copy, device copy (None under a sharded
    engine, whose ranks hold only their shards), the solve engine picked
    for it, and the epoch stamped into every cache key. `keys` is the
    sorted canonical undirected key set and `slots` the host mirror of the
    padded device arrays (None when the graph broke the symmetrized-edge
    contract, which forces rebuilds); `last_delta` /
    `last_update_incremental` record what the latest update batch did.

    `host` is a LAZY view after an in-place update: the COO serving path
    never reads the host Graph per batch, so the incremental path marks it
    stale and the next reader (a re-tiling refresh, a test oracle, the CSR
    walk) materializes it from the slot mirror."""

    def __init__(self, name: str, host: Graph, dg: DeviceGraph | None,
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
        # tuned-mode state: the autotuner's winner for the current shape
        # class, its measured per-round time (the service seeds its
        # solve-time estimator from it), and the log2 edge bucket the winner
        # was tuned at — a rebuild re-tunes only when m leaves the bucket.
        # None outside engine="tuned".
        self.tuned_mode: str | None = None
        self.tune_us_per_iter: float | None = None
        self.m_bucket = log2_bucket(host.m)

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


class _RegistryObs:
    """The registry's instrument bundle. Built against NULL_REGISTRY by
    default (every call a no-op), swapped for live families when a metrics
    registry is bound — the service binds its own at construction so
    build/update/BFS timings land next to the serve metrics."""

    def __init__(self, reg: MetricsRegistry):
        self.build_seconds = reg.histogram(
            "registry_build_seconds",
            "DeviceGraph + engine (re)build duration per (graph, epoch)",
            ("graph",))
        self.update_seconds = reg.histogram(
            "registry_update_seconds",
            "apply_updates duration by effective path", ("graph", "path"))
        self.hop_seconds = reg.histogram(
            "registry_hop_bfs_seconds",
            "hop_neighborhood BFS duration", ("graph",))
        self.epoch = reg.gauge(
            "graph_epoch", "current epoch per registered graph", ("graph",))
        self.edges = reg.gauge(
            "graph_edges", "undirected edge count per registered graph",
            ("graph",))
        self.engine_info = reg.gauge(
            "graph_engine_info",
            "1 for the engine class currently serving the graph",
            ("graph", "engine"))

    def set_graph_gauges(self, rg: "RegisteredGraph") -> None:
        self.epoch.labels(graph=rg.name).set(rg.epoch)
        self.edges.labels(graph=rg.name).set(
            len(rg.keys) if rg.keys is not None else rg.host.m)
        current = type(rg.engine).__name__
        for values, inst in self.engine_info.children():
            if values[0] == rg.name:    # a rebuild may have switched class
                inst.set(0.0)
        self.engine_info.labels(graph=rg.name, engine=current).set(1.0)


def _writable(g: Graph) -> Graph:
    """`g` itself, or a private copy when its arrays are read-only (the
    memory-mapped dataset cache): torch would alias the file on upload,
    and nothing may mutate it."""
    if g.src.flags.writeable and g.dst.flags.writeable:
        return g
    return Graph(n=g.n, src=np.array(g.src), dst=np.array(g.dst))


class GraphRegistry:
    """Name -> RegisteredGraph, plus the shared (c, tol) schedule cache.

    Args:
        device: where graphs, engines and solves live (None = cuda; raises
            without a GPU).
        dtype: accumulation dtype of device graphs and solves.
        engine: engine mode for `select_engine` ("auto", "tuned", "coo",
            "hub_tail", "block_ell", "fused", "sharded_1d", "sharded_2d";
            dashes accepted).
            "tuned" measures the engine once per (graph, shape class) on
            this registry's device and persists it in the tuning store.
        batch_hint: expected micro-batch width, steering auto selection.
        update_mode: "incremental" (in-place device patch when the batch
            fits the edge bucket) or "rebuild" (always the full path).
        weight_dtype: packed storage dtype for COO edge weights and
            hub/tail's inv_deg (None = `dtype`); accumulation stays in
            `dtype`.
        ingest_chunk_edges: host->device transfer chunk at registration
            (None = one shot).
        tune_cache: tuning-store path for engine="tuned" (None =
            `$REPRO_TORCH_TUNE_CACHE` / the user-cache default).
        tune_budget_s: wall-clock cap per measurement pass.
        tune_require_cached: never measure — a store miss falls back to
            the heuristic.
        mesh: the `DeviceMesh` the sharded engines run on (None = a mesh
            over the whole world from `init_mesh`).
        grid: the (R, C) grid of sharded-2d (None = the mesh's, or the
            most-square factorization of the world size).
        partition_lane: the sharded partitions' padding lane.

    Invariant: `rg.engine` is always current for (graph, epoch) — every
    effective update refreshes or rebuilds it before the epoch bumps.
    """

    def __init__(self, device=None, dtype=torch.float32,
                 engine: str = "auto", batch_hint: int | None = None,
                 update_mode: str = "incremental", weight_dtype=None,
                 ingest_chunk_edges: int | None = None,
                 tune_cache=None, tune_budget_s: float = 2.0,
                 tune_require_cached: bool = False, mesh=None,
                 grid: tuple[int, int] | None = None,
                 partition_lane: int = 128):
        if update_mode not in UPDATE_MODES:
            raise ValueError(f"update_mode {update_mode!r} not in "
                             f"{UPDATE_MODES}")
        self.device = resolve_device(device)
        # sharded-engine knobs: the mesh the solves run on, the (R, C) grid
        # of sharded-2d and the partition lane
        self.mesh = mesh
        self.grid = grid
        self.partition_lane = partition_lane
        self.update_mode = update_mode
        self.dtype = as_torch_dtype(dtype)
        self.engine_mode = engine
        self.batch_hint = batch_hint
        self.weight_dtype = None if weight_dtype is None \
            else as_torch_dtype(weight_dtype)
        self.ingest_chunk_edges = ingest_chunk_edges
        # engine="tuned" owns an Autotuner whose store doubles as the
        # fill-probe cache; every other mode shares the process-wide
        # in-memory probe cache so epoch bumps on unchanged shapes skip the
        # host BFS + tile census
        self.tuner: Autotuner | None = None
        if engine == "tuned":
            self.tuner = Autotuner(TuningStore(tune_cache),
                                   budget_s=tune_budget_s,
                                   require_cached=tune_require_cached)
            self._probe_cache = self.tuner.store
        else:
            self._probe_cache = process_probe_cache()
        self._graphs: dict[str, RegisteredGraph] = {}
        self._schedules: dict[tuple[float, float],
                              tuple[ChebSchedule, torch.Tensor]] = {}
        self._adaptive: dict[tuple[float, float, int | None],
                             AdaptiveSchedule] = {}
        self._obs = _RegistryObs(NULL_REGISTRY)

    def bind_metrics(self, registry: MetricsRegistry) -> None:
        """Point the registry's instrumentation at a live MetricsRegistry
        (idempotent; called by PageRankService with its own). Gauges for
        already-registered graphs are published immediately."""
        self._obs = _RegistryObs(registry)
        if self.tuner is not None:
            self.tuner.bind_metrics(registry)
        for rg in self._graphs.values():
            self._obs.set_graph_gauges(rg)

    def _build(self, g: Graph, name: str = "graph", rg=None):
        """(DeviceGraph or None, engine, EdgeSlots, tuned_mode,
        tune_us_per_iter) for one epoch of a graph. The COO engine reuses
        the padded device graph; block-ELL engines pad their slot count to
        a power of two. The EdgeSlots mirror is what later updates patch
        through (None, and a plain `device_graph`, for a graph that breaks
        the symmetrized-edge contract: those always rebuild).

        A sharded engine reads no whole-graph DeviceGraph: each rank holds
        its own shard, so none is uploaded (dg is None) when the mode is
        known to shard beforehand, and a tuned measurement's is dropped
        when a sharded engine wins. Only the host mirror tracks updates.

        In tuned mode the selection is measured once per (graph, shape
        class): a rebuild whose edge count stays inside the previous log2
        bucket reuses the prior winner (counted as a "sticky" decision),
        anything else consults the tuner's store / measures afresh."""
        try:
            slots = EdgeSlots.from_graph(g, cap=_edge_bucket(g.m))
        except ValueError:
            slots = None
        sticky = self.tuner is not None and rg is not None and \
            rg.tuned_mode is not None and log2_bucket(g.m) == rg.m_bucket
        mode = rg.tuned_mode if sticky else self.engine_mode.replace("-", "_")
        if mode == "auto":
            mode = auto_shard_mode(g, mesh=self.mesh) or mode
        dg = None
        if mode not in SHARDED_MODES:
            dg = self._upload(g, slots)
        build_kw = dict(batch=self.batch_hint, dg=dg, dtype=self.dtype,
                        stable_shapes=True, weight_dtype=self.weight_dtype,
                        device=self.device, mesh=self.mesh, grid=self.grid,
                        lane=self.partition_lane)
        if self.tuner is None:
            eng = select_engine(g, mode=mode, probe_cache=self._probe_cache,
                                **build_kw)
            return dg, eng, slots, None, None
        if sticky:
            self.tuner.record("sticky", name, mode)
            eng = select_engine(g, mode=mode, **build_kw)
            return dg, eng, slots, mode, rg.tune_us_per_iter
        dec = self.tuner.tune(g, graph_name=name, **build_kw)
        eng = dec.engine if dec.engine is not None else \
            select_engine(g, mode=dec.mode, **build_kw)
        if isinstance(eng, ShardedEngine):
            dg = None
        return dg, eng, slots, dec.mode, dec.us_per_iter

    def _upload(self, g: Graph, slots: EdgeSlots | None) -> DeviceGraph:
        """The padded whole-graph DeviceGraph (from the slot mirror when
        there is one)."""
        if slots is not None:
            return slots.to_device(self.dtype, weight_dtype=self.weight_dtype,
                                   device=self.device,
                                   chunk_edges=self.ingest_chunk_edges)
        return device_graph(g, self.dtype, pad_edges_to=_edge_bucket(g.m),
                            weight_dtype=self.weight_dtype,
                            device=self.device,
                            chunk_edges=self.ingest_chunk_edges)

    # ---- graphs -----------------------------------------------------------
    def register(self, name: str, g: Graph) -> RegisteredGraph:
        """Register `g` under `name`: build its device graph + engine once
        and keep them warm (epoch 0). A graph with read-only arrays (a
        memory-mapped cache) is copied first; the file is never touched.

        Raises:
            ValueError: the name is already registered.
        """
        if name in self._graphs:
            raise ValueError(f"graph {name!r} already registered")
        g = _writable(g)
        t0 = time.perf_counter()
        dg, eng, slots, tuned_mode, tune_us = self._build(g, name)
        self._obs.build_seconds.labels(graph=name).observe(
            time.perf_counter() - t0)
        rg = RegisteredGraph(name=name, host=g, dg=dg, engine=eng,
                             keys=_undirected_keys(g), slots=slots)
        rg.tuned_mode, rg.tune_us_per_iter = tuned_mode, tune_us
        self._graphs[name] = rg
        self._obs.set_graph_gauges(rg)
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
        t0 = time.perf_counter()
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
            self._obs.update_seconds.labels(graph=name, path="noop").observe(
                time.perf_counter() - t0)
            return rg

        patch = None
        if self.update_mode == "incremental" and rg.slots is not None:
            patch = rg.slots.apply_delta(delta)
        if patch is not None:
            if rg.dg is not None:   # None under a sharded engine
                patch_device_graph(rg.dg, patch)
            rg._host_stale = True   # materialized on next read, not per batch
            if isinstance(rg.engine, CooEngine):
                # the COO engine shares rg.dg, already patched in place:
                # refresh without materializing the host Graph
                rg.engine = rg.engine.refresh(None, delta, dg=rg.dg)
            else:
                rg.engine = rg.engine.refresh(rg.host, delta, dg=rg.dg,
                                              stable_shapes=True,
                                              lane=self.partition_lane)
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
            t_build = time.perf_counter()
            dg, eng, slots, tuned_mode, tune_us = self._build(g_new, name,
                                                              rg=rg)
            rg.dg, rg.engine, rg.slots = dg, eng, slots
            rg.tuned_mode, rg.tune_us_per_iter = tuned_mode, tune_us
            rg.m_bucket = log2_bucket(g_new.m)
            self._obs.build_seconds.labels(graph=name).observe(
                time.perf_counter() - t_build)
            rg.keys = keys
        rg.epoch += 1
        rg._csr_cache = None
        path = "incremental" if rg.last_update_incremental else "rebuild"
        self._obs.update_seconds.labels(graph=name, path=path).observe(
            time.perf_counter() - t0)
        self._obs.set_graph_gauges(rg)
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
        t0 = time.perf_counter()
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
        self._obs.hop_seconds.labels(graph=name).observe(
            time.perf_counter() - t0)
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
