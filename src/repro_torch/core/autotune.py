"""Measured engine selection: workload-bucketed autotuner + tuning store
(port of `repro.core.autotune`).

`select_engine(mode="auto")` picks a format from hand-set bars (the hub/tail
size and skew bars, the fill-rate bar) that were set on other hardware.
This module replaces the guess with a measurement, in three pieces:

  * `WorkloadKey` — the bucketing scheme tuning results are keyed by:
    log2 buckets of n and m, a degree-skew band from the same
    `_hub_edge_fraction` probe the heuristic uses, the power-of-two batch
    bucket, and the (backend, device_count) pair. The backend is the
    port's own tag ("torch-cuda" / "torch-cpu"), so a key can never match
    one the JAX package wrote; the device count is the process group's
    world size (1 without a group).
  * `Autotuner` — on a store miss, short-lists the feasible candidates
    (int32 range, a memory census from the tile-fill probe for block-ELL),
    builds each with the caller's exact build knobs, and times warm rounds
    (SpMM + `cheb_round`, the solve hot path): one warm-up round first
    (the first call on the card may build the kernels with nvcc), then
    each rep between two CUDA events on the current stream (the host clock
    after the round on the CPU), min over reps. The winner is picked by
    `pick_winner`, whose deterministic tie-break prefers the heuristic's
    choice whenever it measures within `jitter_tol` of the best. No cost
    analysis is recorded: torch has no counterpart of XLA's, and the
    reference records none where its backend exposes none.
  * `TuningStore` — the versioned on-disk JSON the measurements persist in
    (atomic tmp-file + os.replace writes, `$REPRO_TORCH_TUNE_CACHE`
    override, the port's own default path). A corrupt, truncated or
    version-mismatched file is treated as empty and the tuner falls back
    to measuring (or, with `require_cached=True`, to the heuristic) —
    never to half-read state. Entries record the backend, device count,
    torch version and card name they were measured under. The store also
    caches the `block_fill_rate` probe per (graph fingerprint, block) so
    auto mode stops re-running the host BFS + tile census for graphs it
    has already probed.

Deliberate divergence from the reference: the reference catches every
exception of a measurement pass (a candidate is "disqualified", a failed
pass falls back to the heuristic). On the card that would turn a failed
nvcc build or kernel launch into a quiet "COO wins". The port catches only
infeasibility — `torch.cuda.OutOfMemoryError`, and its own feasibility
checks (the census, and `CapacityError`, the ValueError of the int32-range
check) — and lets a kernel build or launch error propagate.

Every decision is counted (`autotune_decisions_total`, by source) so a
warm-store service start can be ASSERTED to perform zero tuning solves.

At world size >= 2 (one process per rank, SPMD) the sharded engines join
the shortlist, and the decision is rank 0's: rank 0 reads the store,
decides each skip, and its timings pick the winner; each of those is
broadcast, so every rank builds and times the same candidates in the same
order (a sharded candidate's timing rounds are collectives) and ends on
the same engine. A per-rank decision could pick different engines and
hang the next collective. Only rank 0 writes the store file.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.distributed import all_true, broadcast_object, \
    rank, world_size
from repro_torch.core.engine import (ENGINE_MODES, HUB_MIN_DEG,
                                     _hub_edge_fraction, heuristic_mode,
                                     select_engine)
from repro_torch.device import resolve_device
from repro_torch.graph.ops import CapacityError, as_torch_dtype, \
    check_int32_range
from repro_torch.graph.structure import Graph, block_fill_rate
from repro_torch.obs.metrics import NULL_REGISTRY, MetricsRegistry

__all__ = [
    "TUNE_FORMAT_VERSION",
    "WorkloadKey",
    "TuneDecision",
    "TuningStore",
    "FillProbeCache",
    "Autotuner",
    "backend_tag",
    "default_tune_path",
    "default_tuner",
    "graph_fingerprint",
    "log2_bucket",
    "max_tile_bytes",
    "pick_winner",
    "process_probe_cache",
]

# Bump to orphan every stored measurement AND fill probe: the loader treats
# any other version as a miss and the next save rewrites the whole file.
TUNE_FORMAT_VERSION = 1

# Degree-skew bands for the workload key, over the fraction of directed
# edges whose destination is a hub (deg >= HUB_MIN_DEG): meshes/grids score
# ~0.0 (band 0), the chung-lu scale-free operating point ~0.65 (band 2),
# extreme hub graphs band 3. The 0.4 edge coincides with
# HUB_TAIL_MIN_EDGE_FRAC so the heuristic's own decision boundary never
# cuts through the middle of a bucket.
SKEW_BANDS = (0.1, 0.4, 0.7)

# Candidate measurement order AFTER the heuristic's pick (the reference's).
CANDIDATE_ORDER = ("coo", "hub_tail", "fused", "sharded_1d", "sharded_2d")

# The block-ELL values-tensor cap of the census on the host, as in the
# reference (1 GiB). On cuda the cap comes from the card (`max_tile_bytes`).
HOST_MAX_TILE_BYTES = 1 << 30


def log2_bucket(x: int) -> int:
    """The log2 size bucket of a count: bit_length, so [2^k, 2^(k+1)) share
    a bucket. Used for both workload keys and the registry's re-tune check
    (an edge-update stream re-tunes only when m crosses a bucket edge)."""
    return int(x).bit_length()


def backend_tag(device=None) -> str:
    """The port's backend tag for `device` (None = cuda): "torch-cuda" or
    "torch-cpu". Never equal to a `jax.default_backend()` name."""
    return f"torch-{torch.device('cuda' if device is None else device).type}"


def max_tile_bytes(device=None) -> int:
    """The census cap on the block-ELL values tensor for `device`.

    On cuda a quarter of the card's memory: the tuned build holds the
    candidate's tiles beside the registry's padded COO graph and a timing
    round's [n, B] operands, and an update re-tiles while the old tiles
    are still alive (about twice the tiles at peak). The reference's 1 GiB
    (set for a host) would rule
    out fused at the paper's NACA0015 size (4.26 GB), which the card holds.
    On the CPU the reference's 1 GiB, so shortlists match it.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        return torch.cuda.get_device_properties(dev).total_memory // 4
    return HOST_MAX_TILE_BYTES


def default_tune_path() -> Path:
    """$REPRO_TORCH_TUNE_CACHE, or ~/.cache/repro_torch/tuning.json: the
    port's own store, apart from the reference's, so a winner measured
    under JAX is never served to the port. A value without a .json suffix
    is treated as a directory holding tuning.json."""
    env = os.environ.get("REPRO_TORCH_TUNE_CACHE")
    base = Path(env) if env else \
        Path.home() / ".cache" / "repro_torch" / "tuning.json"
    if base.suffix != ".json":
        base = base / "tuning.json"
    return base


def graph_fingerprint(g: Graph, max_edges: int = 1 << 16) -> str:
    """Content hash of a graph for the fill-probe cache: (n, m) exactly,
    plus the edge arrays (strided down to <= max_edges samples above that —
    a collision then needs identical n, m AND identical sampled edges, and
    the consequence of one is only a suboptimal format pick, never a wrong
    result). Equal to the reference's for the same graph."""
    h = hashlib.sha1()
    h.update(np.asarray([g.n, g.m], np.int64).tobytes())
    stride = max(1, int(g.m) // max_edges)
    h.update(np.ascontiguousarray(g.src[::stride]).tobytes())
    h.update(np.ascontiguousarray(g.dst[::stride]).tobytes())
    return h.hexdigest()[:16]


class FillProbeCache:
    """In-process cache of `block_fill_rate` results keyed by
    (graph fingerprint, block) — the no-disk probe cache auto mode uses so
    serving epoch bumps stop re-running the host BFS + tile census for
    shapes already probed. `TuningStore` implements the same two-method
    interface backed by its JSON file."""

    def __init__(self):
        self._fills: dict[str, float] = {}

    @staticmethod
    def _key(g: Graph, block: int) -> str:
        return f"{graph_fingerprint(g)}/b{int(block)}"

    def get_fill(self, g: Graph, block: int) -> float | None:
        return self._fills.get(self._key(g, block))

    def put_fill(self, g: Graph, block: int, fill: float) -> None:
        self._fills[self._key(g, block)] = float(fill)


_PROCESS_PROBE_CACHE = FillProbeCache()


def process_probe_cache() -> FillProbeCache:
    """The process-wide in-memory fill-probe cache (auto-mode default)."""
    return _PROCESS_PROBE_CACHE


class TuningStore:
    """Versioned on-disk JSON holding tuning entries + fill probes.

    Load is lazy and non-throwing: a missing file is an empty store, and a
    corrupt/truncated/version-mismatched file is ALSO an empty store with
    `load_error` set — the tuner then measures afresh (or falls back to the
    heuristic under `require_cached`), and the next `put` atomically
    rewrites the whole file at the current version. Writes go through a
    same-directory tmp file + os.replace, so a crash mid-write leaves
    either the old file or the new one, never a half-written store. The
    file layout is the reference's.
    """

    def __init__(self, path: str | os.PathLike | None = None):
        p = default_tune_path() if path is None else Path(path)
        if p.suffix != ".json":
            p = p / "tuning.json"
        self.path = p
        self._data: dict | None = None
        self.load_error: str | None = None

    def _empty(self) -> dict:
        return {"version": TUNE_FORMAT_VERSION, "entries": {},
                "fill_probes": {}}

    def _load(self) -> dict:
        if self._data is not None:
            return self._data
        self.load_error = None
        try:
            with open(self.path) as f:
                data = json.load(f)
            if not isinstance(data, dict) or \
                    data.get("version") != TUNE_FORMAT_VERSION:
                self.load_error = "version"
                data = self._empty()
            else:
                data.setdefault("entries", {})
                data.setdefault("fill_probes", {})
        except FileNotFoundError:
            data = self._empty()
        except (OSError, json.JSONDecodeError, UnicodeDecodeError,
                ValueError):
            self.load_error = "corrupt"
            data = self._empty()
        self._data = data
        return data

    def _save(self) -> None:
        if rank() != 0:
            # the ranks of a group share the file path: a stale copy saved
            # by another rank would drop rank 0's entries
            return
        data = self._load()
        self.path.parent.mkdir(parents=True, exist_ok=True)
        tmp = self.path.with_name(self.path.name + ".tmp")
        with open(tmp, "w") as f:
            json.dump(data, f, indent=1, sort_keys=True)
        os.replace(tmp, self.path)

    # ---- tuning entries ---------------------------------------------------
    def get(self, key: str) -> dict | None:
        entry = self._load()["entries"].get(key)
        return entry if isinstance(entry, dict) else None

    def put(self, key: str, entry: dict) -> None:
        self._load()["entries"][key] = entry
        self._save()

    def entries(self) -> dict[str, dict]:
        return dict(self._load()["entries"])

    # ---- fill probes (same interface as FillProbeCache) -------------------
    def get_fill(self, g: Graph, block: int) -> float | None:
        v = self._load()["fill_probes"].get(FillProbeCache._key(g, block))
        return float(v) if isinstance(v, (int, float)) else None

    def put_fill(self, g: Graph, block: int, fill: float) -> None:
        self._load()["fill_probes"][FillProbeCache._key(g, block)] = \
            float(fill)
        self._save()


@dataclasses.dataclass(frozen=True)
class WorkloadKey:
    """The shape class a tuning measurement generalizes over (see module
    docstring). `as_str` is the store key; it embeds the format version so
    a semantic change to the bucketing orphans old entries by key."""

    n_bucket: int
    m_bucket: int
    skew_bucket: int
    batch_bucket: int
    backend: str
    device_count: int

    @classmethod
    def from_graph(cls, g: Graph, batch: int | None = None, *,
                   backend: str | None = None,
                   device_count: int | None = None,
                   device=None) -> "WorkloadKey":
        """Key of (g, batch). `backend` None = `backend_tag(device)`;
        `device_count` None = the process group's world size (1 without
        a group)."""
        frac = _hub_edge_fraction(g, HUB_MIN_DEG)
        b = 1
        target = 1 if batch is None else max(1, int(batch))
        while b < target:
            b *= 2
        return cls(
            n_bucket=log2_bucket(g.n),
            m_bucket=log2_bucket(g.m),
            skew_bucket=sum(frac >= edge for edge in SKEW_BANDS),
            batch_bucket=b.bit_length() - 1,
            backend=backend_tag(device) if backend is None else backend,
            device_count=world_size() if device_count is None
            else int(device_count))

    @property
    def batch(self) -> int:
        """Representative batch width of the bucket (its upper edge)."""
        return 1 << self.batch_bucket

    def as_str(self) -> str:
        return (f"v{TUNE_FORMAT_VERSION}/{self.backend}"
                f"/d{self.device_count}/n{self.n_bucket}/m{self.m_bucket}"
                f"/s{self.skew_bucket}/b{self.batch_bucket}")


@dataclasses.dataclass
class TuneDecision:
    """What the tuner decided and why. `engine` is the already-built winner
    when the decision came from a fresh measurement (the caller reuses it
    instead of rebuilding); None on a store hit or heuristic fallback, in
    which case the caller builds `mode` itself. `us_per_iter` is the
    winner's measured per-round time (None when nothing was measured) —
    the serving layer seeds its solve-time estimator from it."""

    mode: str
    source: str            # store_hit | measured | fallback_heuristic
    key: str
    engine: object | None = None
    us_per_iter: float | None = None
    heuristic: str | None = None


def pick_winner(measured: dict[str, float], heuristic: str,
                jitter_tol: float = 0.10) -> str:
    """Deterministic winner over a {mode: seconds} measurement dict.

    The fastest mode wins, EXCEPT that the heuristic's pick is kept
    whenever it measured within `jitter_tol` of the best — so mode="tuned"
    matches mode="auto" up to measurement jitter by construction, and only
    deviates on a real, beyond-jitter win. Exact ties (and the argmin
    itself) break by CANDIDATE_ORDER position, never dict order.
    """
    if not measured:
        return heuristic
    order = {m: i for i, m in enumerate(CANDIDATE_ORDER)}
    best = min(measured, key=lambda m: (measured[m], order.get(m, len(order))))
    t_h = measured.get(heuristic)
    if t_h is not None and t_h <= measured[best] * (1.0 + jitter_tol):
        return heuristic
    return best


def _round_once(eng, x, t, acc, ck):
    # one solve-loop round: SpMM + Chebyshev recurrence/accumulation — the
    # exact per-iteration hot path, so fused engines show their cheb_step
    # win
    y = eng.apply(x)
    return eng.cheb_round(y, t, acc, ck)


def _time_round(eng, x, t, acc, reps: int) -> float:
    """Min-over-reps seconds of one warm round. On cuda each rep lies
    between two CUDA events on the current stream (read after the stop
    event's synchronize); on the CPU the host clock spans the round, whose
    ops return when done."""
    ck = torch.tensor(0.5, dtype=x.dtype, device=x.device)
    _round_once(eng, x, t, acc, ck)     # warm-up: may build the kernels
    cuda = x.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(x.device)
    best = math.inf
    for _ in range(max(1, int(reps))):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            _round_once(eng, x, t, acc, ck)
            stop.record()
            stop.synchronize()
            best = min(best, start.elapsed_time(stop) * 1e-3)
        else:
            t0 = time.perf_counter()
            _round_once(eng, x, t, acc, ck)
            best = min(best, time.perf_counter() - t0)
    return best


class _TunerObs:
    """Tuner instrument bundle: built against NULL_REGISTRY (no-ops) until
    a live metrics registry is bound — same pattern as _RegistryObs."""

    def __init__(self, reg: MetricsRegistry):
        self.decisions = reg.counter(
            "autotune_decisions_total",
            "engine-selection decisions by source (store_hit | measured | "
            "fallback_heuristic | sticky)", ("graph", "source"))
        self.us_per_iter = reg.gauge(
            "autotune_us_per_iter",
            "measured per-round time of the engine the tuner selected",
            ("graph", "engine"))
        self.measure_seconds = reg.histogram(
            "autotune_measure_seconds",
            "wall time of one full candidate measurement pass", ("graph",))


class Autotuner:
    """Measure-or-remember engine selection (see module docstring).

    Args:
        store: the `TuningStore` to consult/persist (None = the default
            `$REPRO_TORCH_TUNE_CACHE` path).
        reps: warm timed rounds per candidate (min is taken).
        budget_s: wall-clock cap on one measurement pass — the heuristic's
            pick is always measured first, so exhausting the budget leaves
            a valid (possibly heuristic) winner and records which
            candidates were skipped.
        jitter_tol: tie-break width of `pick_winner`.
        require_cached: never measure — a store miss (including a corrupt
            or missing store file) falls back to the heuristic.
    """

    # engines whose build cost can't pay off on tiny graphs aren't worth
    # timing at all (the reference's bar)
    MIN_CANDIDATE_N = 1 << 10

    def __init__(self, store: TuningStore | None = None, *, reps: int = 3,
                 budget_s: float = 5.0, jitter_tol: float = 0.10,
                 require_cached: bool = False):
        self.store = TuningStore() if store is None else store
        self.reps = int(reps)
        self.budget_s = float(budget_s)
        self.jitter_tol = float(jitter_tol)
        self.require_cached = bool(require_cached)
        # plain counts mirror of the decision counter metric, for callers
        # (and tests) without a bound metrics registry
        self.decision_counts: dict[str, int] = {}
        self._obs = _TunerObs(NULL_REGISTRY)

    def bind_metrics(self, registry: MetricsRegistry) -> None:
        """Point the tuner's instrumentation at a live MetricsRegistry
        (idempotent; the serving registry forwards its own)."""
        self._obs = _TunerObs(registry)

    def record(self, source: str, graph: str, mode: str,
               us_per_iter: float | None = None) -> None:
        """Count one selection decision (also called by the serving
        registry for its sticky per-epoch reuse of a tuned winner)."""
        self.decision_counts[source] = \
            self.decision_counts.get(source, 0) + 1
        self._obs.decisions.labels(graph=graph, source=source).inc()
        if us_per_iter is not None:
            self._obs.us_per_iter.labels(graph=graph, engine=mode).set(
                us_per_iter)

    def measured_count(self) -> int:
        """Decisions that ran a measurement pass — zero on a warm store."""
        return self.decision_counts.get("measured", 0)

    # ---- the decision -----------------------------------------------------
    def tune(self, g: Graph, batch: int | None = None, *,
             graph_name: str = "graph", dg=None, dtype=torch.float32,
             block: int = 128, min_fill: float | None = None,
             stable_shapes: bool = False, weight_dtype=None,
             device=None, mesh=None, grid: tuple[int, int] | None = None,
             lane: int = 128, comm_dtype=None,
             sharded_min_n: int | None = None) -> TuneDecision:
        """Select the engine mode for (g, batch) on `device` (None = cuda) —
        store hit, measurement, or heuristic fallback. Build knobs mirror
        `select_engine` and are used verbatim for candidate builds, so a
        freshly measured winner (`TuneDecision.engine`) is directly usable
        by the caller. The heuristic is the one for `device` (the cuda
        fill bar on the card). At world size >= 2 every rank calls it with
        the same arguments and gets rank 0's decision (module docstring).
        """
        dev = resolve_device(device)
        n_dev = mesh.size() if mesh is not None else world_size()
        key = WorkloadKey.from_graph(g, batch=batch, device=dev,
                                     device_count=n_dev)
        ks = key.as_str()
        build_kw = dict(dg=dg, dtype=dtype, block=block, min_fill=min_fill,
                        stable_shapes=stable_shapes,
                        weight_dtype=weight_dtype, device=dev, mesh=mesh,
                        grid=grid, lane=lane, comm_dtype=comm_dtype,
                        sharded_min_n=sharded_min_n)
        heuristic = heuristic_mode(g, batch, block=block, min_fill=min_fill,
                                   device=dev, mesh=mesh,
                                   sharded_min_n=sharded_min_n,
                                   probe_cache=self.store)

        hit = us = None
        if rank() == 0:
            entry = self.store.get(ks)
            if entry is not None and entry.get("engine") in ENGINE_MODES:
                hit, us = entry["engine"], entry.get("us_per_iter")
        hit, us = broadcast_object((hit, us))
        if hit is not None:
            self.record("store_hit", graph_name, hit, us)
            return TuneDecision(mode=hit, source="store_hit", key=ks,
                                us_per_iter=us, heuristic=heuristic)

        if self.require_cached:
            self.record("fallback_heuristic", graph_name, heuristic)
            return TuneDecision(mode=heuristic, source="fallback_heuristic",
                                key=ks, heuristic=heuristic)

        t0 = time.perf_counter()
        measured, engines, skipped = self._measure_candidates(
            g, key, heuristic, n_dev, build_kw)
        self._obs.measure_seconds.labels(graph=graph_name).observe(
            time.perf_counter() - t0)
        if not measured:
            # every candidate was infeasible: the zero-cost tier remains
            self.record("fallback_heuristic", graph_name, heuristic)
            return TuneDecision(mode=heuristic, source="fallback_heuristic",
                                key=ks, heuristic=heuristic)

        winner = pick_winner(measured, heuristic, self.jitter_tol)
        us = measured[winner] * 1e6
        self.store.put(ks, {
            "engine": winner,
            "us_per_iter": round(us, 2),
            "candidates": {m: round(s * 1e6, 2)
                           for m, s in sorted(measured.items())},
            "heuristic": heuristic,
            "skipped": skipped,
            "reps": self.reps,
            # environment stamp: keyed by (backend, device_count) already,
            # recorded redundantly so a store file is self-describing
            "backend": key.backend,
            "device_count": key.device_count,
            "torch": torch.__version__,
            "device_name": torch.cuda.get_device_name(dev)
            if dev.type == "cuda" else "cpu",
        })
        self.record("measured", graph_name, winner, us)
        return TuneDecision(mode=winner, source="measured", key=ks,
                            engine=engines.get(winner), us_per_iter=us,
                            heuristic=heuristic)

    # ---- candidates -------------------------------------------------------
    def _shortlist(self, g: Graph, heuristic: str, block: int,
                   device=None, n_dev: int = 1) -> list[str]:
        """Feasible candidate modes, heuristic's pick first (the
        reference's shortlist: the sharded modes join at >= 2 ranks)."""
        cands = ["coo"]
        try:
            check_int32_range(g.n, g.m, what="autotune candidates")
        except CapacityError:
            return cands
        big_enough = g.n >= self.MIN_CANDIDATE_N
        if big_enough and _hub_edge_fraction(g, HUB_MIN_DEG) > 0.0:
            cands.append("hub_tail")
        if g.n >= 2 * block:
            fill = self.store.get_fill(g, block)
            if fill is None:
                fill, _ = block_fill_rate(g, block=block)
                self.store.put_fill(g, block, fill)
            # memory census from the tile probe: the [n_rb, S, B, B] values
            # tensor is ~ m * 4 bytes / fill — refuse to even build it when
            # the estimate blows the cap (scattered graphs at scale)
            if fill > 0.0 and 4.0 * g.m / fill <= max_tile_bytes(device):
                cands.append("fused")
        if n_dev >= 2 and big_enough:
            cands.append("sharded_1d")
            if n_dev >= 4:
                cands.append("sharded_2d")
        ordered = [m for m in CANDIDATE_ORDER
                   if m in cands and m != heuristic]
        return ([heuristic] if heuristic in cands else []) + ordered

    def _measure_candidates(self, g: Graph, key: WorkloadKey, heuristic: str,
                            n_dev: int, build_kw: dict):
        """Build + time each shortlisted candidate within the budget.
        Returns ({mode: seconds}, {mode: engine}, [skipped modes]).

        Only infeasibility disqualifies a candidate: running out of device
        memory, or the port's own capacity check (`CapacityError`: an index
        past int32). Anything else — a failed kernel build or launch —
        propagates.

        At world size >= 2 the shortlist, each budget skip and the returned
        timings are rank 0's, and a candidate infeasible on any rank is
        skipped on all (an OOM inside a sharded candidate's timed round,
        after its first collective, is not caught that way)."""
        block = build_kw.get("block", 128)
        dev = build_kw["device"]
        cands = broadcast_object(
            self._shortlist(g, heuristic, block, device=dev, n_dev=n_dev)
            if rank() == 0 else None)
        B = min(key.batch, 128)   # bounded sample: bucket width, capped
        dtype = as_torch_dtype(build_kw.get("dtype", torch.float32))
        p = torch.full((g.n, B), 1.0 / max(g.n, 1), dtype=dtype, device=dev)
        measured: dict[str, float] = {}
        engines: dict[str, object] = {}
        skipped: list[str] = []
        t0 = time.perf_counter()
        for mode in cands:
            over = bool(measured) and \
                time.perf_counter() - t0 > self.budget_s
            if broadcast_object(over):
                skipped.append(mode)
                continue
            try:
                eng = select_engine(g, batch=key.batch, mode=mode,
                                    **build_kw)
                x = eng.to_internal(p.to(eng.dtype))
            except (torch.cuda.OutOfMemoryError, CapacityError):
                eng = None
            # a candidate infeasible on any rank is skipped on every rank
            if all_true(eng is not None):
                try:
                    measured[mode] = _time_round(eng, x, x, 0.5 * x,
                                                 self.reps)
                    engines[mode] = eng
                    continue
                except (torch.cuda.OutOfMemoryError, CapacityError):
                    pass
            skipped.append(mode)   # infeasible in practice: disqualify
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        measured, skipped = broadcast_object((measured, skipped))
        return measured, engines, skipped


_DEFAULT_TUNER: Autotuner | None = None


def default_tuner() -> Autotuner:
    """Process-wide tuner over the default store path — what
    `select_engine(mode="tuned")` uses when no tuner is threaded in."""
    global _DEFAULT_TUNER
    if _DEFAULT_TUNER is None:
        _DEFAULT_TUNER = Autotuner()
    return _DEFAULT_TUNER
