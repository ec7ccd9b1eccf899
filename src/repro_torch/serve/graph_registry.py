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

Edge updates (`apply_updates`, `hop_neighborhood`, the canonical key
set), chunked ingestion, the autotuner and the metrics binding come with
later slices.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.chebyshev import ChebSchedule, default_chunk, \
    make_schedule
from repro_torch.core.engine import select_engine
from repro_torch.device import resolve_device
from repro_torch.graph.ops import DeviceGraph, as_torch_dtype, device_graph
from repro_torch.graph.structure import Graph

__all__ = ["AdaptiveSchedule", "RegisteredGraph", "GraphRegistry"]


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
    for it, and the epoch stamped into every cache key."""

    def __init__(self, name: str, host: Graph, dg: DeviceGraph,
                 engine=None, epoch: int = 0):
        self.name = name
        self.host = host
        self.dg = dg
        self.engine = engine
        self.epoch = epoch

    @property
    def n(self) -> int:
        return self.host.n


def _edge_bucket(m: int, minimum: int = 1024) -> int:
    """Smallest power of two >= m (at least `minimum`): the padded device
    edge-array length."""
    b = minimum
    while b < m:
        b *= 2
    return b


class GraphRegistry:
    """Name -> RegisteredGraph, plus the shared (c, tol) schedule cache.

    Args:
        device: where graphs, engines and solves live (None = cuda; raises
            without a GPU).
        dtype: accumulation dtype of device graphs and solves.
        engine: engine mode for `select_engine` ("auto", "coo",
            "block_ell", "fused"; the unported modes raise).
        batch_hint: expected micro-batch width, steering auto selection.
        weight_dtype: packed storage dtype for COO edge weights (None =
            `dtype`); accumulation stays in `dtype`.
    """

    def __init__(self, device=None, dtype=torch.float32,
                 engine: str = "auto", batch_hint: int | None = None,
                 weight_dtype=None):
        self.device = resolve_device(device)
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
        """(DeviceGraph, engine) for one epoch of a graph. The COO engine
        reuses the padded device graph; block-ELL engines pad their slot
        count to a power of two."""
        dg = device_graph(g, self.dtype, pad_edges_to=_edge_bucket(g.m),
                          weight_dtype=self.weight_dtype, device=self.device)
        eng = select_engine(g, batch=self.batch_hint, mode=self.engine_mode,
                            dg=dg, dtype=self.dtype, stable_shapes=True,
                            weight_dtype=self.weight_dtype,
                            device=self.device)
        return dg, eng

    # ---- graphs -----------------------------------------------------------
    def register(self, name: str, g: Graph) -> RegisteredGraph:
        """Register `g` under `name`: build its device graph + engine once
        and keep them warm (epoch 0).

        Raises:
            ValueError: the name is already registered.
        """
        if name in self._graphs:
            raise ValueError(f"graph {name!r} already registered")
        dg, eng = self._build(g)
        rg = RegisteredGraph(name=name, host=g, dg=dg, engine=eng)
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
