"""Typed metric primitives + registry (no dependencies beyond the stdlib;
a copy of `repro.obs.metrics`).

Three instrument kinds, Prometheus-shaped:

  * Counter   — monotone float; `inc(v)`.
  * Gauge     — settable float; `set(v)` / `inc(v)` / `dec(v)`.
  * Histogram — log-bucketed distribution over positive values; `observe(v)`.

Instruments are created through a `MetricsRegistry` as *families* carrying a
label schema, mirroring the Prometheus client model:

    reg = MetricsRegistry()
    hits = reg.counter("serve_cache_hits_total", "cache hits", ("graph",))
    hits.labels(graph="mesh").inc()
    lat = reg.histogram("serve_query_latency_seconds", "e2e latency",
                        ("graph", "served_from"))
    lat.labels(graph="mesh", served_from="solve").observe(0.0021)
    lat.labels(graph="mesh", served_from="solve").quantile(0.99)

A family with an empty label schema proxies the instrument API directly
(`hits.inc()`), so label-less metrics read naturally. Children are cached
per label-value tuple; `Family.total()` sums counters/gauges across
children, `Family.merged()` merges histogram children into one distribution
— the cross-label view the CLI summary uses.

## Histogram buckets and quantile exactness

Latency spans ~6 orders of magnitude (microsecond cache hits to multi-second
cold solves), so buckets are GEOMETRIC: value v > 0 lands in bucket
ceil(log(v) / log(gamma)), i.e. bucket i covers (gamma^(i-1), gamma^i].
With the default gamma = 1.02 any reported quantile is the true sample
quantile up to a 2% relative bucket width (the DDSketch guarantee) at ~1160
buckets per decade-range — and only OBSERVED buckets are stored (sparse
dict), so an idle family costs nothing. Exact `count`/`sum`/`min`/`max` are
tracked alongside, so means are exact and the reported p50/p99/p999 are
clamped into [min, max].

`MetricsRegistry(enabled=False)` (and the shared `NULL_REGISTRY`) hands out
no-op instruments so library code can instrument unconditionally — an
unbound caller pays one dict lookup and a no-op call, nothing else.
"""
from __future__ import annotations

import math
import threading

__all__ = ["Counter", "Gauge", "Histogram", "Family", "MetricsRegistry",
           "NULL_REGISTRY"]


class Counter:
    """Monotone counter. `inc` of a negative amount is a ValueError."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        self.value += amount

    def reset(self) -> None:
        self.value = 0.0


class Gauge:
    """Last-value instrument (queue depth, epoch, engine-info flags)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.value -= amount

    def reset(self) -> None:
        self.value = 0.0


class Histogram:
    """Sparse geometric-bucket histogram over positive values.

    Bucket i > 0 covers (gamma^(i-1), gamma^i]; values <= 0 land in the
    dedicated zero bucket (latencies can round to 0.0 at clock resolution).
    Quantiles interpolate nothing: the answer is the geometric midpoint of
    the bucket holding the target rank, which the gamma guarantee puts
    within a factor sqrt(gamma) of every sample in that bucket.
    """

    __slots__ = ("gamma", "_log_gamma", "_buckets", "_zero", "count", "sum",
                 "min", "max")

    def __init__(self, gamma: float = 1.02):
        if gamma <= 1.0:
            raise ValueError("gamma must be > 1")
        self.gamma = gamma
        self._log_gamma = math.log(gamma)
        self._buckets: dict[int, int] = {}
        self._zero = 0
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, value: float) -> None:
        self.count += 1
        self.sum += value
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value
        if value <= 0.0:
            self._zero += 1
            return
        idx = math.ceil(math.log(value) / self._log_gamma)
        self._buckets[idx] = self._buckets.get(idx, 0) + 1

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Value at quantile q in [0, 1] (0.5 = p50). 0.0 when empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        if self.count == 0:
            return 0.0
        rank = q * (self.count - 1) + 1        # 1-based target sample rank
        seen = self._zero
        if seen >= rank:
            return max(0.0, self.min)
        val = 0.0
        for idx in sorted(self._buckets):
            seen += self._buckets[idx]
            if seen >= rank:
                val = math.exp((idx - 0.5) * self._log_gamma)
                break
        # clamp into the exact observed range (min/max are tracked exactly)
        return min(max(val, self.min), self.max)

    def percentiles(self, ps=(50.0, 99.0, 99.9)) -> tuple[float, ...]:
        return tuple(self.quantile(p / 100.0) for p in ps)

    def merge(self, other: "Histogram") -> None:
        if abs(other.gamma - self.gamma) > 1e-12:
            raise ValueError("cannot merge histograms with different gamma")
        for idx, c in other._buckets.items():
            self._buckets[idx] = self._buckets.get(idx, 0) + c
        self._zero += other._zero
        self.count += other.count
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)

    def bucket_bounds(self):
        """Sorted (upper_bound, cumulative_count) pairs — the Prometheus
        `le` series (zero bucket folded into the smallest bound)."""
        out = []
        cum = self._zero
        if self._zero:
            out.append((0.0, cum))
        for idx in sorted(self._buckets):
            cum += self._buckets[idx]
            out.append((math.exp(idx * self._log_gamma), cum))
        return out

    def reset(self) -> None:
        self._buckets.clear()
        self._zero = 0
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf


class _NullInstrument:
    """Absorbs the full instrument + family surface as no-ops."""

    __slots__ = ()
    value = 0.0
    count = 0
    sum = 0.0
    mean = 0.0
    min = math.inf
    max = -math.inf

    def labels(self, *a, **kw):
        return self

    def inc(self, *a, **kw):
        pass

    dec = set = observe = inc

    def reset(self):
        pass

    def quantile(self, q):
        return 0.0

    def percentiles(self, ps=(50.0, 99.0, 99.9)):
        return tuple(0.0 for _ in ps)

    def total(self):
        return 0.0

    def merged(self):
        return Histogram()

    def children(self):
        return ()


_NULL_INSTRUMENT = _NullInstrument()

_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class Family:
    """One named metric + label schema; children cached per label values."""

    def __init__(self, name: str, kind: str, help: str = "",
                 labelnames: tuple[str, ...] = (), gamma: float = 1.02):
        self.name = name
        self.kind = kind
        self.help = help
        self.labelnames = tuple(labelnames)
        self._gamma = gamma
        self._children: dict[tuple, object] = {}
        self._lock = threading.Lock()

    def _make(self):
        return Histogram(self._gamma) if self.kind == "histogram" \
            else _KINDS[self.kind]()

    def labels(self, **kv):
        try:
            values = tuple(str(kv[k]) for k in self.labelnames)
        except KeyError as e:
            raise ValueError(f"metric {self.name!r} needs labels "
                             f"{self.labelnames}, got {sorted(kv)}") from e
        if len(kv) != len(self.labelnames):
            raise ValueError(f"metric {self.name!r} takes labels "
                             f"{self.labelnames}, got {sorted(kv)}")
        child = self._children.get(values)
        if child is None:
            with self._lock:
                child = self._children.setdefault(values, self._make())
        return child

    # ---- label-less convenience: the family IS the single instrument ------
    def _default(self):
        if self.labelnames:
            raise ValueError(f"metric {self.name!r} is labeled "
                             f"{self.labelnames}; use .labels(...)")
        return self.labels()

    def inc(self, amount: float = 1.0):
        self._default().inc(amount)

    def dec(self, amount: float = 1.0):
        self._default().dec(amount)

    def set(self, value: float):
        self._default().set(value)

    def observe(self, value: float):
        self._default().observe(value)

    def quantile(self, q: float):
        return self.merged().quantile(q) if self.kind == "histogram" \
            else self._default().quantile(q)

    # ---- cross-label views ------------------------------------------------
    def children(self):
        """Sorted ((labelvalue, ...), instrument) pairs."""
        return sorted(self._children.items())

    def total(self) -> float:
        """Sum of counter/gauge values across all label children."""
        if self.kind == "histogram":
            raise ValueError("total() is for counters/gauges; use merged()")
        return sum(c.value for c in self._children.values())

    def merged(self) -> Histogram:
        """All histogram children merged into one distribution."""
        if self.kind != "histogram":
            raise ValueError("merged() is for histograms; use total()")
        out = Histogram(self._gamma)
        for c in self._children.values():
            out.merge(c)
        return out

    def reset(self) -> None:
        for c in self._children.values():
            c.reset()


class MetricsRegistry:
    """Name -> Family. Re-declaring a name with the same (kind, labels)
    returns the existing family (modules can declare their instruments
    independently and share them); a conflicting re-declaration raises."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._families: dict[str, Family] = {}
        self._lock = threading.Lock()

    def _register(self, name: str, kind: str, help: str, labels, gamma=1.02):
        if not self.enabled:
            return _NULL_INSTRUMENT
        labels = tuple(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.labelnames != labels:
                    raise ValueError(
                        f"metric {name!r} already registered as {fam.kind}"
                        f"{fam.labelnames}, conflicting {kind}{labels}")
                return fam
            fam = Family(name, kind, help=help, labelnames=labels,
                         gamma=gamma)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "", labels=()) -> Family:
        return self._register(name, "counter", help, labels)

    def gauge(self, name: str, help: str = "", labels=()) -> Family:
        return self._register(name, "gauge", help, labels)

    def histogram(self, name: str, help: str = "", labels=(),
                  gamma: float = 1.02) -> Family:
        return self._register(name, "histogram", help, labels, gamma=gamma)

    def get(self, name: str) -> Family | None:
        return self._families.get(name)

    def collect(self):
        """Families sorted by name — the exposition iteration order."""
        return sorted(self._families.values(), key=lambda f: f.name)

    def reset(self) -> None:
        """Zero every instrument, keeping the registered families — benches
        use this to drop warm-up observations before the timed run."""
        for fam in self._families.values():
            fam.reset()


# shared disabled registry: the default `metrics` of library classes, so
# instrumentation calls are unconditional no-ops until a caller binds a live
# registry
NULL_REGISTRY = MetricsRegistry(enabled=False)
