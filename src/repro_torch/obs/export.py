"""Exposition: Prometheus text, JSON snapshots, HTTP endpoint, CLI summary
(a copy of `repro.obs.export`; the snapshot schema string is shared).

One source of truth — `snapshot(registry, ...)` — feeds every output:

  * `to_prometheus(registry)`      — Prometheus text format v0.0.4 (counters
                                     and gauges as-is; histograms as the
                                     cumulative `le` bucket series + _sum
                                     + _count), for the `--metrics-port`
                                     scrape endpoint.
  * `snapshot(...)`                — JSON-ready dict: every metric family
                                     with per-label series, histogram
                                     count/sum/min/max/p50/p99/p999, plus
                                     the convergence log and recent traces.
  * `write_snapshot(path, ...)`    — snapshot dumped to a file
                                     (`--metrics-json PATH`).
  * `validate_snapshot(obj)`       — schema check, also from the
                                     command line: `python -m
                                     repro_torch.obs.export --validate
                                     FILE`.
  * `render_summary(snap)`         — the human CLI report `launch/serve.py`
                                     prints, derived from the same snapshot
                                     that the JSON/Prometheus paths export.
  * `MetricsServer`                — stdlib ThreadingHTTPServer serving
                                     `/metrics` (Prometheus) and
                                     `/metrics.json` (snapshot) on a
                                     background thread.
"""
from __future__ import annotations

import argparse
import json
import sys
import threading

from repro_torch.obs.metrics import MetricsRegistry

__all__ = ["to_prometheus", "snapshot", "write_snapshot", "validate_snapshot",
           "render_summary", "MetricsServer", "SNAPSHOT_SCHEMA"]

SNAPSHOT_SCHEMA = "repro.obs.snapshot/v1"


def _fmt(v: float) -> str:
    """Prometheus-style float: integers without the trailing .0."""
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _label_str(labelnames, values) -> str:
    if not labelnames:
        return ""
    inner = ",".join(
        '%s="%s"' % (k, str(v).replace("\\", "\\\\").replace('"', '\\"'))
        for k, v in zip(labelnames, values))
    return "{%s}" % inner


def to_prometheus(registry: MetricsRegistry) -> str:
    """Text exposition format v0.0.4."""
    lines = []
    for fam in registry.collect():
        lines.append(f"# HELP {fam.name} {fam.help}")
        lines.append(f"# TYPE {fam.name} {fam.kind}")
        for values, inst in fam.children():
            labels = _label_str(fam.labelnames, values)
            if fam.kind in ("counter", "gauge"):
                lines.append(f"{fam.name}{labels} {_fmt(inst.value)}")
            else:
                base = list(zip(fam.labelnames, values))
                cum = 0
                for ub, cum in inst.bucket_bounds():
                    le = _label_str([k for k, _ in base] + ["le"],
                                    [v for _, v in base] + [_fmt(ub)])
                    lines.append(f"{fam.name}_bucket{le} {cum}")
                inf = _label_str([k for k, _ in base] + ["le"],
                                 [v for _, v in base] + ["+Inf"])
                lines.append(f"{fam.name}_bucket{inf} {inst.count}")
                lines.append(f"{fam.name}_sum{labels} {_fmt(inst.sum)}")
                lines.append(f"{fam.name}_count{labels} {inst.count}")
    return "\n".join(lines) + "\n"


def _series(fam) -> list[dict]:
    out = []
    for values, inst in fam.children():
        entry = {"labels": dict(zip(fam.labelnames, values))}
        if fam.kind in ("counter", "gauge"):
            entry["value"] = inst.value
        else:
            p50, p99, p999 = inst.percentiles((50.0, 99.0, 99.9))
            entry.update(count=inst.count, sum=inst.sum,
                         min=(inst.min if inst.count else 0.0),
                         max=(inst.max if inst.count else 0.0),
                         mean=inst.mean, p50=p50, p99=p99, p999=p999)
        out.append(entry)
    return out


def snapshot(registry: MetricsRegistry, convergence=None, tracer=None,
             meta: dict | None = None) -> dict:
    """JSON-ready snapshot of everything observability knows right now."""
    snap = {
        "schema": SNAPSHOT_SCHEMA,
        "meta": dict(meta or {}),
        "metrics": {
            fam.name: {
                "kind": fam.kind,
                "help": fam.help,
                "labelnames": list(fam.labelnames),
                "series": _series(fam),
            }
            for fam in registry.collect()
        },
    }
    if convergence is not None:
        snap["convergence"] = convergence.as_dicts()
    if tracer is not None and getattr(tracer, "finished", None):
        snap["traces"] = [t.as_dict() for t in tracer.finished]
    return snap


def write_snapshot(path: str, registry: MetricsRegistry, convergence=None,
                   tracer=None, meta: dict | None = None) -> dict:
    snap = snapshot(registry, convergence=convergence, tracer=tracer,
                    meta=meta)
    with open(path, "w") as f:
        json.dump(snap, f, indent=2, sort_keys=True)
        f.write("\n")
    return snap


def validate_snapshot(obj) -> list[str]:
    """Structural schema check; returns a list of problems (empty = valid)."""
    errs = []
    if not isinstance(obj, dict):
        return ["snapshot is not an object"]
    if obj.get("schema") != SNAPSHOT_SCHEMA:
        errs.append(f"schema != {SNAPSHOT_SCHEMA!r}: {obj.get('schema')!r}")
    metrics = obj.get("metrics")
    if not isinstance(metrics, dict):
        errs.append("missing 'metrics' object")
        return errs
    for name, fam in metrics.items():
        where = f"metrics[{name!r}]"
        if not isinstance(fam, dict):
            errs.append(f"{where} is not an object")
            continue
        kind = fam.get("kind")
        if kind not in ("counter", "gauge", "histogram"):
            errs.append(f"{where}.kind invalid: {kind!r}")
            continue
        labelnames = fam.get("labelnames")
        if not isinstance(labelnames, list):
            errs.append(f"{where}.labelnames missing")
            labelnames = []
        series = fam.get("series")
        if not isinstance(series, list):
            errs.append(f"{where}.series missing")
            continue
        for i, s in enumerate(series):
            w = f"{where}.series[{i}]"
            if not isinstance(s, dict):
                errs.append(f"{w} is not an object")
                continue
            labels = s.get("labels")
            if not isinstance(labels, dict) or \
                    sorted(labels) != sorted(labelnames):
                errs.append(f"{w}.labels do not match labelnames "
                            f"{labelnames}")
            if kind == "histogram":
                for k in ("count", "sum", "p50", "p99", "p999"):
                    if not isinstance(s.get(k), (int, float)):
                        errs.append(f"{w}.{k} missing or non-numeric")
                if isinstance(s.get("count"), int) and s["count"] > 0:
                    if not (s.get("min", 0) <= s.get("p50", 0)
                            <= s.get("p99", 0) <= s.get("p999", 0)
                            <= s.get("max", 0) + 1e-12):
                        errs.append(f"{w} quantiles not monotone")
            else:
                if not isinstance(s.get("value"), (int, float)):
                    errs.append(f"{w}.value missing or non-numeric")
                if kind == "counter" and isinstance(s.get("value"),
                                                   (int, float)) \
                        and s["value"] < 0:
                    errs.append(f"{w}.value negative counter")
    conv = obj.get("convergence")
    if conv is not None:
        if not isinstance(conv, dict) or "summary" not in conv:
            errs.append("convergence present but missing 'summary'")
        else:
            summ = conv["summary"]
            if summ.get("bound_violations", 0) != 0:
                errs.append("convergence.summary.bound_violations != 0 "
                            "(rounds_used exceeded the Formula 8 bound)")
    return errs


# ---------------------------------------------------------------------------
# human summary — the single final-report code path for launch/serve.py
# ---------------------------------------------------------------------------

def _metric(snap, name):
    return snap.get("metrics", {}).get(name, {"series": []})


def _total(snap, name, **match) -> float:
    """Sum a counter/gauge family's series, optionally filtered by labels."""
    tot = 0.0
    for s in _metric(snap, name)["series"]:
        labels = s.get("labels", {})
        if all(labels.get(k) == str(v) for k, v in match.items()):
            tot += s.get("value", 0.0)
    return tot


def _merged_hist(snap, name, **match) -> dict:
    """Count-weighted merge of a histogram family's series for summary
    lines. Quantiles of the merged set are approximated by the max across
    series (conservative for tails); count/sum are exact."""
    agg = {"count": 0, "sum": 0.0, "p50": 0.0, "p99": 0.0, "p999": 0.0}
    for s in _metric(snap, name)["series"]:
        labels = s.get("labels", {})
        if not all(labels.get(k) == str(v) for k, v in match.items()):
            continue
        agg["count"] += s.get("count", 0)
        agg["sum"] += s.get("sum", 0.0)
        for q in ("p50", "p99", "p999"):
            agg[q] = max(agg[q], s.get(q, 0.0))
    agg["mean"] = agg["sum"] / agg["count"] if agg["count"] else 0.0
    return agg


def render_summary(snap: dict) -> str:
    """Final serve report rendered from a snapshot dict (not live objects),
    so the CLI summary can never disagree with the exported JSON."""
    lines = []
    meta = snap.get("meta", {})
    queries = _total(snap, "serve_queries_total")
    hits = _total(snap, "serve_served_total", disposition="cache_hit")
    solved = _total(snap, "serve_served_total", disposition="solved")
    dropped = _total(snap, "serve_served_total", disposition="dropped")
    solves = _total(snap, "serve_solves_total")
    ticks = _total(snap, "serve_ticks_total")
    elapsed = meta.get("elapsed_s")
    qps = f"{queries / elapsed:8.1f} q/s" if elapsed else "    n/a"
    lines.append(f"served   : {int(queries):6d} queries  {qps}")
    mean_b = solved / solves if solves else 0.0
    lines.append(f"solves   : {int(solves):6d} batched "
                 f"(mean B={mean_b:.1f}, ticks={int(ticks)})  "
                 f"cache hits={int(hits)}  dropped={int(dropped)}")
    lat = _merged_hist(snap, "serve_query_latency_seconds")
    if lat["count"]:
        lines.append("latency  : p50=%.1fus  p99=%.1fus  p999=%.1fus  "
                     "mean=%.1fus" % (lat["p50"] * 1e6, lat["p99"] * 1e6,
                                      lat["p999"] * 1e6, lat["mean"] * 1e6))
    stage_bits = []
    for stage in ("queue", "batch_form", "solve_dispatch", "solve_device",
                  "materialize"):
        h = _merged_hist(snap, "serve_stage_seconds", stage=stage)
        if h["count"]:
            stage_bits.append("%s=%.1fus" % (stage, h["mean"] * 1e6))
    if stage_bits:
        lines.append("stages   : " + "  ".join(stage_bits) + "  (means)")
    used = _total(snap, "serve_rounds_used_total")
    bound = _total(snap, "serve_rounds_bound_total")
    if bound:
        lines.append(f"rounds   : used={int(used)} of bound={int(bound)} "
                     f"({100.0 * (1 - used / bound):.0f}% saved by adaptive "
                     "exit)")
    conv = snap.get("convergence", {}).get("summary", {})
    if conv:
        lines.append("converge : bound_violations=%d  recent converged "
                     "frac=%.3f" % (conv.get("bound_violations", 0),
                                    conv.get("recent_converged_frac", 1.0)))
    updates = _total(snap, "serve_updates_total")
    if updates:
        inc = _total(snap, "serve_updates_total", kind="incremental")
        noop = _total(snap, "serve_updates_total", kind="noop")
        rebuild = _total(snap, "serve_updates_total", kind="rebuild")
        lines.append(f"updates  : {int(updates):6d} "
                     f"(incremental={int(inc)}, rebuild={int(rebuild)}, "
                     f"noop={int(noop)})")
        kept = _total(snap, "serve_cache_retained_total")
        dropped_c = _total(snap, "serve_cache_dropped_total")
        tot = kept + dropped_c
        if tot:
            lines.append(f"cache    : retained {int(kept)}/{int(tot)} "
                         f"entries across updates "
                         f"({100.0 * kept / tot:.0f}%)")
    refreshes = _total(snap, "serve_refreshes_total")
    if refreshes:
        lines.append(f"refresh  : {int(refreshes):6d} background refreshes")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# HTTP endpoint
# ---------------------------------------------------------------------------

class MetricsServer:
    """Background stdlib HTTP server: GET /metrics (Prometheus text) and
    GET /metrics.json (snapshot). `port=0` binds an ephemeral port (tests);
    the bound port is `self.port` after start()."""

    def __init__(self, registry: MetricsRegistry, port: int = 0,
                 host: str = "127.0.0.1", convergence=None, tracer=None,
                 meta: dict | None = None):
        self.registry = registry
        self.convergence = convergence
        self.tracer = tracer
        self.meta = meta or {}
        self.host = host
        self.port = port
        self._httpd = None
        self._thread = None

    def start(self) -> "MetricsServer":
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        server = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                if self.path.startswith("/metrics.json"):
                    body = json.dumps(
                        snapshot(server.registry,
                                 convergence=server.convergence,
                                 tracer=server.tracer,
                                 meta=server.meta)).encode()
                    ctype = "application/json"
                elif self.path.startswith("/metrics"):
                    body = to_prometheus(server.registry).encode()
                    ctype = "text/plain; version=0.0.4"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass   # scrapes must not spam the serve CLI

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="metrics-server", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="validate an obs snapshot file (CI gate)")
    ap.add_argument("--validate", metavar="FILE", required=True,
                    help="path to a metrics snapshot JSON")
    args = ap.parse_args(argv)
    try:
        with open(args.validate) as f:
            obj = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        print(f"snapshot unreadable: {e}", file=sys.stderr)
        return 2
    errs = validate_snapshot(obj)
    if errs:
        for e in errs:
            print(f"INVALID: {e}", file=sys.stderr)
        return 1
    n = len(obj.get("metrics", {}))
    print(f"snapshot OK: {n} metric families, schema {obj['schema']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
