"""Roofline report (port of `repro.launch.roofline`): dryrun.jsonl ->
markdown tables.

    PYTHONPATH=src python -m repro_torch.launch.roofline \\
        --in dryrun.jsonl --out roofline.md

The tables and row formats are the reference's; a record without a
`mesh` key (the reference's) counts as the production mesh's, and each
heading names the mesh its records ran on. Where the records carry
`step_ms` (the port's `--mesh card` runs), the roofline table adds the
measured step (median) and the bound's share of it, the largest term
over the step, as its last columns. `advice` keeps the reference's
branches with text true of one H100.
"""
from __future__ import annotations

import argparse
import json

__all__ = ["load_cells", "dryrun_table", "roofline_table", "advice",
           "main"]

_MESH_LABELS = {
    ("production", False): "single-pod 16x16 (256 chips)",
    ("production", True): "multi-pod 2x16x16 (512 chips)",
    ("card", False): "one card, (1, 1) mesh",
    ("card", True): "one card, (1, 1) mesh, multi-pod plans",
}


def _mesh(r: dict) -> str:
    return r.get("mesh", "production")


def load_cells(path: str) -> dict:
    """Last record wins per (arch, shape, multi_pod, mesh)."""
    cells = {}
    with open(path) as f:
        for line in f:
            try:
                r = json.loads(line)
            except json.JSONDecodeError:
                continue
            cells[(r["arch"], r["shape"], r["multi_pod"], _mesh(r))] = r
    return cells


def _fmt_s(x: float) -> str:
    if x >= 1.0:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.1f}ms"
    return f"{x * 1e6:.0f}us"


def _fmt_b(x: float) -> str:
    for unit, div in (("GiB", 2**30), ("MiB", 2**20), ("KiB", 2**10)):
        if x >= div:
            return f"{x / div:.1f}{unit}"
    return f"{x:.0f}B"


def _select(cells: dict, multi_pod: bool, mesh: str) -> list:
    return [(k, r) for k, r in sorted(cells.items())
            if k[2] == multi_pod and k[3] == mesh]


def dryrun_table(cells: dict, multi_pod: bool,
                 mesh: str = "production") -> list[str]:
    lines = [
        "| arch | shape | status | peak/dev | HLO flops/dev | collective bytes/dev | schedule (AG/AR/RS/A2A/CP) |",
        "|---|---|---|---|---|---|---|",
    ]
    for (arch, shape, _, _), r in _select(cells, multi_pod, mesh):
        if r["status"] == "skipped":
            lines.append(f"| {arch} | {shape} | SKIP: {r['reason'][:60]}... | | | | |")
            continue
        if r["status"] != "ok":
            lines.append(f"| {arch} | {shape} | ERROR | | | | |")
            continue
        c = r["collectives"]
        sched = "/".join(str(int(c.get(f"n_{k}", 0))) for k in
                         ("all-gather", "all-reduce", "reduce-scatter",
                          "all-to-all", "collective-permute"))
        peak = r["memory"]["peak_per_device"]
        est = " (estimated)" if r["memory"].get("peak_estimated") else ""
        lines.append(
            f"| {arch} | {shape} | ok | "
            f"{'n/a' if peak is None else _fmt_b(peak) + est} | "
            f"{r['cost']['flops']:.3g} | "
            f"{_fmt_b(r['roofline']['coll_bytes'])} | {sched} |")
    return lines


def roofline_table(cells: dict, multi_pod: bool,
                   mesh: str = "production") -> list[str]:
    rows = [(k, r) for k, r in _select(cells, multi_pod, mesh)
            if r["status"] == "ok"]
    measured = any("step_ms" in r for _, r in rows)
    head = "| arch | shape | compute | memory | collective | dominant | MODEL_FLOPS | useful ratio | what would move the dominant term |"
    rule = "|---|---|---|---|---|---|---|---|---|"
    if measured:
        head += " step (measured) | bound / step |"
        rule += "---|---|"
    lines = [head, rule]
    for (arch, shape, _, _), r in rows:
        rf = r["roofline"]
        row = (f"| {arch} | {shape} | {_fmt_s(rf['compute_s'])} | "
               f"{_fmt_s(rf['memory_s'])} | {_fmt_s(rf['collective_s'])} | "
               f"**{rf['dominant']}** | {rf['model_flops']:.3g} | "
               f"{rf['useful_flops_ratio']:.3f} | "
               f"{advice(arch, shape, rf)} |")
        if measured:
            if "step_ms" in r:
                step_s = r["step_ms"]["median"] * 1e-3
                bound = max(rf["compute_s"], rf["memory_s"],
                            rf["collective_s"])
                row += f" {_fmt_s(step_s)} | {bound / step_s:.3f} |"
            else:
                row += " | |"
        lines.append(row)
    return lines


def advice(arch: str, shape: str, rf: dict) -> str:
    d = rf["dominant"]
    if arch == "cpaa-pagerank":
        if d == "collective":
            return ("2D partition / batched personalization raises "
                    "intensity over NVLink")
        return "block-ELL tiles + BFS ordering cut HBM traffic"
    if d == "collective":
        return "all-to-all expert dispatch; overlap NCCL with expert compute"
    if d == "memory":
        if "decode" in shape or "500k" in shape:
            return "KV cache quantization (bf16->int8) halves cache reads"
        return "fuse gather+interaction; bf16 activations end-to-end"
    return "already compute-bound; raise tensor-core utilization via tiling"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--in", dest="inp", default="experiments/dryrun.jsonl")
    ap.add_argument("--out", default="experiments/roofline.md")
    args = ap.parse_args(argv)
    cells = load_cells(args.inp)
    out = ["# Dry-run + roofline tables (generated by "
           "repro_torch.launch.roofline)", ""]
    meshes = sorted({k[3] for k in cells}, key=("production", "card").index) \
        or ["production"]
    for mesh in meshes:
        for mp in (False, True):
            if mesh == "card" and not any(k[2] == mp and k[3] == mesh
                                          for k in cells):
                continue
            out.append(f"## Dry-run — {_MESH_LABELS[(mesh, mp)]}")
            out += dryrun_table(cells, mp, mesh)
            out.append("")
        label = "single-pod" if mesh == "production" else \
            _MESH_LABELS[(mesh, False)]
        out.append(f"## Roofline — {label} (terms are seconds per step)")
        out += roofline_table(cells, False, mesh)
        out.append("")
    n_ok = sum(1 for r in cells.values() if r["status"] == "ok")
    n_skip = sum(1 for r in cells.values() if r["status"] == "skipped")
    n_err = sum(1 for r in cells.values() if r["status"] == "error")
    out.append(f"cells: ok={n_ok} skipped={n_skip} error={n_err}")
    with open(args.out, "w") as f:
        f.write("\n".join(out) + "\n")
    print(f"wrote {args.out}: ok={n_ok} skipped={n_skip} error={n_err}")


if __name__ == "__main__":
    main()
