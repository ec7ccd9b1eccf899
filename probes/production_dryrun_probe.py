"""The production-mesh dry-run of the LM configs chip_smoke's slice M does
not run (deepseek-7b, qwen2.5-32b, qwen3-moe-235b-a22b), or of any
`--archs`, on the (16, 16) and (2, 16, 16) meshes of a fake world in this
one process, then `launch/roofline.py` over their records.

    python3 probes/production_dryrun_probe.py [--out DIR] [--archs NAME ...]
        [--whole]

`--whole` also counts the whole step of every cell whose counts come
from the probes and prints its peak temp bytes, FLOPs, bytes and
collective bytes beside the record's estimate.

Each cell runs `launch/dryrun.run_cell(..., mesh="production")` on meta
tensors, which takes a deep step's counts from the plan's reduced probes
(the reference's cost model) where they hold and counts the whole step
elsewhere (minutes a cell on one CPU core). It needs no card and runs
the same on a CPU. Records go to DIR/production.jsonl (default
build/production_dryrun), the report to DIR/roofline.md; it prints one
line per cell (the argument bytes held to `per_device_bytes`) and the
report.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent   # the repository
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs.registry import get  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402

ARCHS = ("deepseek-7b", "qwen2.5-32b", "qwen3-moe-235b-a22b")


def est(rec: dict) -> str:
    return " (estimated)" if rec["memory"]["peak_estimated"] else ""


def whole(rec: dict, plan, multi_pod: bool) -> None:
    """Print a whole count of the cell's step beside the record's
    estimate from the probes."""
    t0 = time.perf_counter()
    run = dryrun._count_production(plan, multi_pod, 0)
    moved = sum(v for k, v in run["coll"].items() if not k.startswith("n_"))
    est_moved = sum(v for k, v in rec["collectives"].items()
                    if not k.startswith("n_"))

    def rel(a, b):
        return f"{(b - a) / a:+.2%}" if a else "n/a"
    print(f"    whole count ({time.perf_counter() - t0:.1f} s): peak temp "
          f"{run['peak']:,} B (estimate {rec['memory']['temp_bytes']:,}, "
          f"{rel(run['peak'], rec['memory']['temp_bytes'])}), FLOPs "
          f"{run['cost']['flops']:.6g} ({rel(run['cost']['flops'], rec['cost']['flops'])}), "
          f"bytes {run['cost']['bytes accessed']:.6g} "
          f"({rel(run['cost']['bytes accessed'], rec['cost']['bytes_accessed'])}), "
          f"collective bytes {moved:.6g} ({rel(moved, est_moved)})",
          flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "production_dryrun"))
    ap.add_argument("--archs", nargs="*", default=list(ARCHS))
    ap.add_argument("--whole", action="store_true")
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    src = out / "production.jsonl"
    src.write_text("")
    n_bad = 0
    for mp in (False, True):
        for arch in args.archs:
            for cell in get(arch).cells():
                t0 = time.perf_counter()
                try:
                    rec = dryrun.run_cell(arch, cell.shape, mp,
                                          "production", verbose=True)
                except Exception as e:  # noqa: BLE001 - record and go on
                    rec = {"arch": arch, "shape": cell.shape,
                           "multi_pod": mp, "mesh": "production",
                           "status": "error", "error": repr(e)[:500]}
                if rec["status"] == "ok":
                    want = dryrun.per_device_bytes(
                        get(arch).build(cell.shape, mp), mp)
                    same = rec["memory"]["argument_bytes"] == want
                    n_bad += not same
                    print(f"  {arch} {cell.shape} multi_pod={mp}: args "
                          f"{rec['memory']['argument_bytes']:,} B "
                          f"({'=' if same else '!='} per_device_bytes "
                          f"{want:,}), peak "
                          f"{rec['memory']['peak_per_device']:,} B"
                          f"{est(rec)}, fits "
                          f"{rec['memory']['fits']}, "
                          f"{time.perf_counter() - t0:.1f} s", flush=True)
                    if args.whole and rec["memory"]["peak_estimated"]:
                        whole(rec, get(arch).build(cell.shape, mp), mp)
                elif rec["status"] == "error":
                    n_bad += 1
                    print(f"  {arch} {cell.shape} multi_pod={mp}: ERROR "
                          f"{rec['error']}", flush=True)
                with open(src, "a") as f:
                    f.write(json.dumps(rec) + "\n")
    roofline.main(["--in", str(src), "--out", str(out / "roofline.md")])
    print((out / "roofline.md").read_text())
    return 1 if n_bad else 0


if __name__ == "__main__":
    sys.exit(main())
