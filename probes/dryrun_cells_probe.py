"""`launch/dryrun.py --mesh card` on the registry cells chip_smoke's slice
K does not run, one process per cell, then `launch/roofline.py` over
their records.

    python3 probes/dryrun_cells_probe.py [--out DIR] [--timeout S]
        [--cells arch:shape ...]

By default the cells are every GNN and cpaa-pagerank cell but slice K's
(the LM cells' full batches take minutes a step; slice K runs DLRM-RM2's
four). Each cell runs in a process of its own (an out-of-memory error
frees the card for the next), with a time limit of `--timeout` seconds.
Records go to DIR/dryrun.jsonl (default build/dryrun_cells), the report
to DIR/roofline.md; it prints the card's name and power limit, each
cell's exit code and seconds, the report and one line per record.
"""
import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent   # the repository
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.launch.dryrun import card_name  # noqa: E402

CELLS = (
    ["graphcast:" + s for s in ("full_graph_sm", "minibatch_lg",
                                "ogb_products", "molecule")]
    + ["pna:" + s for s in ("full_graph_sm", "minibatch_lg",
                            "ogb_products")]
    + ["dimenet:" + s for s in ("full_graph_sm", "minibatch_lg",
                                "ogb_products", "molecule")]
    + ["meshgraphnet:" + s for s in ("full_graph_sm", "minibatch_lg",
                                     "ogb_products", "molecule")]
    + ["cpaa-pagerank:" + s for s in ("pr_kmer_550m", "pr_mesh_67m_2d",
                                      "pr_mesh_67m_2d_bf16",
                                      "pr_mesh_67m_b128",
                                      "pr_mesh_67m_2d_b128")])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "build" / "dryrun_cells"))
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--cells", nargs="*", default=CELLS)
    args = ap.parse_args()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    records = out / "dryrun.jsonl"
    records.unlink(missing_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    card = card_name(torch.device("cuda", 0))
    print(card, flush=True)
    for cell in args.cells:
        arch, shape = cell.split(":")
        t0 = time.perf_counter()
        try:
            r = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.dryrun",
                 "--mesh", "card", "--arch", arch, "--shape", shape,
                 "--out", str(records)], env=env, cwd=ROOT,
                capture_output=True, text=True, timeout=args.timeout)
            rc, text = r.returncode, r.stdout + r.stderr[-2000:]
        except subprocess.TimeoutExpired:
            rc, text = "timeout", ""
        print(f"[{card}] {arch} {shape}: rc {rc}, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for line in text.splitlines():
            if line.startswith("[") or "Error" in line:
                print("   ", line[:400], flush=True)
    subprocess.run([sys.executable, "-m", "repro_torch.launch.roofline",
                    "--in", str(records), "--out", str(out / "roofline.md")],
                   env=env, cwd=ROOT, check=True)
    print((out / "roofline.md").read_text(), flush=True)
    for line in records.read_text().splitlines():
        r = json.loads(line)
        ms = r.get("step_ms", {}).get("median")
        peak = (r.get("memory") or {}).get("peak_per_device")
        print(f"[{card}] {r['arch']} {r['shape']}: {r['status']}"
              f"{'' if ms is None else f', step {ms:.3f} ms'}"
              f"{'' if peak is None else f', peak {peak:,} B'}"
              f"{' ' + r['error'][:200] if 'error' in r else ''}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
