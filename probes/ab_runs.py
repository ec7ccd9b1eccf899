"""The driver that the A/B probes share (`lm_step_ab_probe.py`,
`ppr_tick_ab_probe.py`): each runs one chip_smoke cell of several
checkouts on one card, each checkout in a fresh process, in the order
given (e.g. the parent commit, this one, this one, the parent), so that
two versions are compared on one host. A probe supplies only its cell:
`one(tree, count) -> dict`, run in the child process, and a summary line
for each run's dict.

Each tree is a checkout holding `chip_smoke.py` and `src/` (a `git
archive` unpacked under build/ for another commit). The driver prints the
card's name and power limit, each run's log and one summary line per run,
writes each run's log to `--out`, and prints all runs' dicts as JSON last.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent   # the repository


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        raise SystemExit(f"nvidia-smi failed: {smi.stderr}")
    return smi.stdout.strip().splitlines()[0]


def load_tree(tree: Path):
    """Import `tree`'s chip_smoke and repro_torch in this process (and
    check that they came from it), set chip_smoke's card line -> the
    chip_smoke module."""
    sys.path[:0] = [str(tree / "src"), str(tree)]
    import chip_smoke as cs
    import repro_torch
    for mod in (cs, repro_torch):
        if tree not in Path(mod.__file__).resolve().parents:
            raise SystemExit(f"{mod.__name__} from {mod.__file__}, not "
                             f"{tree}")
    cs.CARD = card()
    return cs


def main(doc: str, script: str, one, summary, count: str,
         default: int) -> int:
    """Parse `--trees`, `--<count>` and `--out`; run `one` for each tree
    in a child process of `script`, then print `summary(i, result)` for
    each run and the results as JSON."""
    name = Path(script).stem
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--trees", nargs="+", type=Path)
    ap.add_argument(f"--{count}", type=int, default=default, dest="count")
    ap.add_argument("--out", type=Path, default=ROOT / "chiprun_out" / name)
    ap.add_argument("--one", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        res = one(args.one.resolve(), args.count)
        print("RESULT " + json.dumps(res), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    print(card(), flush=True)
    args.out.mkdir(parents=True, exist_ok=True)
    rows = []
    for i, tree in enumerate(args.trees):
        tree = tree.resolve()
        if not (tree / "chip_smoke.py").exists():
            raise SystemExit(f"{tree} holds no chip_smoke.py")
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, str(Path(script).resolve()),
                              "--one", str(tree),
                              f"--{count}", str(args.count)],
                             capture_output=True, text=True, timeout=900,
                             cwd=tree)
        secs = time.perf_counter() - t0
        (args.out / f"run{i}.log").write_text(run.stdout + run.stderr)
        print(f"--- run {i}: {tree} (rc {run.returncode}, {secs:.1f} s)\n"
              + "\n".join(ln for ln in run.stdout.splitlines()
                          if not ln.startswith("RESULT ")), flush=True)
        res = [ln for ln in run.stdout.splitlines()
               if ln.startswith("RESULT ")]
        if run.returncode != 0 or not res:
            print(run.stderr[-4000:], flush=True)
            return 1
        rows.append(json.loads(res[0][len("RESULT "):]))
    for i, r in enumerate(rows):
        print(summary(i, r), flush=True)
    print(json.dumps(rows))
    return 0
