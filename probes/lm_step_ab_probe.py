"""chip_smoke's I1 cell (h2o-danube-1.8b at full width, 4 microbatches of
1 x 4,096, donated AdamW steps) of several checkouts on one card, each in
a fresh process, in the order given: e.g. the parent commit, this one,
this one, the parent, so that two versions are compared on one host.

    python3 probes/lm_step_ab_probe.py --trees build/parent . . build/parent \\
        [--steps N] [--out DIR]

Each tree is a checkout holding `chip_smoke.py` and `src/` (a `git
archive` unpacked under build/ for another commit). Its process imports
that tree's chip_smoke and package, builds its kernels, sets the backends
as chip_smoke's slice I does, times `--steps` steps after a warm-up with
its `lm_train_cell` (CUDA events; the loss must fall on each repeated
batch) and runs its profile of one microbatch's forward and backward (no
optimizer; wall and device-busy time) and of AdamW alone. It also times
the host's dispatch of a small CUDA op (2,000 `torch.add` calls unsynced,
chip_smoke's yardstick in phase 2), which the host-bound LM step follows.
Prints the card's name and power limit, each run's log, and one summary
line per run; each run's log is written to `--out` too.
"""
import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent   # the repository


def card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        raise SystemExit(f"nvidia-smi failed: {smi.stderr}")
    return smi.stdout.strip().splitlines()[0]


def add_us(torch) -> float:
    """Host microseconds per unsynced torch.add on a 128 x 128 tensor."""
    x = torch.randn(128, 128, device="cuda")
    for _ in range(50):
        torch.add(x, 1.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2000):
        torch.add(x, 1.0)
    us = (time.perf_counter() - t0) / 2000 * 1e6
    torch.cuda.synchronize()
    return us


def one(tree: Path, steps: int) -> dict:
    """The I1 cell of `tree`'s chip_smoke in this process."""
    sys.path[:0] = [str(tree / "src"), str(tree)]
    import torch
    import chip_smoke as cs
    import repro_torch
    from repro_torch.configs import h2o_danube_1_8b
    from repro_torch.kernels import _build
    for mod in (cs, repro_torch):
        if tree not in Path(mod.__file__).resolve().parents:
            raise SystemExit(f"{mod.__name__} from {mod.__file__}, not "
                             f"{tree}")
    cs.CARD = card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    _build.build_all()
    host_us = add_us(torch)
    cs.I_TIMED = steps
    cs.reset_counts()
    out, params, opt = cs.lm_train_cell(
        "I1 danube", h2o_danube_1_8b.full_config(), cs.I1_MICRO,
        torch.device("cuda"), profile=True)
    fb = out["profile"]
    adam_ms = out["adam_ms"] if "adam_ms" in out else \
        out["adam_profile"]["busy_us"] / 1e3
    return {"tree": str(tree), "step_ms": out["step_ms"], "ms": out["ms"],
            "warmup_ms": out["warmup_ms"], "losses": out["losses"],
            "fb_wall_ms": fb["wall_us"] / 1e3,
            "fb_busy_ms": fb["busy_us"] / 1e3, "adam_ms": adam_ms,
            "idle": out["idle"], "add_us": host_us,
            "load": os.getloadavg()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", type=Path)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", type=Path,
                    default=ROOT / "chiprun_out" / "lm_step_ab_probe")
    ap.add_argument("--one", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        res = one(args.one.resolve(), args.steps)
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
        run = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                              "--one", str(tree),
                              "--steps", str(args.steps)],
                             capture_output=True, text=True, timeout=900,
                             cwd=tree)
        secs = time.perf_counter() - t0
        log = run.stdout + run.stderr
        (args.out / f"run{i}.log").write_text(log)
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
        print(f"run {i} {r['tree']}: step {r['ms']:.1f} ms (steps "
              f"{', '.join(f'{t:.1f}' for t in r['step_ms'])}; warm-up "
              f"{r['warmup_ms']:.1f}), one microbatch's forward and "
              f"backward wall {r['fb_wall_ms']:.1f} ms / busy "
              f"{r['fb_busy_ms']:.1f} ms, AdamW {r['adam_ms']:.3f} ms, "
              f"idle {r['idle']:.3f}, torch.add host {r['add_us']:.2f} us, "
              f"load {r['load'][0]:.2f}", flush=True)
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
