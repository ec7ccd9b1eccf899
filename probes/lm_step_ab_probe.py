"""chip_smoke's I1 cell (h2o-danube-1.8b at full width, 4 microbatches of
1 x 4,096, donated AdamW steps) of several checkouts on one card, each in
a fresh process, in the order given (`ab_runs.py`): e.g. the parent
commit, this one, this one, the parent, so that two versions are compared
on one host.

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
import os
import sys
import time
from pathlib import Path

import ab_runs


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
    cs = ab_runs.load_tree(tree)
    import torch
    from repro_torch.configs import h2o_danube_1_8b
    from repro_torch.kernels import _build
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


def summary(i: int, r: dict) -> str:
    return (f"run {i} {r['tree']}: step {r['ms']:.1f} ms (steps "
            f"{', '.join(f'{t:.1f}' for t in r['step_ms'])}; warm-up "
            f"{r['warmup_ms']:.1f}), one microbatch's forward and "
            f"backward wall {r['fb_wall_ms']:.1f} ms / busy "
            f"{r['fb_busy_ms']:.1f} ms, AdamW {r['adam_ms']:.3f} ms, "
            f"idle {r['idle']:.3f}, torch.add host {r['add_us']:.2f} us, "
            f"load {r['load'][0]:.2f}")


if __name__ == "__main__":
    sys.exit(ab_runs.main(__doc__, __file__, one, summary, "steps", 3))
