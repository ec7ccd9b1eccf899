"""chip_smoke's slice J alone on the card: the all-to-all MoE on a (1, 1)
("data", "model") mesh over NCCL, granite-moe-3b-a800m at full width on
weights from generator seed 0 (chip_smoke trains it on I2's weights) and
qwen3-moe-235b-a22b's train_4k_a2a cell at 2 of 94 layers, with every
gate of the slice.

    python3 probes/slice_j_probe.py [--rounds N]

`--rounds N` times N rounds of dense, a2a, a2a, dense granite steps
(chip_smoke's J_ROUNDS, 1 by default), so that the a2a / dense ratio of
each round shows its own spread. Builds no kernel (the slice launches
none). Every line it prints carries the card's name and power limit.
"""
import argparse
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent   # the repository
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
# cuBLAS is deterministic only with a fixed workspace (gate J-c)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
import chip_smoke  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=chip_smoke.J_ROUNDS,
                    help="timed rounds of dense, a2a, a2a, dense steps")
    args = ap.parse_args()
    chip_smoke.J_ROUNDS = args.rounds
    import torch
    from repro_torch.configs import granite_moe_3b
    from repro_torch.models import transformer as tf
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    chip_smoke.check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    chip_smoke.CARD = smi.stdout.strip().splitlines()[0]
    chip_smoke.log(f"{chip_smoke.CARD}; torch {torch.__version__}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = granite_moe_3b.full_config()
    chip_smoke.reset_counts()
    # no reference kept here: the slice frees granite before qwen3
    chip_smoke.phase_slice_j((cfg, tf.init_params(
        torch.Generator(device="cuda").manual_seed(0), cfg)))
    launches = chip_smoke.read_counts()
    chip_smoke.check(launches["bsr_spmm"] == launches["cheb_step"]
                     == launches["embedding_bag"]
                     == launches["embedding_bag_backward"] == 0,
                     f"slice J launched a kernel: {launches}")


if __name__ == "__main__":
    main()
