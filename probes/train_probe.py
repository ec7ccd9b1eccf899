"""Two measurements behind choices in chip_smoke's training slices, on the
card.

    python3 probes/train_probe.py [--lr] [--gnn]

  --lr   h2o-danube-1.8b at full width on chip_smoke's I1 batches (8
         microbatches of 1 x 4,096, donated): per (compute dtype, lr), 4
         AdamW steps on the 2 cycled batches, with the loss of batch 0,
         batch 1 and a held-out batch before the first step and after
         each; then, in bf16, the loss of batch 0 along the first step's
         AdamW direction at several step sizes. Behind chip_smoke.I_LR.
  --gnn  slice G's four models at minibatch_lg, ms per step with the
         layer views taken as x[i] per layer against one unbind per
         leaf, alternating (index, unbind, unbind, index; 3 steps each).
Every line it prints carries the card's name and power limit.
"""
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent   # the repository
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
import chip_smoke  # noqa: E402

LR_RUNS = [("bfloat16", 1e-5), ("float32", 1e-5), ("bfloat16", 3e-6),
           ("bfloat16", 1e-6)]
LINE_SIZES = (1e-6, 3e-6, 1e-5, 3e-5, 1e-4)   # along the direction
HELD_OUT = 2                            # sequences of the held-out batch


def gnn_views_compare():
    """Slice G's models take layer i of their stacks as x[i] per layer
    (`common.layer_slice`); against them, one unbind per leaf per forward
    (`layers.layer_views`, patched in), alternating in one process."""
    import importlib
    import numpy as np
    import torch
    from functools import partial
    from repro_torch.models.layers import layer_views
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.train_loop import make_train_step

    views = {}

    def unbound(tree, i):
        if i == 0:          # the models walk their layers in order
            views["now"] = layer_views(tree)
        return views["now"][i]
    for arch in chip_smoke.G_ARCHS:
        mod = importlib.import_module(f"repro_torch.models.gnn.{arch}")
        indexed = mod.layer_slice
        torch.cuda.empty_cache()
        _, model, cfg, params, batch = chip_smoke.gnn_case(
            arch, "minibatch_lg", torch.device("cuda"))
        opt_cfg = AdamWConfig(lr=chip_smoke.G_LR)
        opt = adamw_init(params, opt_cfg)
        step = make_train_step(partial(model.loss_fn, cfg=cfg), opt_cfg,
                               donate=True)
        res = {"index": [], "unbind": []}
        for kind in ("index", "unbind", "unbind", "index"):
            mod.layer_slice = indexed if kind == "index" else unbound
            step(params, opt, batch)
            torch.cuda.synchronize()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            for i in range(3):
                step(params, opt, batch)
                ev[i + 1].record()
            torch.cuda.synchronize()
            res[kind] += [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
        mod.layer_slice = indexed
        chip_smoke.log(
            f"[{chip_smoke.CARD}] G views {arch} at minibatch_lg ms per "
            f"step: x[i] per layer mean {np.mean(res['index']):.3f} "
            f"({', '.join(f'{x:.3f}' for x in res['index'])}); unbind mean "
            f"{np.mean(res['unbind']):.3f} "
            f"({', '.join(f'{x:.3f}' for x in res['unbind'])})")
        del params, opt, batch, step


def lr_trajectories():
    """Whether a loss that rises on a repeated batch is AdamW's own
    dynamics (then it shows in float32 as in bf16, on a held-out batch
    too, and goes with the lr) or a fault of the step."""
    import dataclasses
    import torch
    from functools import partial
    from torch.utils import _pytree as pytree
    from repro_torch.configs import h2o_danube_1_8b
    from repro_torch.models import transformer as tf
    from repro_torch.train.data import TokenPipelineConfig, token_batch
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.train_loop import make_train_step
    dev = torch.device(chip_smoke.I_DEVICE)
    seq, micro = chip_smoke.I1_SEQ, chip_smoke.I1_MICRO
    vocab = h2o_danube_1_8b.full_config().vocab
    batches = [token_batch(TokenPipelineConfig(vocab, seq, micro), i, dev)
               for i in range(2)]
    held = token_batch(TokenPipelineConfig(vocab, seq, HELD_OUT), 2, dev)

    def losses(params, cfg):
        """mean loss over the rows of batch 0, batch 1, the held-out
        batch, one row at a time as the step's microbatches."""
        with torch.no_grad():
            return [float(sum(tf.loss_fn(params, {"tokens": r}, cfg)
                              for r in b["tokens"].split(1))
                          / b["tokens"].shape[0])
                    for b in (*batches, held)]

    def fmt(xs):
        return "/".join(f"{x:.5f}" for x in xs)
    for dt, lr in LR_RUNS:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(h2o_danube_1_8b.full_config(),
                                  compute_dtype=dt)
        params = tf.init_params(torch.Generator(device=dev).manual_seed(0),
                                cfg)
        opt_cfg = AdamWConfig(lr=lr)
        opt = adamw_init(params, opt_cfg)
        step = make_train_step(partial(tf.loss_fn, cfg=cfg), opt_cfg,
                               num_microbatches=micro, donate=True)
        evals, steps = [losses(params, cfg)], []
        for i in range(4):
            params, opt, m = step(params, opt, batches[i % 2])
            steps.append(f"{float(m['loss']):.5f} (|g| "
                         f"{float(m['grad_norm']):.4f})")
            evals.append(losses(params, cfg))
        chip_smoke.log(
            f"[{chip_smoke.CARD}] lr probe danube {dt} lr {lr:g}, 4 steps "
            f"of {micro} x 1 x {seq} on batches 0,1,0,1: step losses "
            f"{', '.join(steps)}; batch 0 / batch 1 / held-out "
            f"({HELD_OUT} x {seq}) before and after each step: "
            f"{'; '.join(fmt(e) for e in evals)} "
            f"({time.perf_counter() - t0:.1f} s)")
        del params, opt, step
        torch.cuda.empty_cache()
    # the first step's direction: p0 - p1 at lr 1 (without donation)
    cfg = h2o_danube_1_8b.full_config()
    params = tf.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    opt_cfg = AdamWConfig(lr=1.0)
    step = make_train_step(partial(tf.loss_fn, cfg=cfg), opt_cfg,
                           num_microbatches=micro, donate=False)
    moved = step(params, adamw_init(params, opt_cfg), batches[0])[0]
    direction = pytree.tree_map(torch.sub, params, moved)
    del moved
    torch.cuda.empty_cache()
    line = [(0.0, losses(params, cfg)[0])]
    for eta in LINE_SIZES:
        at = pytree.tree_map(lambda p, u: p - eta * u, params, direction)
        line.append((eta, losses(at, cfg)[0]))
        del at
    chip_smoke.log(
        f"[{chip_smoke.CARD}] lr probe danube bf16: batch 0's loss at p0 - "
        f"eta x the first AdamW step's direction on batch 0: "
        f"{', '.join(f'eta {e:g}: {x:.5f}' for e, x in line)}")


def main():
    import torch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    chip_smoke.check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    chip_smoke.CARD = smi.stdout.strip().splitlines()[0]
    chip_smoke.log(f"{chip_smoke.CARD}; torch {torch.__version__}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    if "--lr" in sys.argv:
        torch.backends.cuda.matmul.\
            allow_bf16_reduced_precision_reduction = False
        lr_trajectories()
    if "--gnn" in sys.argv:
        gnn_views_compare()
    chip_smoke.log(f"probe {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
