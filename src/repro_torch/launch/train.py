"""Training launcher of the port (counterpart of `repro.launch.train`):
trains an LM arch on the synthetic token stream.

    PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-7b \\
        --smoke --steps 50 --ckpt-dir /tmp/run1 [--device cuda|cpu]

The flags are the reference's (plus `--device`); `--arch` resolves
through `configs.registry.get`, which raises KeyError for a name it does
not know. Parameters come from
generator seed 0 (`--smoke`: the arch's reduced config, else its full
config), AdamW (`--lr`) takes one step per batch of `--global-batch`
sequences of `--seq-len` + 1 tokens (`token_batch`, deterministic in the
step), one microbatch per step. The reference builds a TPU mesh here
(`make_elastic_mesh`); on one card the launcher prints the device
instead. The step updates the state in place (donate=True): the same
numbers as the reference's donate=False, without a second copy of the
parameters and moments on the card.

With `--ckpt-dir`, the state is saved asynchronously every `--ckpt-every`
steps and once at the end (metadata data_step = the step just taken),
the newest 3 are kept, and a later run pointed at the same directory
resumes from the latest at data_step + 1 and prints "resumed from step".
`--straggler-deadline-s` logs steps slower than that wall time. Other
families exit with the reference's message. The device defaults to cuda.
"""
from __future__ import annotations

import argparse
import time
from functools import partial

import torch

from repro_torch.configs.registry import get
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.data import TokenPipelineConfig, token_batch
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.train_loop import make_train_step

__all__ = ["main"]


def main(argv=None) -> dict:
    """Run the launcher; returns {'device', 'start_step', 'losses',
    'step_s', 'params', 'opt'} for callers that drive it in-process."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    help="an arch of configs/registry.py")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=32)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--straggler-deadline-s", type=float, default=None,
                    help="log steps exceeding this wall-time")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    mod = get(args.arch)
    if mod.FAMILY != "lm":
        raise SystemExit("launch.train drives LM archs; use "
                         "repro_torch.launch.train_gnn for the GNN family")
    cfg = mod.smoke_config() if args.smoke else mod.full_config()
    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "host"
    print(f"device: {dev} ({name})")

    opt_cfg = AdamWConfig(lr=args.lr)
    start_step = 0
    params = tf.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    opt = adamw_init(params, opt_cfg)
    if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        restored, meta = ckpt.restore(args.ckpt_dir,
                                      {"params": params, "opt": opt})
        params, opt = restored["params"], restored["opt"]
        start_step = meta["data_step"] + 1
        print(f"resumed from step {start_step - 1}")

    step = make_train_step(partial(tf.loss_fn, cfg=cfg), opt_cfg,
                           num_microbatches=1, donate=True)
    dcfg = TokenPipelineConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                               global_batch=args.global_batch)
    pending, losses, step_s = None, [], []
    for i in range(start_step, start_step + args.steps):
        t0 = time.perf_counter()
        params, opt, metrics = step(params, opt, token_batch(dcfg, i, dev))
        losses.append(float(metrics["loss"]))      # waits for the step
        dt = time.perf_counter() - t0
        step_s.append(dt)
        if args.straggler_deadline_s and dt > args.straggler_deadline_s:
            print(f"[straggler] step {i} took {dt:.2f}s > deadline")
        if i % 10 == 0:
            print(f"step {i:5d}  loss {losses[-1]:.4f}  {dt * 1e3:.0f}ms")
        if args.ckpt_dir and i and i % args.ckpt_every == 0:
            if pending:
                pending.join()
            pending = ckpt.save(args.ckpt_dir, i,
                                {"params": params, "opt": opt},
                                metadata={"data_step": i}, async_=True)
    if pending:
        pending.join()
    if args.ckpt_dir:
        ckpt.save(args.ckpt_dir, start_step + args.steps - 1,
                  {"params": params, "opt": opt},
                  metadata={"data_step": start_step + args.steps - 1})
        ckpt.prune(args.ckpt_dir, keep=3)
    print("done")
    return {"device": str(dev), "start_step": start_step, "losses": losses,
            "step_s": step_s, "params": params, "opt": opt}


if __name__ == "__main__":
    main()
