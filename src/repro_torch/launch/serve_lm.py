"""Serving example: continuous-batched greedy decoding with the ServeEngine
(the port's counterpart of `examples/serve_lm.py`).

    PYTHONPATH=src python -m repro_torch.launch.serve_lm [--device cpu]

h2o-danube-1.8b's smoke config (a reduced sliding-window decoder) with
random weights from generator seed 0, and 10 ragged requests (prompts of
3-11 tokens, 4-11 new tokens, from numpy seed 0) on 4 continuous-batching
slots of 64 positions. Without `--device` it runs on cuda and raises on a
host without a GPU.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import h2o_danube_1_8b
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.serve.engine import Request, ServeEngine

__all__ = ["requests", "run", "main"]


def requests(vocab: int, count: int = 10, seed: int = 0) -> list:
    """The example's ragged requests, drawn as the reference draws them."""
    rng = np.random.default_rng(seed)
    return [Request(rid=i,
                    prompt=rng.integers(0, vocab,
                                        rng.integers(3, 12)).astype(np.int32),
                    max_new_tokens=int(rng.integers(4, 12)))
            for i in range(count)]


def run(device=None, params=None, log=print) -> dict:
    """The example's run on `device` (None = cuda). `params` replaces the
    random weights (a parameter tree of the smoke config, e.g. the
    reference's carried over by `interop.lm_params`). Returns the requests
    (tokens in `out_tokens`) and the engine's stats."""
    dev = resolve_device(device)
    cfg = h2o_danube_1_8b.smoke_config()
    if params is None:
        params = tf.init_params(torch.Generator(device=dev).manual_seed(0),
                                cfg)
    engine = ServeEngine(params, cfg, max_batch=4, max_len=64, device=dev)
    reqs = requests(cfg.vocab)
    log(f"serving {len(reqs)} ragged requests on {engine.max_batch} "
        "continuous-batching slots ...")
    engine.run_until_drained(reqs)
    for r in reqs:
        log(f"req {r.rid}: prompt len {len(r.prompt):2d} -> "
            f"{len(r.out_tokens)} tokens: {r.out_tokens[:8]}")
    log("all requests drained")
    return {"requests": reqs, "stats": engine.stats}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    return run(args.device)


if __name__ == "__main__":
    main()
