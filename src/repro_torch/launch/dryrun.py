"""The dry-run of every (architecture x input shape) cell (port of
`repro.launch.dryrun`): memory, FLOPs, bytes, collectives and the roofline
of one step, one JSON record per cell.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh card \\
        --arch pna --shape molecule
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh card --all \\
        --out dryrun.jsonl

The flags are the reference's (`--arch --shape --all --multi-pod
--both-meshes --out --skip-done`) plus `--mesh` and `--device`:

  production  (default) the reference's (16, 16) or (2, 16, 16) mesh. The
              port's models run no tensor or FSDP parallelism, so a cell
              is recorded as skipped, its reason naming the mesh it needs
              and this world's size; the record still carries the
              per-device argument bytes of the plan's specs
              (`distributed.sharding.shard_shape`).
  card        the (1, 1) ("data", "model") mesh of one rank: build the
              plan on meta tensors; skip the cell, naming both byte
              counts, when its arguments, the outputs the plan states
              and the buffers it cannot run without (a train step's
              gradients) need more than the device's memory; else
              materialise the
              arguments (`static["make_args"](seed=0)`), run one warm-up
              step, one step counted by `launch/analysis.py` (with the
              kernels' launch counters and the collective counters), and
              three steps timed with CUDA events (median and spread).

A record keeps the reference's keys (`memory`, `cost`, `collectives`,
`roofline`, `note`) and adds `mesh`, `chips`, `device` (the card's name
and power limit from nvidia-smi), `step_ms` and `launches` (per kernel,
in the counted step). `memory.peak_per_device` is the peak allocated
over the timed steps, `temp_bytes` the peak less the arguments,
`alias_bytes` the donated arguments'. An out-of-memory or any other
exception records `"status": "error"` and makes the exit code 1, as in
the reference; it is never a skip. The plans' `cost_model` is not used:
a counted eager run sees every trip of every loop.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
import traceback

import torch
from torch.utils import _pytree as pytree

from repro_torch.configs.registry import all_cells, get
from repro_torch.core import distributed as dist
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import P, shard_shape, use_mesh
from repro_torch.launch.analysis import count_step, roofline_terms
from repro_torch.launch.mesh import PRODUCTION_SHAPES, production_ranks

__all__ = ["MESHES", "plan_cell", "run_cell", "run_plan", "card_name",
           "per_device_bytes", "main"]

MESHES = ("production", "card")
TIMED_STEPS = 3


def card_name(dev: torch.device) -> str:
    """nvidia-smi's "name, power.limit" of the card `dev` is on, or the
    device type for a CPU."""
    if dev.type != "cuda":
        return dev.type
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    lines = smi.stdout.strip().splitlines()
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if smi.returncode != 0 or idx >= len(lines):
        return torch.cuda.get_device_name(dev)
    return lines[idx].strip()


def device_bytes(dev: torch.device) -> int | None:
    """The card's memory in bytes, or None for a CPU (no limit checked)."""
    if dev.type != "cuda":
        return None
    return torch.cuda.get_device_properties(dev).total_memory


def _nbytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in pytree.tree_leaves(tree)
               if isinstance(x, torch.Tensor))


def _spec_leaves(args, specs) -> list:
    """[(shape, itemsize, spec)] pairing each abstract leaf with its spec."""
    if isinstance(specs, P):
        return [(tuple(args.shape), args.element_size(), specs)]
    if isinstance(args, dict):
        return [x for k in args for x in _spec_leaves(args[k], specs[k])]
    if isinstance(args, (list, tuple)):
        return [x for a, s in zip(args, specs) for x in _spec_leaves(a, s)]
    raise TypeError(f"no spec for {type(args)}")


def per_device_bytes(plan, multi_pod: bool) -> int:
    """Argument bytes one device of the production mesh holds under the
    plan's specs."""
    shape, names = PRODUCTION_SHAPES[multi_pod]
    sizes = dict(zip(names, shape))
    total = 0
    for dims, item, spec in _spec_leaves(plan.abstract_args, plan.in_specs):
        n = 1
        for d in shard_shape(dims, spec, sizes):
            n *= d
        total += n * item
    return total


def _base(arch, shape, multi_pod, mesh, kind) -> dict:
    return {"arch": arch, "shape": shape, "multi_pod": multi_pod,
            "mesh": mesh, "kind": kind}


def plan_cell(arch: str, shape: str, multi_pod: bool = False,
              mesh: str = "production", device=None) -> tuple:
    """(record, plan): the cell's plan on meta tensors and what the mesh
    makes of it before anything runs. The record's status is "skipped"
    (the cell's own reason, a production mesh this world lacks, or a card
    it does not fit) or "fits" (card only; plan then not None).

    Raises:
        NotImplementedError: the world holds the production mesh's ranks
            (the port cannot run a cell sharded over them).
    """
    if mesh not in MESHES:
        raise ValueError(f"mesh {mesh!r}: one of {MESHES}")
    mod = get(arch)
    cell = next(c for c in mod.cells() if c.shape == shape)
    rec = _base(arch, shape, multi_pod, mesh, cell.kind)
    if cell.skip_reason:
        return {**rec, "status": "skipped", "reason": cell.skip_reason}, None
    t0 = time.perf_counter()
    plan = mod.build(shape, multi_pod)
    rec["build_s"] = round(time.perf_counter() - t0, 3)
    rec["note"] = plan.note
    args_bytes = _nbytes(plan.abstract_args)
    out_bytes = _nbytes(plan.static.get("out_abstract"))
    temp_bytes = _nbytes(plan.static.get("temp_abstract"))
    if mesh == "production":
        pshape, _ = PRODUCTION_SHAPES[multi_pod]
        need = production_ranks(multi_pod)
        world = dist.world_size()
        if world == need:
            raise NotImplementedError(
                f"{arch} x {shape}: the production mesh {pshape} has its "
                f"{need} ranks, but the port's models run no tensor or FSDP "
                f"parallelism")
        reason = (f"needs the production mesh {pshape} of {need} ranks; "
                  f"this world has {world}")
        return {**rec, "status": "skipped", "chips": need, "reason": reason,
                "memory": {"argument_bytes": per_device_bytes(plan,
                                                              multi_pod)}}, \
            plan
    dev = resolve_device(device)
    rec.update(chips=1, memory={"argument_bytes": args_bytes,
                                "stated_output_bytes": out_bytes,
                                "stated_temp_bytes": temp_bytes})
    total = device_bytes(dev)
    need = args_bytes + out_bytes + temp_bytes
    if total is not None:
        rec["memory"]["device_bytes"] = total
        if need > total:
            return {**rec, "status": "skipped", "reason": (
                f"does not fit one card: {need:,} bytes of arguments, "
                f"stated outputs and buffers; the card holds "
                f"{total:,}")}, plan
    return {**rec, "status": "fits"}, plan


def _storages(tree) -> set:
    return {x.untyped_storage().data_ptr() for x in pytree.tree_leaves(tree)
            if isinstance(x, torch.Tensor)}


def _launches() -> dict:
    from repro_torch.kernels.bsr_spmm import ops as bsr
    from repro_torch.kernels.cheb_step import ops as cheb
    from repro_torch.kernels.embedding_bag import ops as eb
    return {"bsr_spmm": bsr.launches(), "cheb_step": cheb.launches(),
            "embedding_bag": eb.launches(),
            "embedding_bag_backward": eb.backward_launches()}


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _time_steps(step, args, dev, n: int) -> list:
    """Milliseconds of each of n calls (CUDA events on a card, the host
    clock on a CPU)."""
    out = []
    for _ in range(n):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            step(*args)
            stop.record()
            torch.cuda.synchronize(dev)
            out.append(start.elapsed_time(stop))
        else:
            t0 = time.perf_counter()
            step(*args)
            out.append((time.perf_counter() - t0) * 1e3)
    return out


def run_cell(arch: str, shape: str, multi_pod: bool = False,
             mesh: str = "production", device=None, verbose: bool = True,
             timed: int = TIMED_STEPS) -> dict:
    """One cell's record (see the module docstring); device None = cuda.

    Raises:
        whatever the plan or the step raises (`main` records it as an
        error).
    """
    rec, plan = plan_cell(arch, shape, multi_pod, mesh, device)
    if rec["status"] != "fits":
        if verbose:
            print(f"[{arch} x {shape} | {mesh}] SKIP: {rec['reason']}",
                  flush=True)
        return rec
    return run_plan(plan, rec, device, verbose, timed)


def run_plan(plan, rec: dict, device=None, verbose: bool = True,
             timed: int = TIMED_STEPS) -> dict:
    """Run `plan` on the (1, 1) mesh of `device` (None = cuda): make its
    arguments, one warm-up step, one counted step, `timed` timed steps;
    `rec` (the cell's fields so far) updated into an "ok" record."""
    dev = resolve_device(device)
    rec = {**rec, "device": card_name(dev)}
    rec.setdefault("memory", {})
    rec.setdefault("chips", 1)
    grid = dist.init_mesh((1, 1), ("data", "model"), dev)
    with use_mesh(grid):
        step = plan.step or plan.static["step_builder"](grid)
        t0 = time.perf_counter()
        args = plan.static["make_args"](seed=0, device=dev)
        _sync(dev)
        rec["args_s"] = round(time.perf_counter() - t0, 3)
        arg_bytes = _nbytes(args)
        alias = sum(_nbytes(args[i]) for i in plan.donate)
        out = step(*args)                       # warm-up
        _sync(dev)
        del out
        before = _launches()
        out, cost, coll, kernels = count_step(step, *args)
        _sync(dev)
        rec["launches"] = {k: v - before[k] for k, v in _launches().items()}
        kept = _storages(args)
        out_bytes = sum(x.numel() * x.element_size()
                        for x in pytree.tree_leaves(out)
                        if isinstance(x, torch.Tensor)
                        and x.untyped_storage().data_ptr() not in kept)
        del out
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        ms = _time_steps(step, args, dev, timed)
        peak = torch.cuda.max_memory_allocated(dev) \
            if dev.type == "cuda" else None
    roof = roofline_terms(cost, coll, 1, plan.model_flops,
                          plan.static.get("compute_dtype", "bfloat16"))
    rec.update({
        "status": "ok",
        "memory": {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                   "temp_bytes": None if peak is None else peak - arg_bytes,
                   "alias_bytes": alias, "peak_per_device": peak,
                   "device_bytes": rec["memory"].get("device_bytes")},
        "cost": {"flops": cost["flops"],
                 "bytes_accessed": cost["bytes accessed"]},
        "collectives": coll,
        "kernels": kernels,
        "roofline": roof.to_dict(),
        "step_ms": {"median": statistics.median(ms), "min": min(ms),
                    "max": max(ms), "all": ms},
    })
    if verbose:
        peak_s = "n/a" if peak is None else f"{peak / 2**20:.0f}MiB"
        med = rec["step_ms"]["median"]
        print(f"[{rec.get('arch')} x {rec.get('shape')} | card] OK "
              f"step={med:.3f}ms peak/dev={peak_s} dominant={roof.dominant} "
              f"terms(ms)=C{roof.compute_s * 1e3:.3f}/M"
              f"{roof.memory_s * 1e3:.3f}/N{roof.collective_s * 1e3:.3f} "
              f"launches={ {k: v for k, v in rec['launches'].items() if v} }",
              flush=True)
    return rec


# Cheapest cells first so partial runs produce useful coverage.
_COST_ORDER = {
    "pna": 0, "meshgraphnet": 1, "dlrm-rm2": 2, "dimenet": 3, "graphcast": 4,
    "cpaa-pagerank": 5, "h2o-danube-1.8b": 6, "deepseek-7b": 7,
    "granite-moe-3b-a800m": 8, "qwen2.5-32b": 9, "qwen3-moe-235b-a22b": 10,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--skip-done", action="store_true",
                    help="skip cells already present in --out")
    ap.add_argument("--mesh", choices=MESHES, default="production")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.all:
        cells = sorted(all_cells(),
                       key=lambda ac: (_COST_ORDER.get(ac[0], 99),
                                       ac[1].shape))
        jobs = []
        meshes = [False, True] if args.both_meshes else [args.multi_pod]
        for mp in meshes:
            jobs += [(a, c.shape, mp) for a, c in cells]
    else:
        jobs = [(args.arch, args.shape, args.multi_pod)]
        if args.both_meshes:
            jobs.append((args.arch, args.shape, True))

    done = set()
    if args.out and args.skip_done and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    if r.get("status") in ("ok", "skipped"):
                        done.add((r["arch"], r["shape"], r["multi_pod"],
                                  r.get("mesh", "production")))
                except json.JSONDecodeError:
                    pass

    n_fail = 0
    out_f = open(args.out, "a") if args.out else None
    for arch, shape, mp in jobs:
        if (arch, shape, mp, args.mesh) in done:
            continue
        try:
            rec = run_cell(arch, shape, mp, args.mesh, args.device)
        except Exception as e:  # noqa: BLE001 - record and continue
            traceback.print_exc()
            rec = {"arch": arch, "shape": shape, "multi_pod": mp,
                   "mesh": args.mesh, "status": "error",
                   "error": repr(e)[:500]}
            n_fail += 1
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        if out_f:
            out_f.write(json.dumps(rec) + "\n")
            out_f.flush()
    if out_f:
        out_f.close()
    print(f"dry-run finished, failures: {n_fail}", flush=True)
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
