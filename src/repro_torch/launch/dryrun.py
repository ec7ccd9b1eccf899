"""The dry-run of every (architecture x input shape) cell (port of
`repro.launch.dryrun`): memory, FLOPs, bytes, collectives and the roofline
of one step, one JSON record per cell.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh production \\
        --arch dlrm-rm2 --shape train_batch
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh card \\
        --arch pna --shape molecule
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh card --all \\
        --out dryrun.jsonl

The flags are the reference's (`--arch --shape --all --multi-pod
--both-meshes --out --skip-done`) plus `--mesh` and `--device` (card
only):

  production  (default) the reference's (16, 16) or (2, 16, 16) mesh, on
              a fake world of 256 or 512 ranks in this one process
              (`launch.mesh.make_production_mesh(fake=True)`), as the
              reference compiles for 512 placeholder devices: rank 0's
              program runs once on meta tensors, allocating nothing. Its
              arguments are rank 0's pieces of the plan's under its
              specs (`sharding.shard_tree`; their bytes are
              `per_device_bytes`), the models run sharded
              (`use_mesh(mesh, sharded=True)`), and the step is counted
              by `launch/analysis.py` with its allocations tracked: the
              record's memory (argument, stated and counted output, peak
              temp, alias bytes, and whether arguments, outputs and the
              peak fit the card's 85,017,493,504 bytes), cost,
              collectives by kind and by mesh axis, and the roofline at
              256 or 512 chips with the H100's rates. As the reference,
              a plan whose cost model names more than two layers or one
              microbatch takes its FLOPs, bytes and collectives from
              counted steps of its reduced probes (`_probe_counts`), and
              its peak temp bytes from a fit linear in the layers, which
              the record marks as estimated; where the sharded step would
              run fewer microbatches than the model names
              (`_probes_hold`), the whole step is counted. Every cell
              runs but those the cell itself skips: the GNN steps with
              their batch over every axis (partitioned message passing,
              `models/gnn/common.py`), the cpaa steps on rank-local
              vectors (`core.distributed.cpaa_local_1d` / `_2d`).
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
the reference; it is never a skip. On the card the plans' `cost_model`
is not used: a counted eager run sees every trip of every loop.
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
from repro_torch.distributed.sharding import P, shard_shape, shard_tree, \
    use_mesh
from repro_torch.kernels import launch_counts
from repro_torch.launch.analysis import count_step, roofline_terms
from repro_torch.launch.mesh import CARD_BYTES, PRODUCTION_SHAPES, \
    make_production_mesh, production_ranks

__all__ = ["MESHES", "plan_cell", "run_cell", "run_plan", "run_production",
           "card_name", "per_device_bytes", "main"]

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
    (the cell's own reason, or a card it does not fit) or "fits" (plan
    then not None)."""
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
        return {**rec, "status": "fits", "chips": production_ranks(multi_pod),
                "memory": {"argument_bytes": per_device_bytes(plan,
                                                              multi_pod),
                           "device_bytes": CARD_BYTES}}, plan
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
    if mesh == "production":
        return run_production(plan, rec, multi_pod, verbose)
    return run_plan(plan, rec, device, verbose, timed)


def _count_production(plan, multi_pod: bool, rank: int) -> dict:
    """One counted step of `plan` as rank `rank` of the production mesh on
    a fake world: {"args", "alias", "out", "stated", "peak", "cost",
    "coll", "by_axis", "kernels", "s"}. The fake world is torn down
    after it."""
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu",
                                fake=True, rank=rank)
    try:
        with use_mesh(mesh, sharded=True):
            args = plan.local_args(mesh)
            sizes = _arg_bytes(plan, args, mesh)
            step = plan.step or plan.static["step_builder"](mesh)
            mem: dict = {}
            t0 = time.perf_counter()
            out, cost, coll, kernels = count_step(step, *args, memory=mem)
            secs = time.perf_counter() - t0
            kept = {x.untyped_storage()._cdata
                    for x in pytree.tree_leaves(args)
                    if isinstance(x, torch.Tensor)}
            out_bytes = sum(x.numel() * x.element_size()
                            for x in pytree.tree_leaves(out)
                            if isinstance(x, torch.Tensor)
                            and x.untyped_storage()._cdata not in kept)
            del out
    finally:
        dist.destroy_world()
    return {**sizes, "out": out_bytes, "peak": mem["peak_bytes"],
            "cost": cost, "coll": coll, "by_axis": mem["by_axis"],
            "kernels": kernels, "s": secs}


def _arg_bytes(plan, args, mesh) -> dict:
    """{"args", "alias", "stated"}: the bytes of this rank's arguments,
    of the donated ones, and of the outputs the plan states (None where
    it states none or no spec for them)."""
    stated = plan.static.get("out_abstract")
    return {"args": _nbytes(args),
            "alias": sum(_nbytes(args[i]) for i in plan.donate),
            "stated": None if stated is None or plan.out_specs is None
            else _nbytes(shard_tree(stated, plan.out_specs, mesh))}


def _probe_counts(plan, multi_pod: bool, rank: int) -> tuple[dict, dict]:
    """The reference's cost model (`DryRunPlan.cost_model`, its
    `_extrapolate`): counted steps of the plan's probes at (L, M) = (1, 1),
    (2, 1) and, with microbatches, (1, 2), fitted to a + M b + M L c and
    evaluated at the plan's L and M, for the FLOPs, bytes, collective
    bytes and counts; the peak temp bytes linear in L. Returns (the
    extrapolated counts in `_count_production`'s keys, {"L", "M",
    "probe_s"})."""
    cm = plan.cost_model
    big_l, big_m = cm["L"], cm["M"]
    runs = {lm: _count_production(cm["probe"](*lm), multi_pod, rank)
            for lm in ([(1, 1), (2, 1)] + ([(1, 2)] if big_m > 1 else []))}

    def fit(get):
        f11, f21 = get(runs[(1, 1)]), get(runs[(2, 1)])
        c = f21 - f11
        b = get(runs[(1, 2)]) - f11 - c if big_m > 1 else 0.0
        return max(f11 - b - c + big_m * b + big_m * big_l * c, 0.0)

    coll = {k: fit(lambda r, k=k: float(r["coll"][k]))
            for k in runs[(1, 1)]["coll"]}
    axes = {(a, k) for r in runs.values() for a, per in r["by_axis"].items()
            for k in per}
    by_axis: dict = {}
    for a, k in sorted(axes):
        by_axis.setdefault(a, {})[k] = fit(
            lambda r, a=a, k=k: float(r["by_axis"].get(a, {}).get(k, 0)))
    # the microbatches run one after another, so the peak does not add
    # up over M: linear in L, plus the accumulators when M > 1
    p11, p21 = runs[(1, 1)]["peak"], runs[(2, 1)]["peak"]
    peak = p11 + (big_l - 1) * (p21 - p11) + \
        (runs[(1, 2)]["peak"] - p11 if big_m > 1 else 0)
    out = {"cost": {"flops": fit(lambda r: r["cost"]["flops"]),
                    "bytes accessed": fit(
                        lambda r: r["cost"]["bytes accessed"])},
           "coll": coll, "by_axis": by_axis, "peak": int(peak),
           "kernels": runs[(1, 1)]["kernels"]}
    return out, {"L": big_l, "M": big_m,
                 "probe_s": round(sum(r["s"] for r in runs.values()), 3)}


def _local_rows(plan, multi_pod: bool) -> int:
    """Rows of the plan's batch (its last argument, whose first leaf's
    rows a train step splits into microbatches) that one rank of the
    production mesh holds under the batch's spec."""
    shape, names = PRODUCTION_SHAPES[multi_pod]
    dims, _, spec = _spec_leaves(plan.abstract_args[-1],
                                 plan.in_specs[-1])[0]
    return shard_shape(dims, spec, dict(zip(names, shape)))[0]


def _probes_hold(plan, multi_pod: bool) -> bool:
    """Whether the reference's model a + M b + M L c, and the peak linear
    in L, fit the sharded step. The peak grows with L where each layer
    keeps its activations for a backward: a train step does, a solve
    built per mesh (`static["step_builder"]`, cpaa) does not (its rounds
    keep the same vectors live, so the fit made its 2D peaks 3.7x too
    high); its whole step is counted, in hundredths of a second. A rank
    holding fewer rows than microbatches runs one microbatch a row
    (`make_train_step`), fewer than the model names, so the plan and its
    probe of two microbatches must each hold at least as many rows per
    rank as they name microbatches (qwen3's train_4k, 16 microbatches of
    16 rows, on the 32 batch ranks of two pods does not)."""
    cm = plan.cost_model
    if "step_builder" in plan.static:
        return False
    if cm["M"] == 1:
        return True
    return _local_rows(plan, multi_pod) >= cm["M"] and \
        _local_rows(cm["probe"](1, 2), multi_pod) >= 2


def run_production(plan, rec: dict, multi_pod: bool, verbose: bool = True,
                   rank: int = 0) -> dict:
    """Rank `rank`'s step of `plan` on the production mesh of a fake world
    (module docstring), counted on meta tensors; `rec` updated into an
    "ok" record. The argument, alias and output bytes are always the full
    plan's. A plan whose cost model names more than two layers or one
    microbatch, and whose probes hold (`_probes_hold`), takes its FLOPs,
    bytes and collectives from the reference's extrapolation from reduced
    probes and its peak temp bytes from a fit linear in L
    (`_probe_counts`), as the reference does, instead of a count of the
    whole step (minutes on meta tensors for a deep model). The record's
    "cost_from" says which; `memory.peak_estimated` marks an
    extrapolated peak, and with it the peak's fit (PERF.md compares it
    with a whole count)."""
    chips = production_ranks(multi_pod)
    cm = plan.cost_model
    if cm and (cm["L"] > 2 or cm["M"] > 1) and \
            _probes_hold(plan, multi_pod):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu",
                                    fake=True, rank=rank)
        try:
            base = _arg_bytes(plan, plan.local_args(mesh), mesh)
        finally:
            dist.destroy_world()
        counted, how = _probe_counts(plan, multi_pod, rank)
        run = {**base, "out": base["stated"] or 0, **counted}
        rec["cost_from"] = {"probes": how}
        rec["count_s"] = how["probe_s"]
    else:
        run = _count_production(plan, multi_pod, rank)
        rec["cost_from"] = "counted step"
        rec["count_s"] = round(run["s"], 3)
    arg_bytes, out_bytes, temp = run["args"], run["out"], run["peak"]
    alias, stated_bytes = run["alias"], run["stated"]
    cost, coll, kernels = run["cost"], run["coll"], run["kernels"]
    by_axis = run["by_axis"]
    peak = arg_bytes + temp
    roof = roofline_terms(cost, coll, chips, plan.model_flops,
                          plan.static.get("compute_dtype", "bfloat16"))
    rec.update({
        "status": "ok", "device": "meta (fake world)",
        "memory": {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                   "stated_output_bytes": stated_bytes,
                   "temp_bytes": temp, "alias_bytes": alias,
                   "peak_per_device": peak,
                   "peak_estimated": rec["cost_from"] != "counted step",
                   "device_bytes": CARD_BYTES,
                   "fits": {"arguments": arg_bytes <= CARD_BYTES,
                            "outputs": arg_bytes + out_bytes <= CARD_BYTES,
                            "peak": peak <= CARD_BYTES}},
        "cost": {"flops": cost["flops"],
                 "bytes_accessed": cost["bytes accessed"]},
        "collectives": coll,
        "collectives_by_axis": by_axis,
        "kernels": kernels,
        "roofline": roof.to_dict(),
    })
    if verbose:
        fit = ("fits" if rec["memory"]["fits"]["peak"] else
               "DOES NOT FIT") + (", estimated" if
                                  rec["memory"]["peak_estimated"] else "")
        print(f"[{rec.get('arch')} x {rec.get('shape')} | production "
              f"{chips}] OK args/dev={arg_bytes / 2**30:.3f}GiB "
              f"peak/dev={peak / 2**30:.3f}GiB ({fit}) "
              f"dominant={roof.dominant} terms(ms)=C"
              f"{roof.compute_s * 1e3:.3f}/M{roof.memory_s * 1e3:.3f}/N"
              f"{roof.collective_s * 1e3:.3f} count={rec['count_s']}s",
              flush=True)
    return rec


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
        before = launch_counts()
        out, cost, coll, kernels = count_step(step, *args)
        _sync(dev)
        rec["launches"] = {k: v - before[k]
                           for k, v in launch_counts().items()}
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
