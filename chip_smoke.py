#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`src/repro_torch`).

    python3 chip_smoke.py

Needs one CUDA card (an H100 is what it was written for) and the CUDA
toolkit (nvcc). Drives the port only; it imports neither jax nor the JAX
package. Phases, each of which must pass:

  1. device: the card's name and power limit (nvidia-smi), then one
     parallel nvcc build of every kernel from the sources in this checkout;
  2. kernels vs their plain PyTorch versions on the card: bsr_spmm at
     B = 128, BT in {1, 8, 128} on a random tiling (rtol/atol 1e-5) and
     cheb_step on [n] and [n, B] at ragged sizes (rtol 1e-6);
  3. slice A: the PPR service at `full_config()` with engine "auto"
     (naca must land on the fused block-ELL engine, kmer on COO), 256
     seeded queries + 10% repeats, answers checked against a float64
     scipy solve of (I - cP) x = (1 - c) p;
  4. slice B: the service on NACA0015 at the paper's size (n = 1,040,000)
     with engine "fused", 128 queries + 13 repeats; bsr_spmm vs plain on
     that tiling; the kernel solve of the tick's personalization matrix vs
     the same solve through the plain versions (L1 <= 1e-5 per column);
     CUDA-event times of the tick and of each kernel beside its bound, its
     plain version and a library yardstick.

Each main path runs with the kernels' launch counters set to 0 just
before and read just after; a kernel of the path that was not launched
fails the run. The line before the last is the kernel table as JSON; the
last line is {"ok": true, "device": {...}}. Any failed phase exits
non-zero without that line.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOP_PER_S = 67e12        # H100 SXM FP32, non-tensor (data sheet)


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds per call of `fn` over `reps` calls, between CUDA
    events, after `warmup` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def reset_counts():
    from repro_torch.core import engine
    from repro_torch.kernels.bsr_spmm import ops as bsr_ops
    from repro_torch.kernels.cheb_step import ops as cheb_ops
    bsr_ops.reset_launches()
    cheb_ops.reset_launches()
    engine.reset_apply_counts()


def read_counts() -> dict:
    from repro_torch.core import engine
    from repro_torch.kernels.bsr_spmm import ops as bsr_ops
    from repro_torch.kernels.cheb_step import ops as cheb_ops
    return {"bsr_spmm": bsr_ops.launches(), "cheb_step": cheb_ops.launches(),
            "applies": engine.apply_counts()}


# ---------------------------------------------------------------- phase 1 --
def phase_device():
    import torch
    from repro_torch.kernels import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    log(smi.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in f32
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    secs = _build.build_all()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s wall "
        f"({', '.join(f'{k} {v:.2f} s' for k, v in secs.items())})")
    for name in _build.sources():
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    check(set(secs) == set(_build.sources()), "not every kernel was built")


# ---------------------------------------------------------------- phase 2 --
def compare_bsr(block_cols, values, bts, seed: int) -> dict:
    """bsr_spmm kernel vs plain on the card; returns {bt: max_abs_err}."""
    import torch
    from repro_torch.kernels.bsr_spmm.ops import bsr_spmm
    from repro_torch.kernels.bsr_spmm.ref import bsr_spmm_ref
    n = values.shape[0] * values.shape[2]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    errs = {}
    for bt in bts:
        x = torch.randn(n, bt, device="cuda", generator=gen)
        y = bsr_spmm(block_cols, values, x)
        torch.cuda.synchronize()
        ref = bsr_spmm_ref(block_cols, values, x)
        torch.cuda.synchronize()
        err = float((y - ref).abs().max())
        check(torch.allclose(y, ref, rtol=1e-5, atol=1e-5),
              f"bsr_spmm BT={bt}: kernel vs plain max |err| {err:.3e}")
        errs[bt] = err
        del x, y, ref
    return errs


def phase_kernels() -> dict:
    import torch
    from repro_torch.kernels.cheb_step.ops import cheb_step
    from repro_torch.kernels.cheb_step.ref import cheb_step_ref
    gen = torch.Generator(device="cuda").manual_seed(0)
    n_rb, slots, blk = 96, 8, 128
    block_cols = torch.randint(0, n_rb, (n_rb, slots), device="cuda",
                               dtype=torch.int32, generator=gen)
    mask = torch.rand(n_rb, slots, blk, blk, device="cuda",
                      generator=gen) < 0.05
    values = torch.rand(n_rb, slots, blk, blk, device="cuda",
                        generator=gen) * mask / 8.0
    errs = compare_bsr(block_cols, values, (1, 8, 128), seed=1)
    log("bsr_spmm random tiling (96 row blocks, S=8) max |kernel - plain|: "
        + ", ".join(f"BT={k} {v:.3e}" for k, v in errs.items()))
    worst = max(errs.values())
    cheb_err = 0.0
    for shape in [(64,), (1000,), (10_001,), (64, 3), (10_001, 128),
                  (1_040_000, 128)]:
        y, t, acc = (torch.randn(shape, device="cuda", generator=gen)
                     for _ in range(3))
        ck = torch.tensor(0.5567, device="cuda")
        tk, ak = cheb_step(y, t, acc, ck)
        torch.cuda.synchronize()
        tr, ar = cheb_step_ref(y, t, acc, ck)
        check(torch.allclose(tk, tr, rtol=1e-6, atol=0) and
              torch.allclose(ak, ar, rtol=1e-6, atol=0),
              f"cheb_step {shape}: kernel vs plain disagree")
        cheb_err = max(cheb_err, float((tk - tr).abs().max()),
                       float((ak - ar).abs().max()))
        del y, t, acc, tk, ak, tr, ar
    log(f"cheb_step [n] and [n,B] up to 1,040,000x128: max |kernel - plain| "
        f"{cheb_err:.3e}")
    return {"bsr_spmm": worst, "cheb_step": cheb_err}


# ------------------------------------------------------------- the service --
def seeded_queries(svc, count: int, seed: int, top_k: int):
    """`count` distinct seeded queries over the registry's graphs."""
    from repro_torch.serve.pagerank_service import PPRQuery
    rng = np.random.default_rng(seed)
    names = svc.registry.names()
    seen, out = set(), []
    while len(out) < count:
        name = names[int(rng.integers(0, len(names)))]
        n = svc.registry.get(name).n
        seeds = tuple(sorted(int(s) for s in rng.choice(
            n, int(rng.integers(1, 4)), replace=False)))
        if (name, seeds) in seen:
            continue
        seen.add((name, seeds))
        out.append(PPRQuery(qid=len(out), graph=name, seeds=seeds, top_k=top_k))
    return out


def repeats_of(queries, count: int):
    from repro_torch.serve.pagerank_service import PPRQuery
    base = len(queries)
    return [PPRQuery(qid=base + j, graph=q.graph, seeds=q.seeds, c=q.c,
                     tol=q.tol, top_k=q.top_k)
            for j, q in enumerate(queries[:count])]


def drive(svc, queries, repeats):
    """Submit, drain, submit repeats, drain; returns (results, stats,
    seconds of each drain)."""
    import torch
    results = {}
    t0 = time.perf_counter()
    for q in queries:
        svc.submit(q)
    results.update(svc.run_until_drained())
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for q in repeats:
        svc.submit(q)
    results.update(svc.run_until_drained())
    t2 = time.perf_counter()
    return results, svc.stats, (t1 - t0, t2 - t1)


def check_accounting(st: dict, n_repeats: int, label: str) -> None:
    check(st["queries"] == st["cache_hits"] + st["solved_queries"]
          + st["dropped_queries"], f"{label}: disposition accounting broken")
    check(st["cache_hits"] == n_repeats,
          f"{label}: {st['cache_hits']} cache hits for {n_repeats} repeats")
    check(st["rounds_used"] <= st["rounds_bound"],
          f"{label}: rounds used {st['rounds_used']} > bound "
          f"{st['rounds_bound']}")


def oracle_check(svc, results, queries, c: float, tol: float,
                 per_graph: int) -> float:
    """Max |service score - float64 solve| over `per_graph` queries per
    graph: x = (1 - c) (I - cP)^{-1} p with p uniform over the seeds."""
    import scipy.sparse as sp
    from scipy.sparse.linalg import splu
    worst = 0.0
    for name in svc.registry.names():
        g = svc.registry.get(name).host
        qs = [q for q in queries if q.graph == name][:per_graph]
        deg = np.maximum(g.deg, 1).astype(float)
        P = sp.csc_matrix((1.0 / deg[g.src], (g.dst, g.src)),
                          shape=(g.n, g.n))
        lu = splu(sp.identity(g.n, format="csc") - c * P)
        for q in qs:
            p = np.zeros(g.n)
            p[list(q.seeds)] = 1.0 / len(q.seeds)
            x = (1.0 - c) * lu.solve(p)
            r = results[q.qid]
            err = float(np.max(np.abs(r.scores - x[r.indices])))
            check(err <= 2 * tol, f"{name} q{q.qid}: |service - oracle| "
                  f"{err:.3e} > 2 tol")
            worst = max(worst, err)
    return worst


def phase_slice_a() -> dict:
    import torch
    from repro_torch.configs.pagerank_serve import full_config, make_service
    from repro_torch.core.engine import CooEngine, FusedBlockEllEngine
    cfg = full_config()
    t0 = time.perf_counter()
    svc = make_service(cfg, device="cuda")
    log(f"slice A: full_config() built in {time.perf_counter() - t0:.2f} s")
    engines = {nm: type(svc.registry.get(nm).engine).__name__
               for nm in svc.registry.names()}
    log(f"slice A engines: {engines}")
    check(isinstance(svc.registry.get("naca").engine, FusedBlockEllEngine),
          "slice A: naca is not on FusedBlockEllEngine")
    check(isinstance(svc.registry.get("kmer").engine, CooEngine),
          "slice A: kmer is not on CooEngine")
    queries = seeded_queries(svc, 256, seed=0, top_k=8)
    repeats = repeats_of(queries, len(queries) // 10)
    reset_counts()
    results, st, secs = drive(svc, queries, repeats)
    counts = read_counts()
    log(f"slice A: {len(results)} answers, stats {st}")
    log(f"slice A launches: {counts}; drains {secs[0]:.3f} s + "
        f"{secs[1]:.4f} s")
    check(len(results) == len(queries) + len(repeats),
          "slice A: not every query answered")
    check_accounting(st, len(repeats), "slice A")
    check(counts["bsr_spmm"] > 0 and counts["cheb_step"] > 0,
          f"slice A: a kernel of the path was not launched: {counts}")
    err = oracle_check(svc, results, queries, cfg.c, cfg.tol, per_graph=4)
    log(f"slice A: max |service - float64 oracle| {err:.3e} "
        f"(bound 2 tol = {2 * cfg.tol:.0e})")
    del svc
    torch.cuda.empty_cache()
    return {"launches": counts, "oracle_err": err, "stats": st}


def personalization(svc, queries, b_pad: int):
    """The [n, B] matrix a tick builds for these (distinct) queries."""
    import torch
    n = svc.registry.get(queries[0].graph).n
    p = torch.zeros((n, b_pad), device="cuda")
    for j, q in enumerate(queries):
        p[list(q.seeds), j] = 1.0
    p[:, len(queries):] = 1.0
    return p


def phase_slice_b() -> dict:
    import torch
    from repro_torch.configs.pagerank_serve import PPRServeConfig, \
        make_service
    from repro_torch.core.engine import FusedBlockEllEngine
    from repro_torch.core.pagerank import cpaa_adaptive_fixed
    from repro_torch.kernels.bsr_spmm.ops import bsr_spmm
    from repro_torch.kernels.bsr_spmm.ref import bsr_spmm_ref
    from repro_torch.kernels.cheb_step.ops import cheb_step
    from repro_torch.kernels.cheb_step.ref import cheb_step_ref
    cfg = PPRServeConfig(graphs=(("naca", "NACA0015", 10.0),),
                         engine="fused", max_batch=128, max_top_k=32)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    svc = make_service(cfg, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated()
    rg = svc.registry.get("naca")
    eng = rg.engine
    check(isinstance(eng, FusedBlockEllEngine), "slice B: not fused")
    n_rb, slots, blk, _ = eng.values.shape
    values_bytes = eng.values.numel() * 4
    log(f"slice B: NACA0015 x10 n={rg.n} m={rg.host.m} built in "
        f"{build_s:.2f} s; {n_rb} row blocks x S={slots} tiles of "
        f"{blk}x{blk} f32 = {values_bytes} bytes of values; fill "
        f"{eng.fill_rate:.4f}")

    # kernel vs plain on the paper-size tiling
    errs = compare_bsr(eng.block_cols, eng.values, (1, 8, 128), seed=2)
    log("bsr_spmm paper tiling max |kernel - plain|: "
        + ", ".join(f"BT={k} {v:.3e}" for k, v in errs.items()))

    # the main path: 128 distinct queries (one full tick) + 13 repeats
    queries = seeded_queries(svc, 128, seed=1, top_k=32)
    repeats = repeats_of(queries, 13)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    tick0 = torch.cuda.Event(enable_timing=True)
    tick1 = torch.cuda.Event(enable_timing=True)
    tick0.record()
    results, st, secs = drive(svc, queries, repeats)
    tick1.record()
    torch.cuda.synchronize()
    counts = read_counts()
    tick_ms = tick0.elapsed_time(tick1)
    peak = torch.cuda.max_memory_allocated()   # resident state + the tick
    log(f"slice B: {len(results)} answers, stats {st}")
    log(f"slice B launches: {counts}; tick {secs[0] * 1e3:.1f} ms host, "
        f"{tick_ms:.1f} ms between CUDA events (one tick of 128 columns, "
        f"{st['rounds_used']} rounds of bound {st['rounds_bound']})")
    check(st["ticks"] == 1 and st["solves"] == 1,
          f"slice B: expected one full tick, got {st}")
    check_accounting(st, len(repeats), "slice B")
    check(counts["bsr_spmm"] > 0 and counts["cheb_step"] > 0,
          f"slice B: a kernel of the path was not launched: {counts}")
    for q in queries[:4]:
        r = results[q.qid]
        check(r.indices.shape == (32,) and np.all(np.isfinite(r.scores))
              and np.all(np.diff(r.scores) <= 0),
              f"slice B q{q.qid}: malformed answer")

    # the tick's solve through the kernels vs through the plain versions
    p = personalization(svc, queries, 128)
    plan = svc.registry.adaptive_schedule(cfg.c, cfg.tol)
    pi_k, k_k, cols_k, _ = cpaa_adaptive_fixed(
        eng, p, plan.c, plan.tol, max_rounds=plan.max_rounds,
        chunk=plan.chunk)
    pi_p, k_p, cols_p, _ = cpaa_adaptive_fixed(
        eng.with_kernels(False), p, plan.c, plan.tol,
        max_rounds=plan.max_rounds, chunk=plan.chunk)
    l1 = (pi_k - pi_p).abs().sum(dim=0)
    l1_max = float(l1.max())
    log(f"slice B: kernel vs plain solve of the tick: max column L1 "
        f"{l1_max:.3e}, rounds {k_k} vs {k_p}")
    check(torch.equal(cols_k, cols_p), "slice B: column rounds differ "
          "between kernel and plain solves")
    check(l1_max <= 1e-5, f"slice B: kernel vs plain L1 {l1_max:.3e}")
    check(bool(torch.isfinite(pi_k).all()), "slice B: non-finite pi")
    col_sum = pi_k[:, :len(queries)].sum(dim=0)
    check(bool(((col_sum - 1).abs() < 1e-4).all()), "slice B: pi columns "
          "do not sum to 1")
    del pi_k, pi_p

    # kernel times at the tick's shapes, beside bounds and yardsticks
    x = eng.to_internal(p)
    n_pad, bt = x.shape
    bsr_ms = time_ms(lambda: bsr_spmm(eng.block_cols, eng.values, x), 10)
    plain_ms = time_ms(lambda: bsr_spmm_ref(eng.block_cols, eng.values, x),
                       3)
    vals_p = eng.values.permute(0, 2, 1, 3).reshape(n_rb, blk, slots * blk)
    gathered = x.reshape(n_rb, blk, bt)[eng.block_cols.long()].reshape(
        n_rb, slots * blk, bt)
    lib = torch.bmm(vals_p, gathered).reshape(n_pad, bt)
    check(torch.allclose(lib, bsr_spmm_ref(eng.block_cols, eng.values, x),
                         rtol=1e-5, atol=1e-5), "torch.bmm yardstick wrong")
    lib_ms = time_ms(lambda: torch.bmm(vals_p, gathered), 3)
    del vals_p, gathered, lib
    nnz = int((eng.values != 0).sum())
    bsr_bytes = 4 * (eng.block_cols.numel() + eng.values.numel()
                     + 2 * x.numel())
    bsr_bytes_ms = bsr_bytes / HBM_BYTES_PER_S * 1e3
    bsr_ops_ms = 2.0 * nnz * bt / FP32_FLOP_PER_S * 1e3
    dense_ops_ms = 2.0 * eng.values.numel() * bt / FP32_FLOP_PER_S * 1e3
    log(f"bsr_spmm [{n_rb}x{slots} tiles, BT={bt}]: kernel {bsr_ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms, torch.bmm {lib_ms:.3f} ms; bound "
        f"{max(bsr_bytes_ms, bsr_ops_ms):.3f} ms (bytes {bsr_bytes_ms:.3f} "
        f"ms, nonzero flops {bsr_ops_ms:.4f} ms); dense-tile FFMA "
        f"{dense_ops_ms:.3f} ms at 67 TFLOP/s")

    gen = torch.Generator(device="cuda").manual_seed(3)
    y, t, acc = (torch.randn(n_pad, bt, device="cuda", generator=gen)
                 for _ in range(3))
    ck = torch.tensor(0.5567, device="cuda")
    cheb_ms = time_ms(lambda: cheb_step(y, t, acc, ck), 20)
    cheb_plain_ms = time_ms(lambda: cheb_step_ref(y, t, acc, ck), 20)
    cheb_bytes_ms = (5 * y.numel() * 4 + 4) / HBM_BYTES_PER_S * 1e3
    cheb_ops_ms = 3.0 * y.numel() / FP32_FLOP_PER_S * 1e3
    log(f"cheb_step [{n_pad}x{bt}]: kernel {cheb_ms:.3f} ms, plain "
        f"{cheb_plain_ms:.3f} ms; bound {cheb_bytes_ms:.3f} ms (bytes)")
    log(f"slice B: peak device memory {build_peak} bytes in the build, "
        f"{peak} bytes in the main path; values tensor {values_bytes} "
        f"bytes")
    del y, t, acc
    profile_tick(eng, p, plan, k=min(cfg.max_top_k, rg.n))
    del svc, x
    torch.cuda.empty_cache()
    return {
        "launches": counts, "tick_ms": tick_ms, "l1": l1_max,
        "bsr": {"ms": bsr_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                "bytes_ms": bsr_bytes_ms, "ops_ms": bsr_ops_ms,
                "err": max(errs.values())},
        "cheb": {"ms": cheb_ms, "plain_ms": cheb_plain_ms,
                 "bytes_ms": cheb_bytes_ms, "ops_ms": cheb_ops_ms},
    }


def profile_tick(eng, p, plan, k: int) -> dict:
    """Device-time breakdown of one tick's solve + top-k (torch.profiler):
    the kernels by device time and the device's idle share of the wall
    time (one stream, so kernel times add up). Informational; prints "no
    device time" if the profiler sees no kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve.pagerank_service import _solve_topk_adaptive

    def tick():
        return _solve_topk_adaptive(eng, p, plan.c, plan.tol,
                                    max_rounds=plan.max_rounds,
                                    chunk=plan.chunk, k=k)
    tick()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tick()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    from torch.autograd import DeviceType
    rows = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue        # operator rows repeat their kernels' time
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0)
        if dev > 0:
            rows.append((dev, e.count, e.key))
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    if not rows:
        log("profile of one slice B tick: no device time in key_averages")
        return {"wall_us": wall_us, "busy_us": 0.0}
    log(f"profile of one slice B tick: wall {wall_us / 1e3:.1f} ms, device "
        f"busy {busy_us / 1e3:.1f} ms, idle share "
        f"{max(0.0, 1 - busy_us / wall_us):.3f}")
    for dev, count, key in rows[:12]:
        log(f"  {dev / 1e3:9.3f} ms {count:5d}x  {key[:90]}")
    return {"wall_us": wall_us, "busy_us": busy_us}


def bound(bytes_ms: float, ops_ms: float) -> tuple[float, str]:
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                           "operations")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs a CUDA card", file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))

    phase_device()
    kerr = phase_kernels()
    a = phase_slice_a()
    b = phase_slice_b()

    bsr_b, bsr_by = bound(b["bsr"]["bytes_ms"], b["bsr"]["ops_ms"])
    cheb_b, cheb_by = bound(b["cheb"]["bytes_ms"], b["cheb"]["ops_ms"])
    table = {"kernels": [
        {"name": "bsr_spmm", "route": "cuda",
         "source": "src/repro_torch/kernels/bsr_spmm/csrc/bsr_spmm.cu",
         "replaces": "src/repro/kernels/bsr_spmm/bsr_spmm.py:29",
         "launches": a["launches"]["bsr_spmm"] + b["launches"]["bsr_spmm"],
         "launches_by_path": {"slice_a": a["launches"]["bsr_spmm"],
                              "slice_b": b["launches"]["bsr_spmm"]},
         "max_abs_err": max(kerr["bsr_spmm"], b["bsr"]["err"]),
         "ms": b["bsr"]["ms"], "plain_ms": b["bsr"]["plain_ms"],
         "bound_ms": bsr_b, "bound_by": bsr_by,
         "library_ms": b["bsr"]["library_ms"]},
        {"name": "cheb_step", "route": "cuda",
         "source": "src/repro_torch/kernels/cheb_step/csrc/cheb_step.cu",
         "replaces": "src/repro/kernels/cheb_step/cheb_step.py:33",
         "launches": a["launches"]["cheb_step"] + b["launches"]["cheb_step"],
         "launches_by_path": {"slice_a": a["launches"]["cheb_step"],
                              "slice_b": b["launches"]["cheb_step"]},
         "max_abs_err": kerr["cheb_step"],
         "ms": b["cheb"]["ms"], "plain_ms": b["cheb"]["plain_ms"],
         "bound_ms": cheb_b, "bound_by": cheb_by, "library_ms": None},
    ]}
    print(json.dumps(table))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
