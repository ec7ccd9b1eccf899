#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`src/repro_torch`).

    python3 chip_smoke.py

Needs one CUDA card (an H100 is what it was written for) and the CUDA
toolkit (nvcc). Drives the port only; it imports neither jax nor the JAX
package. Phases, each of which must pass:

  1. device: the card's name and power limit (nvidia-smi), then one
     parallel nvcc build of every kernel from the sources in this checkout,
     each kernel function's ptxas line (registers, spills) and, where the
     toolkit has cuobjdump, the count of HGMMA (wgmma) instructions in the
     bsr_spmm library (0 fails);
  2. kernels vs their plain PyTorch versions on the card: bsr_spmm at
     B = 128, BT in {1, 4, 8, 16, 32, 64, 128} on a random tiling
     (rtol/atol 1e-5; FFMA at BT = 1, 3xTF32 wgmma from 2 on), both
     variants on an x of magnitude 1e-6..1e2 with random signs, held to
     plain at 1e-5 and beside a float64 product, the host cost of one
     bsr_spmm call, and cheb_step on [n] and [n, B] at ragged sizes
     (rtol 1e-6);
  3. slice A: the PPR service at `full_config()` with engine "auto"
     (naca must land on the fused block-ELL engine, kmer on COO), 256
     seeded queries + 10% repeats, answers checked against a float64
     scipy solve of (I - cP) x = (1 - c) p;
  4. slice B: the service on NACA0015 at the paper's size (n = 1,040,000)
     with engine "fused", 128 queries + 13 repeats, every bsr_spmm launch
     of the tick on the wgmma variant; bsr_spmm vs plain on that tiling at
     the same widths; the kernel solve of the tick's personalization matrix
     vs the same solve through the plain versions (L1 <= 1e-5 per column);
     CUDA-event times of the tick and of each kernel beside its bound, its
     plain version and a library yardstick (bsr_spmm at BT 8, 32 and 128,
     also beside its 3xTF32 tensor time and its FP32 FFMA time; both
     bsr_spmm variants at BT 1, 2 and 4, where the dispatch cuts); one COO
     engine apply beside one fused apply at BT = 128 (the min_fill
     question);
  5. slice C: DLRM-RM2 at `full_config()` (8.64 GB table on the card):
     embedding_bag vs plain (bitwise at bag 1, also on rows >= 2^25 where
     32-bit offsets would fail; rtol/atol 1e-5 for weighted bags of 4 and
     26 at D = 64 and 13); serve_step over 20 serve_p99 batches, 3
     serve_bulk batches and one power-law serve_bulk batch, and
     retrieval_step at retrieval_cand; probabilities checked against a
     float64 numpy forward and the top-100 against a float64 argsort;
     CUDA-event times, the kernel at the serve_bulk shape beside its bound,
     its plain version and F.embedding_bag, a profile of one serve_bulk
     step and the peak device memory.

Each main path runs with the kernels' launch counters set to 0 just
before and read just after; a kernel of the path that was not launched
fails the run. The line before the last is the kernel table as JSON; the
last line is {"ok": true, "device": {...}}. Any failed phase exits
non-zero without that line.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOP_PER_S = 67e12        # H100 SXM FP32, non-tensor (data sheet)
TF32_FLOP_PER_S = 495e12       # H100 SXM TF32 tensor core, dense (data sheet)
BSR_BTS = (1, 4, 8, 16, 32, 64, 128)   # widths held against plain


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
    from repro_torch.kernels.embedding_bag import ops as eb_ops
    bsr_ops.reset_launches()
    cheb_ops.reset_launches()
    eb_ops.reset_launches()
    engine.reset_apply_counts()


def read_counts() -> dict:
    from repro_torch.core import engine
    from repro_torch.kernels.bsr_spmm import ops as bsr_ops
    from repro_torch.kernels.cheb_step import ops as cheb_ops
    from repro_torch.kernels.embedding_bag import ops as eb_ops
    return {"bsr_spmm": bsr_ops.launches(), "cheb_step": cheb_ops.launches(),
            "embedding_bag": eb_ops.launches(),
            "bsr_spmm_variants": bsr_ops.launches_by_variant(),
            "applies": engine.apply_counts()}


# ---------------------------------------------------------------- phase 1 --
def phase_device():
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.bsr_spmm import ops as bsr_ops
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
        fn = "?"
        for line in _build.build_log(name).splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1]
            elif "registers" in line or "spill" in line:
                log(f"  ptxas {name} {fn[:64]}: {line.strip()}")
    check(set(secs) == set(_build.sources()), "not every kernel was built")
    lib = _build.library("bsr_spmm")
    log("bsr_spmm wgmma variant: dynamic shared memory "
        f"{lib.bsr_spmm_tc_smem_bytes(64)} bytes per CTA at BT <= 64, "
        f"{lib.bsr_spmm_tc_smem_bytes(128)} above; FFMA below BT = "
        f"{bsr_ops.TC_MIN_BT}")
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if Path(cuobjdump).exists():
        sass = subprocess.run([cuobjdump, "-sass",
                               str(_build.library_path("bsr_spmm"))],
                              capture_output=True, text=True, timeout=120)
        check(sass.returncode == 0, f"cuobjdump failed: {sass.stderr}")
        n_hgmma = sum("HGMMA" in ln for ln in sass.stdout.splitlines())
        log(f"bsr_spmm SASS: {n_hgmma} HGMMA instructions")
        check(n_hgmma > 0, "bsr_spmm SASS holds no HGMMA instruction")
    else:
        log("bsr_spmm SASS: not checked (no cuobjdump in this toolkit)")


# ---------------------------------------------------------------- phase 2 --
def compare_bsr(block_cols, values, bts, seed: int) -> dict:
    """bsr_spmm kernel vs plain on the card, each width on the variant
    `variant(bt)` names; returns {bt: max_abs_err}."""
    import torch
    from repro_torch.kernels.bsr_spmm import ops as bsr_ops
    from repro_torch.kernels.bsr_spmm.ops import bsr_spmm
    from repro_torch.kernels.bsr_spmm.ref import bsr_spmm_ref
    n = values.shape[0] * values.shape[2]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    errs = {}
    for bt in bts:
        x = torch.randn(n, bt, device="cuda", generator=gen)
        before = bsr_ops.launches_by_variant()[bsr_ops.variant(bt)]
        y = bsr_spmm(block_cols, values, x)
        torch.cuda.synchronize()
        check(bsr_ops.launches_by_variant()[bsr_ops.variant(bt)]
              == before + 1, f"bsr_spmm BT={bt}: not on the "
              f"{bsr_ops.variant(bt)} variant")
        ref = bsr_spmm_ref(block_cols, values, x)
        torch.cuda.synchronize()
        err = float((y - ref).abs().max())
        check(torch.allclose(y, ref, rtol=1e-5, atol=1e-5),
              f"bsr_spmm BT={bt}: kernel vs plain max |err| {err:.3e}")
        errs[bt] = err
        del x, y, ref
    return errs


def dynamic_range_witness(block_cols, values, bt: int, seed: int) -> dict:
    """bsr_spmm on an x whose magnitudes span 1e-6..1e2 with random signs,
    through both variants, beside the plain version; each held to a float64
    product of the same inputs and to plain. Returns, per result, the max
    of |err| / (1e-5 + 1e-5 |plain|) (above 1 misses the parity bound)."""
    import torch
    from repro_torch.kernels.bsr_spmm.ops import VARIANTS, bsr_spmm_as
    from repro_torch.kernels.bsr_spmm.ref import bsr_spmm_ref
    n = values.shape[0] * values.shape[2]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    mag = 10.0 ** (torch.rand(n, bt, device="cuda", generator=gen) * 8 - 6)
    sign = torch.randint(0, 2, (n, bt), device="cuda", generator=gen) * 2 - 1
    x = (mag * sign).float()
    plain = bsr_spmm_ref(block_cols, values, x)
    f64 = bsr_spmm_ref(block_cols, values.double(), x.double())
    tol = 1e-5 + 1e-5 * plain.abs().double()
    out = {"plain": plain}
    for kind in VARIANTS:
        out[kind] = bsr_spmm_as(block_cols, values, x, kind)
    torch.cuda.synchronize()
    res = {}
    for name, y in out.items():
        res[name] = {
            "vs_plain": float(((y.double() - plain.double()).abs() / tol)
                              .max()),
            "vs_f64": float(((y.double() - f64).abs() / tol).max()),
            "max_abs_vs_plain": float((y - plain).abs().max())}
    del x, plain, f64, out
    return res


def phase_kernels() -> dict:
    import torch
    from repro_torch.kernels.bsr_spmm import ops as bsr_ops
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
    errs = compare_bsr(block_cols, values, BSR_BTS, seed=1)
    log("bsr_spmm random tiling (96 row blocks, S=8) max |kernel - plain|: "
        + ", ".join(f"BT={k} {v:.3e}" for k, v in errs.items()))
    worst = max(errs.values())
    wit = dynamic_range_witness(block_cols, values, bt=16, seed=4)
    log("bsr_spmm random tiling, x of magnitude 1e-6..1e2 with random "
        "signs, BT=16; max |err| / (1e-5 + 1e-5 |plain|): " + "; ".join(
            f"{k} vs plain {v['vs_plain']:.3f} (max |err| "
            f"{v['max_abs_vs_plain']:.3e}), vs float64 {v['vs_f64']:.3f}"
            for k, v in wit.items()))
    for kind in bsr_ops.VARIANTS:
        check(wit[kind]["vs_plain"] <= 1.0, f"bsr_spmm {kind}: misses 1e-5 "
              "against plain on the large-dynamic-range x")
    host_us = host_cost(block_cols, values)
    log("bsr_spmm host cost per call (one 128x128 tile, BT=128, 2000 calls "
        f"unsynced): wrapper {host_us['wrapper']:.2f} us, the C launch "
        f"alone {host_us['c_launch']:.2f} us, torch.add on the same x "
        f"{host_us['torch_add']:.2f} us")
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
    return {"bsr_spmm": worst, "cheb_step": cheb_err, "dyn_range": wit,
            "host_us": host_us}


def host_cost(block_cols, values) -> dict:
    """Host microseconds per bsr_spmm call at a size where the card waits
    on the host (one tile): through the wrapper, through the C entry point
    alone (tensor maps, launch), and torch.add as a yardstick."""
    import torch
    from repro_torch.kernels.bsr_spmm import ops as bsr_ops
    bc = torch.zeros(1, 1, dtype=torch.int32, device="cuda")
    v = values[:1, :1].contiguous()
    x = torch.randn(128, 128, device="cuda")
    y = torch.empty_like(x)
    fn = bsr_ops._kernel_fn()
    stream = torch.cuda.current_stream().cuda_stream
    calls = {
        "wrapper": lambda: bsr_ops.bsr_spmm(bc, v, x),
        "c_launch": lambda: fn(bc.data_ptr(), v.data_ptr(), x.data_ptr(),
                               y.data_ptr(), 1, 1, 128, 1, stream),
        "torch_add": lambda: torch.add(x, 1.0)}
    out = {}
    for name, call in calls.items():
        for _ in range(50):
            call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            call()
        out[name] = (time.perf_counter() - t0) / 2000 * 1e6
        torch.cuda.synchronize()
    del bc, v, x, y
    return out


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
    check(counts["bsr_spmm_variants"]["wgmma_3xtf32"] > 0,
          f"slice A: the wgmma variant of bsr_spmm was not launched: "
          f"{counts}")
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
    from repro_torch.core.engine import CooEngine, FusedBlockEllEngine
    from repro_torch.core.pagerank import cpaa_adaptive_fixed
    from repro_torch.kernels.bsr_spmm import ops as bsr_ops
    from repro_torch.kernels.bsr_spmm.ops import bsr_spmm, bsr_spmm_as
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
    errs = compare_bsr(eng.block_cols, eng.values, BSR_BTS, seed=2)
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
    check(counts["bsr_spmm_variants"]["wgmma_3xtf32"] == counts["bsr_spmm"],
          f"slice B: not every bsr_spmm launch was on the wgmma variant: "
          f"{counts}")
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
    nnz = int((eng.values != 0).sum())
    vals_p = eng.values.permute(0, 2, 1, 3).reshape(n_rb, blk, slots * blk)
    bsr_times = {}
    for w in (8, 32, bt):
        xw = x[:, :w].contiguous()
        gathered = xw.reshape(n_rb, blk, w)[eng.block_cols.long()].reshape(
            n_rb, slots * blk, w)
        lib = torch.bmm(vals_p, gathered).reshape(n_pad, w)
        check(torch.allclose(lib, bsr_spmm_ref(eng.block_cols, eng.values,
                                               xw), rtol=1e-5, atol=1e-5),
              "torch.bmm yardstick wrong")
        del lib
        # kernel, plain, library, kernel: the kernel's two readings bracket
        # the others (one card, one call)
        k1 = time_ms(lambda: bsr_spmm(eng.block_cols, eng.values, xw), 10)
        pl = time_ms(lambda: bsr_spmm_ref(eng.block_cols, eng.values, xw), 3)
        lb = time_ms(lambda: torch.bmm(vals_p, gathered), 3)
        k2 = time_ms(lambda: bsr_spmm(eng.block_cols, eng.values, xw), 10)
        del gathered
        bytes_ms = 4 * (eng.block_cols.numel() + eng.values.numel()
                        + 2 * xw.numel()) / HBM_BYTES_PER_S * 1e3
        dense = 2.0 * eng.values.numel() * w
        bsr_times[w] = {
            "ms": (k1 + k2) / 2, "plain_ms": pl, "library_ms": lb,
            "bytes_ms": bytes_ms,
            "ops_ms": 2.0 * nnz * w / FP32_FLOP_PER_S * 1e3,
            "tf32x3_ms": 3 * dense / TF32_FLOP_PER_S * 1e3,
            "ffma_ms": dense / FP32_FLOP_PER_S * 1e3}
        r = bsr_times[w]
        log(f"bsr_spmm [{n_rb}x{slots} tiles, BT={w}]: kernel {k1:.3f} / "
            f"{k2:.3f} ms, plain {pl:.3f} ms, torch.bmm {lb:.3f} ms; bound "
            f"{max(bytes_ms, r['ops_ms']):.3f} ms (bytes {bytes_ms:.3f} ms, "
            f"nonzero flops {r['ops_ms']:.4f} ms), kernel at "
            f"{bytes_ms / r['ms']:.3f} of it; dense-tile 3xTF32 "
            f"{r['tf32x3_ms']:.3f} ms at 495 TFLOP/s, FFMA "
            f"{r['ffma_ms']:.3f} ms at 67 TFLOP/s")
        del xw
    del vals_p
    bsr = bsr_times[bt]

    # the two variants at the narrow widths, on the same tiling
    narrow = {}
    for w in (1, 2, 4):
        xw = x[:, :w].contiguous()
        ref = bsr_spmm_ref(eng.block_cols, eng.values, xw)
        for kind in bsr_ops.VARIANTS:
            yk = bsr_spmm_as(eng.block_cols, eng.values, xw, kind)
            check(torch.allclose(yk, ref, rtol=1e-5, atol=1e-5),
                  f"bsr_spmm {kind} BT={w}: kernel vs plain disagree")
        del ref, yk

        def run(kind, xw=xw):
            return lambda: bsr_spmm_as(eng.block_cols, eng.values, xw, kind)
        f1 = time_ms(run("ffma"), 10)
        t1 = time_ms(run("wgmma_3xtf32"), 10)
        t2 = time_ms(run("wgmma_3xtf32"), 10)
        f2 = time_ms(run("ffma"), 10)
        bytes_ms = 4 * (eng.block_cols.numel() + eng.values.numel()
                        + 2 * xw.numel()) / HBM_BYTES_PER_S * 1e3
        narrow[w] = {"ffma_ms": (f1 + f2) / 2, "wgmma_ms": (t1 + t2) / 2,
                     "bytes_ms": bytes_ms}
        log(f"bsr_spmm [{n_rb}x{slots} tiles, BT={w}] by variant: ffma "
            f"{f1:.3f} / {f2:.3f} ms, wgmma_3xtf32 {t1:.3f} / {t2:.3f} ms; "
            f"bytes bound {bytes_ms:.3f} ms")
        del xw

    # the COO side of min_fill: one apply of each engine at BT = 128
    coo = CooEngine(rg.dg)
    x_coo = coo.to_internal(p)
    y_coo = coo.apply(x_coo)
    y_fused = eng.from_internal(eng.apply(x))
    check(torch.allclose(y_coo, y_fused, rtol=2e-4, atol=1e-5),
          "slice B: COO and fused applies disagree")
    del y_coo, y_fused
    coo_ms = time_ms(lambda: coo.apply(x_coo), 5)
    fused_ms = time_ms(lambda: eng.apply(x), 10)
    log(f"slice B min_fill (fill {eng.fill_rate:.4f}, BT={bt}): one COO "
        f"apply {coo_ms:.3f} ms, one fused apply {fused_ms:.3f} ms")
    del coo, x_coo

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
        "bsr": dict(bsr, err=max(errs.values())), "bsr_narrow": narrow,
        "min_fill": {"coo_ms": coo_ms, "fused_ms": fused_ms},
        "cheb": {"ms": cheb_ms, "plain_ms": cheb_plain_ms,
                 "bytes_ms": cheb_bytes_ms, "ops_ms": cheb_ops_ms},
    }


# ---------------------------------------------------------------- slice C --
HIGH_ROW = 2 ** 25     # rows of 64 f32 from here on lie at offsets >= 2^31


def compare_embedding_bag(table, ids, weights, exact: bool, label: str):
    """embedding_bag kernel vs plain on the card: bitwise when `exact`,
    else rtol/atol 1e-5 (tests/test_kernels.py's bound for the TPU kernel
    vs its oracle: L products summed in f32 in other orders). Returns the
    max abs error."""
    import torch
    from repro_torch.kernels.embedding_bag.ops import embedding_bag
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
    out = embedding_bag(ids, table, weights)
    torch.cuda.synchronize()
    ref = embedding_bag_ref(ids, table, weights)
    err = float((out - ref).abs().max())
    if exact:
        check(torch.equal(out, ref), f"embedding_bag {label}: kernel is not "
              f"bitwise equal to plain (max |err| {err:.3e})")
    else:
        check(torch.allclose(out, ref, rtol=1e-5, atol=1e-5),
              f"embedding_bag {label}: kernel vs plain max |err| {err:.3e}")
    return err


def _f64(t):
    return t.detach().cpu().numpy().astype(np.float64)


def oracle_mlp(layers, x, final_act: bool):
    """x @ w + b per layer in float64 numpy, ReLU between layers."""
    for i, p in enumerate(layers):
        x = x @ _f64(p["w"]) + _f64(p["b"])
        if i < len(layers) - 1 or final_act:
            x = np.maximum(x, 0.0)
    return x


def dlrm_oracle(params, dense, sparse_ids, cfg) -> np.ndarray:
    """Click probabilities from a DLRM forward in float64 numpy,
    independent of the port's code: the MLPs, the gathered rows summed per
    bag, the Gram matrix's strict upper triangle (np.triu_indices) and the
    sigmoid."""
    n = dense.shape[0]
    d = oracle_mlp(params["bot"], _f64(dense), True)          # [n, D]
    rows = _f64(params["table"][sparse_ids.reshape(-1).long()])
    emb = rows.reshape(n, cfg.n_sparse, cfg.bag_size, cfg.embed_dim).sum(2)
    z = np.concatenate([d[:, None, :], emb], axis=1)
    zzt = np.einsum("bfd,bgd->bfg", z, z)
    iu, ju = np.triu_indices(cfg.n_sparse + 1, k=1)
    x = np.concatenate([d, zzt[:, iu, ju]], axis=-1)
    logit = oracle_mlp(params["top"], x, False)[:, 0]
    return 1.0 / (1.0 + np.exp(-logit))


def time_embedding_bag(table, ids, label: str) -> dict:
    """The kernel at a main-path shape (unit weights, as DLRM calls it)
    beside its plain version and F.embedding_bag (the yardstick, timed
    here only), plus its bound from this input's bytes and flops."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.embedding_bag.ops import embedding_bag
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
    lib = F.embedding_bag(ids, table, mode="sum")
    check(torch.allclose(lib, embedding_bag(ids, table), rtol=1e-5,
                         atol=1e-5),
          f"F.embedding_bag yardstick disagrees ({label})")
    del lib
    ms = time_ms(lambda: embedding_bag(ids, table), 20)
    plain_ms = time_ms(lambda: embedding_bag_ref(ids, table), 5)
    lib_ms = time_ms(lambda: F.embedding_bag(ids, table, mode="sum"), 20)
    n_bags, bag = ids.shape
    dim = table.shape[1]
    distinct = int(torch.unique(ids).numel())
    out_bytes = 4 * (n_bags * dim + ids.numel())
    bytes_ms = (4 * distinct * dim + out_bytes) / HBM_BYTES_PER_S * 1e3
    gather_ms = (4 * ids.numel() * dim + out_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = 2.0 * ids.numel() * dim / FP32_FLOP_PER_S * 1e3
    log(f"embedding_bag [{n_bags} bags x L={bag}, D={dim}] {label} ids: "
        f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, F.embedding_bag "
        f"{lib_ms:.3f} ms; bound {max(bytes_ms, ops_ms):.3f} ms (bytes: "
        f"{distinct} distinct rows once + out + ids); every row from HBM "
        f"{gather_ms:.3f} ms; kernel at "
        f"{(4 * ids.numel() * dim + out_bytes) / (ms * 1e-3) / 1e12:.2f} "
        f"TB/s of gather traffic")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bytes_ms": bytes_ms, "ops_ms": ops_ms}


def phase_slice_c() -> dict:
    import torch
    from repro_torch.configs.dlrm_rm2 import (SHAPES, full_config,
                                              make_batch, model_flops)
    from repro_torch.models.recsys import dlrm
    from repro_torch.train.data import RecsysPipelineConfig, recsys_batch
    cfg = full_config()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = dlrm.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    table = params["table"]
    table_bytes = table.numel() * table.element_size()
    log(f"slice C: DLRM-RM2 full_config() built on the card in "
        f"{build_s:.2f} s; table {tuple(table.shape)} f32 = {table_bytes} "
        f"bytes ({cfg.total_rows} rows of {cfg.n_sparse} tables); peak "
        f"{torch.cuda.max_memory_allocated()} bytes")
    check(table_bytes == cfg.padded_rows * cfg.embed_dim * 4 and
          table.numel() > 2 ** 31, "slice C: table is not RM2's")

    # kernel vs plain on the card
    p99_bsz = SHAPES["serve_p99"]["batch"]
    bulk_bsz = SHAPES["serve_bulk"]["batch"]
    gen = torch.Generator(device="cuda").manual_seed(5)
    probe = make_batch(cfg, p99_bsz, seed=1, device="cuda",
                       with_labels=False)["sparse_ids"]
    errs = {"serve_p99 ids, L=1": compare_embedding_bag(
        table, probe.reshape(-1, 1), None, True, "serve_p99 L=1")}
    high = torch.randint(HIGH_ROW, cfg.total_rows, (65_536, 1),
                         device="cuda", dtype=torch.int32, generator=gen)
    errs["rows >= 2^25, L=1"] = compare_embedding_bag(
        table, high, None, True, "rows >= 2^25")
    t13 = torch.randn(100_003, 13, device="cuda", generator=gen)
    for bag in (4, 26):
        for tbl in (table, t13):
            ids = torch.randint(0, tbl.shape[0], (20_000, bag), device="cuda",
                                dtype=torch.int32, generator=gen)
            w = torch.rand(20_000, bag, device="cuda", generator=gen)
            label = f"L={bag} D={tbl.shape[1]}"
            errs[label + " weighted"] = compare_embedding_bag(
                tbl, ids, w, False, label)
    del t13
    log("embedding_bag kernel vs plain max |err|: " + ", ".join(
        f"{k} {v:.3e}" for k, v in errs.items()) + " (bitwise at L=1)")

    # the main path's inputs, made before the counted run
    p99 = [make_batch(cfg, p99_bsz, seed=100 + i, device="cuda",
                      with_labels=False) for i in range(20)]
    bulk = [make_batch(cfg, bulk_bsz, seed=200 + i, device="cuda",
                       with_labels=False) for i in range(3)]
    plaw = recsys_batch(RecsysPipelineConfig(
        cfg.vocab_sizes, cfg.n_dense, cfg.bag_size, bulk_bsz, seed=0),
        step=0, device="cuda")
    n_cand = SHAPES["retrieval_cand"]["n_candidates"]
    query = {"dense": make_batch(cfg, 1, seed=300, device="cuda",
                                 with_labels=False)["dense"],
             "candidates": torch.randn(n_cand, cfg.embed_dim, device="cuda",
                                       generator=gen)}
    dlrm.serve_step(params, p99[0], cfg)          # cuBLAS set-up, allocator
    dlrm.serve_step(params, bulk[0], cfg)
    dlrm.retrieval_step(params, query, cfg, top_k=100)
    torch.cuda.synchronize()

    # the main path
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    ev[0].record()
    p99_out = [dlrm.serve_step(params, b, cfg) for b in p99]
    ev[1].record()
    bulk_out = [dlrm.serve_step(params, b, cfg) for b in bulk]
    ev[2].record()
    plaw_out = dlrm.serve_step(params, plaw, cfg)
    ev[3].record()
    r_scores, r_idx = dlrm.retrieval_step(params, query, cfg, top_k=100)
    ev[4].record()
    torch.cuda.synchronize()
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    steps = len(p99) + len(bulk) + 1
    check(counts["embedding_bag"] == steps, f"slice C: embedding_bag "
          f"launched {counts['embedding_bag']} times for {steps} serve steps")
    outs = p99_out + bulk_out + [plaw_out]
    for b, out in zip(p99 + bulk + [plaw], outs):
        check(out.shape == (b["dense"].shape[0],) and
              bool(((out > 0) & (out < 1)).all()),
              "slice C: probabilities not finite in (0, 1)")
    p99_ms = ev[0].elapsed_time(ev[1]) / len(p99)
    bulk_ms = ev[1].elapsed_time(ev[2]) / len(bulk)
    plaw_ms = ev[2].elapsed_time(ev[3])
    retr_ms = ev[3].elapsed_time(ev[4])
    bulk_flops = model_flops(cfg, bulk_bsz, "serve")
    log(f"slice C launches: {counts}")
    log(f"slice C: serve_p99 {p99_ms:.3f} ms per batch (20 back to back); "
        f"serve_bulk {bulk_ms:.3f} ms per batch = "
        f"{bulk_bsz / bulk_ms * 1e3:.0f} samples/s, "
        f"{bulk_flops / bulk_ms * 1e-9:.1f} TFLOP/s of model flops "
        f"({bulk_flops:.3e} per batch); power-law serve_bulk "
        f"{plaw_ms:.3f} ms; retrieval_cand ({n_cand} candidates, top 100) "
        f"{retr_ms:.3f} ms; peak device memory {peak} bytes")
    lat = []
    for b in p99:
        t1 = time.perf_counter()
        dlrm.serve_step(params, b, cfg)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t1) * 1e3)
    log(f"slice C: serve_p99 one request at a time (host clock, synced): "
        f"median {float(np.median(lat)):.3f} ms, max {max(lat):.3f} ms")

    # independent float64 oracle
    n = 64
    want = dlrm_oracle(params, p99[0]["dense"][:n],
                       p99[0]["sparse_ids"][:n], cfg)
    p_err = float(np.max(np.abs(p99_out[0][:n].cpu().numpy() - want)))
    check(p_err <= 1e-5, f"slice C: served probabilities {p_err:.3e} from "
          "the float64 oracle")
    q = oracle_mlp(params["bot"], _f64(query["dense"]), True)[0]
    scores = _f64(query["candidates"]) @ q
    top = np.argsort(-scores, kind="stable")[:100]
    got_idx = r_idx.cpu().numpy()
    swapped = set(got_idx.tolist()) ^ set(top.tolist())
    kth = scores[top[-1]]
    check(all(abs(scores[i] - kth) <= 1e-5 for i in swapped),
          f"slice C: retrieval top-100 differs from the oracle's: {swapped}")
    s_err = float(np.max(np.abs(r_scores.cpu().numpy() - scores[got_idx])))
    check(s_err <= 1e-5, f"slice C: retrieval scores {s_err:.3e} from the "
          "float64 oracle")
    log(f"slice C: max |served - float64 oracle| {p_err:.3e} over {n} "
        f"samples; retrieval top-100 index sets differ in {len(swapped)} "
        f"entries, scores within {s_err:.3e}")

    # the kernel at the serve_bulk shape, then a profile of one step
    uni = time_embedding_bag(table, bulk[0]["sparse_ids"].reshape(-1, 1),
                             "uniform")
    time_embedding_bag(table, plaw["sparse_ids"].reshape(-1, 1), "power-law")
    profile_device(lambda: dlrm.serve_step(params, bulk[0], cfg),
                   "one slice C serve_bulk step")
    del params, table, probe, high, p99, bulk, plaw, query, outs
    del p99_out, bulk_out, plaw_out
    torch.cuda.empty_cache()
    return {"launches": counts, "err": max(errs.values()), "eb": uni}


def profile_device(fn, label: str) -> dict:
    """Device-time breakdown of one call of `fn` (torch.profiler, after one
    warm call): the kernels by device time and the device's idle share of
    the wall time (one stream, so kernel times add up). Informational;
    prints "no device time" if the profiler sees no kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
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
        log(f"profile of {label}: no device time in key_averages")
        return {"wall_us": wall_us, "busy_us": 0.0}
    log(f"profile of {label}: wall {wall_us / 1e3:.1f} ms, device "
        f"busy {busy_us / 1e3:.1f} ms, idle share "
        f"{max(0.0, 1 - busy_us / wall_us):.3f}")
    for dev, count, key in rows[:12]:
        log(f"  {dev / 1e3:9.3f} ms {count:5d}x  {key[:90]}")
    return {"wall_us": wall_us, "busy_us": busy_us}


def profile_tick(eng, p, plan, k: int) -> dict:
    """profile_device over one tick's solve + top-k."""
    from repro_torch.serve.pagerank_service import _solve_topk_adaptive
    return profile_device(
        lambda: _solve_topk_adaptive(eng, p, plan.c, plan.tol,
                                     max_rounds=plan.max_rounds,
                                     chunk=plan.chunk, k=k),
        "one slice B tick")


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
    c = phase_slice_c()

    bsr_b, bsr_by = bound(b["bsr"]["bytes_ms"], b["bsr"]["ops_ms"])
    cheb_b, cheb_by = bound(b["cheb"]["bytes_ms"], b["cheb"]["ops_ms"])
    eb_b, eb_by = bound(c["eb"]["bytes_ms"], c["eb"]["ops_ms"])
    table = {"kernels": [
        {"name": "bsr_spmm", "route": "cuda",
         "source": "src/repro_torch/kernels/bsr_spmm/csrc/bsr_spmm.cu",
         "replaces": "src/repro/kernels/bsr_spmm/bsr_spmm.py:42",
         "launches": a["launches"]["bsr_spmm"] + b["launches"]["bsr_spmm"],
         "launches_by_path": {"slice_a": a["launches"]["bsr_spmm"],
                              "slice_b": b["launches"]["bsr_spmm"]},
         "launches_by_variant": {
             k: a["launches"]["bsr_spmm_variants"][k]
             + b["launches"]["bsr_spmm_variants"][k]
             for k in a["launches"]["bsr_spmm_variants"]},
         "max_abs_err": max(kerr["bsr_spmm"], b["bsr"]["err"]),
         "ms": b["bsr"]["ms"], "plain_ms": b["bsr"]["plain_ms"],
         "bound_ms": bsr_b, "bound_by": bsr_by,
         "library_ms": b["bsr"]["library_ms"]},
        {"name": "cheb_step", "route": "cuda",
         "source": "src/repro_torch/kernels/cheb_step/csrc/cheb_step.cu",
         "replaces": "src/repro/kernels/cheb_step/cheb_step.py:40",
         "launches": a["launches"]["cheb_step"] + b["launches"]["cheb_step"],
         "launches_by_path": {"slice_a": a["launches"]["cheb_step"],
                              "slice_b": b["launches"]["cheb_step"]},
         "max_abs_err": kerr["cheb_step"],
         "ms": b["cheb"]["ms"], "plain_ms": b["cheb"]["plain_ms"],
         "bound_ms": cheb_b, "bound_by": cheb_by, "library_ms": None},
        {"name": "embedding_bag", "route": "cuda",
         "source": "src/repro_torch/kernels/embedding_bag/csrc/"
                   "embedding_bag.cu",
         "replaces": "src/repro/kernels/embedding_bag/embedding_bag.py:40",
         "launches": c["launches"]["embedding_bag"],
         "launches_by_path": {"slice_c": c["launches"]["embedding_bag"]},
         "max_abs_err": c["err"],
         "ms": c["eb"]["ms"], "plain_ms": c["eb"]["plain_ms"],
         "bound_ms": eb_b, "bound_by": eb_by,
         "library_ms": c["eb"]["library_ms"]},
    ]}
    print(json.dumps(table))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
