"""`topk_columns` designs side by side on one card, on slice B's snapshot.

    python3 probes/topk_columns_probe.py [--parent DIR] [--cuts]
        [--rounds N] [--out DIR]

Builds the package's `csrc/topk_columns.cu` (ptxas registers and spills
printed), with `--cuts` copies of it under build/topk_probe/<tag>/ with
the ranking cut out (`cut_ring`: each step's rows are read from the ring
and dropped; `cut_tests`: the ring and each step's test, no offer),
which give no result and are timed only, and, with `--parent`, the
`topk_columns.cu` found under DIR (another commit's source, e.g.
unpacked with `git archive HEAD src/repro_torch/kernels/topk/csrc`), all
with the package's nvcc flags, all nvcc runs at once. Then:

* holds the package's kernel bitwise against its plain version on each
  path (narrow, TMA, cp.async: ragged widths, an offset view, f64, ties,
  zeros, row maps with padding rows);
* builds slice B's tick (chip_smoke's NACA0015 x10 service, 128 seeded
  queries, the adaptive loop) and ranks its snapshot, k = 32: width 128
  through the row map and in vertex order, widths 16, 4 and 1 (the first
  columns of the vertex-order snapshot), and one [1,000,000 x 1] column of
  N(0, 1) scores at k = 100 (DLRM retrieval's shape). For each case, CUDA
  events over 20 calls of the package's kernel, each cut and the
  parent, in the order parent, package, cuts, package, parent, every
  output but the cuts' checked bitwise against the package's; beside the
  bytes bound (the ranked rows and the map read once, the outputs
  written once, over 3.35 TB/s); the package's kernels by device time
  (torch.profiler over 5 calls) and the wrapper's host microseconds a
  call (200 calls, not synchronized);
* the launch floor (the wrapper ranking 1,024 rows, after 20 calls of
  warm-up, the least of 3 means of 100 calls) and the wrapper's host
  time by piece.

Prints the card's name and power limit first and a JSON summary last;
the log goes to `--out`/log.txt too, the summary to `--out`/summary.json.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import ab_runs                                              # noqa: E402
import chip_smoke as cs                                     # noqa: E402

V = ctypes.c_void_p
NEW_ARGS = [V, V, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, V,
            ctypes.c_int64, V, V, V]
OLD_ARGS = [V, V, ctypes.c_int64, ctypes.c_int64, ctypes.c_int] + [V] * 6
# the cuts: (anchor in the kernel's source, text put before it)
CUTS = {
    "cut_ring": ("      // kBatches x 32 rows of this warp's columns",
                 "      if (true) continue;   // the ring alone\n"),
    "cut_tests": ("      if (__any_sync(kFull, maybe)) {\n",
                  "      if (__any_sync(kFull, maybe)) st[0].nb ^= 1;\n"
                  "      continue;   // the ring and the step tests\n"),
}


def cut_source(tag: str, out: Path) -> Path:
    """A copy of the package's kernel source with the cut `tag`, under
    out/tag/."""
    from repro_torch.kernels import _build
    anchor, text = CUTS[tag]
    src = _build.sources()["topk_columns"].read_text()
    if src.count(anchor) != 1:
        raise SystemExit(f"{tag}: its anchor is not once in the source")
    path = out / tag / "topk_columns.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(src.replace(anchor, text + anchor))
    return path


def build(jobs: dict, out: Path) -> dict:
    """{tag: source} -> {tag: (CDLL, nvcc log)}, all nvcc runs started
    together."""
    from repro_torch.kernels import _build
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for tag, src in jobs.items():
        lib = out / f"{tag}.so"
        procs[tag] = (subprocess.Popen(
            [_build._nvcc(), *_build.flags("topk_columns"), "-o", str(lib),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), lib)
    libs = {}
    for tag, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc {tag} failed:\n{log}")
        libs[tag] = (ctypes.CDLL(str(lib)), log)
    return libs


def ptxas_lines(log: str) -> list:
    """The register / spill lines of an nvcc -Xptxas -v log."""
    keep = []
    fn = ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1] if "'" in line else line
        if "registers" in line or "spill" in line:
            # the mangled name's tail carries the template arguments
            keep.append(f"{fn[-40:]}: {line.strip()}")
    return keep


def bound_fn(lib, old: bool):
    name = "topk_columns_f32"
    fn = getattr(lib, name)
    fn.argtypes = OLD_ARGS if old else NEW_ARGS
    fn.restype = ctypes.c_int
    if old:
        ch = lib.topk_columns_chunks
        ch.argtypes = [ctypes.c_int64]
        ch.restype = ctypes.c_int64
        return fn, ch
    return fn, None


def call_new(fn, x, k, n_valid, ids, pl):
    """The package's C entry (any library of its source) with the
    scratch of plan pl."""
    import torch
    cols = x.shape[1]
    scratch = torch.empty(pl.scratch_bytes, dtype=torch.uint8,
                          device=x.device)
    out_v = torch.empty((cols, k), dtype=x.dtype, device=x.device)
    out_i = torch.empty((cols, k), dtype=torch.int32, device=x.device)
    err = fn(x.data_ptr(), 0 if ids is None else ids.data_ptr(), n_valid,
             cols, k, scratch.data_ptr(), pl.scratch_bytes,
             out_v.data_ptr(), out_i.data_ptr(),
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"launch failed: {err} ({pl})")
    return out_i, out_v


def call_old(fn_ch, x, k, n_valid, ids):
    """The parent's C entry: chunks from its own plan."""
    import torch
    fn, ch = fn_ch
    cols = x.shape[1]
    chunks = ch(n_valid)
    bound = torch.empty(cols, dtype=torch.int64, device=x.device)
    cand_v = torch.empty((chunks, cols, k), dtype=x.dtype, device=x.device)
    cand_i = torch.empty((chunks, cols, k), dtype=torch.int32,
                         device=x.device)
    out_v = torch.empty((cols, k), dtype=x.dtype, device=x.device)
    out_i = torch.empty((cols, k), dtype=torch.int32, device=x.device)
    err = fn(x.data_ptr(), 0 if ids is None else ids.data_ptr(), n_valid,
             cols, k, bound.data_ptr(), cand_v.data_ptr(),
             cand_i.data_ptr(), out_v.data_ptr(), out_i.data_ptr(),
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"parent launch failed: {err}")
    return out_i, out_v


def same(a, b) -> bool:
    import torch
    return torch.equal(a[0], b[0]) and torch.equal(
        a[1].view(torch.int32), b[1].view(torch.int32))


def correctness() -> int:
    """The package's kernel bitwise its plain version on every path."""
    import torch
    from repro_torch.kernels.topk import ops
    from repro_torch.kernels.topk.ref import topk_columns_ref
    gen = torch.Generator(device="cuda").manual_seed(3)
    cases = []
    for b in (1, 2, 3, 4, 5, 8, 16, 31, 32, 33, 64, 128, 129):
        for kind in ("random", "ties", "zeros"):
            cases.append((70_001, b, 32, kind, b % 2 == 1, torch.float32,
                          0))
    cases += [(70_001, b, k, "random", True, torch.float64, 0)
              for b, k in ((1, 100), (16, 128), (32, 1), (127, 33))]
    cases += [(70_001, b, k, "ties", False, torch.float32, 1)
              for b, k in ((1, 31), (4, 128), (128, 100))]
    cases += [(1_000_000, 1, 100, "random", False, torch.float32, 0)]
    ops.reset_launches()
    for rows, b, k, kind, mapped, dtype, off in cases:
        x = torch.empty(rows * b + off, device="cuda", dtype=dtype)[off:]
        x = x.view(rows, b)
        if kind == "random":
            x.copy_(torch.randn(rows, b, device="cuda", generator=gen))
        elif kind == "ties":
            x.copy_(torch.randint(0, 5, (rows, b), device="cuda",
                                  generator=gen))
        else:
            x.zero_()
        n_valid, ids = rows, None
        if mapped:
            n_valid = rows - 9
            x[n_valid:] = float(x.abs().max()) + 1.0
            ids = torch.randperm(n_valid, device="cuda",
                                 generator=gen).to(torch.int32)
        got = ops.topk_columns(x, k, n_valid, ids)
        want = topk_columns_ref(x, k, n_valid, ids)
        torch.cuda.synchronize()
        bits = torch.int32 if dtype == torch.float32 else torch.int64
        cs.check(torch.equal(got[0], want[0]) and torch.equal(
            got[1].view(bits), want[1].view(bits)),
            f"[{rows}, {b}] k={k} {kind} map={mapped} {dtype} off={off}: "
            f"kernel vs plain not bitwise ({ops.plan(n_valid, b, k, x.element_size(), x.data_ptr() % 16 == 0)})")
    cs.log(f"correctness: {len(cases)} cases bitwise, launches by path "
           f"{ops.launches_by_path()}")
    return len(cases)


def snapshot():
    """Slice B's tick snapshot: (rows, n_valid, ids, vertex-order rows)."""
    import torch
    from repro_torch.configs.pagerank_serve import PPRServeConfig, \
        make_service
    from repro_torch.core.pagerank import cpaa_adaptive_loop
    cfg = PPRServeConfig(graphs=(("naca", "NACA0015", 10.0),),
                         engine="fused", max_batch=128, max_top_k=32)
    t0 = time.perf_counter()
    svc = make_service(cfg, device="cuda")
    eng = svc.registry.get("naca").engine
    queries = cs.seeded_queries(svc, 128, seed=1, top_k=32)
    p = cs.personalization(svc, queries, 128)
    plan = svc.registry.adaptive_schedule(cfg.c, cfg.tol)
    _, snap = cpaa_adaptive_loop(eng, p, plan.c, plan.tol,
                                 max_rounds=plan.max_rounds,
                                 chunk=plan.chunk)[:2]
    rows, n_valid, ids = eng.ranking_layout(snap)
    vert = eng.from_internal(snap).contiguous()
    torch.cuda.synchronize()
    zeros = float((vert == 0).float().mean())
    cs.log(f"slice B snapshot [{rows.shape[0]} x {rows.shape[1]}], "
           f"{n_valid} ranked rows, {zeros:.4f} of the vertex-order "
           f"entries exactly 0; built in {time.perf_counter() - t0:.1f} s")
    return rows, n_valid, ids, vert


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--cuts", action="store_true")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--out", type=Path,
                    default=ROOT / "chiprun_out" / "topk_probe")
    args = ap.parse_args()
    args.out.mkdir(parents=True, exist_ok=True)
    log_file = open(args.out / "log.txt", "w")
    print_log = cs.log

    def log(msg: str) -> None:
        print_log(msg)
        log_file.write(msg + "\n")
        log_file.flush()
    cs.log = log
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    from repro_torch.kernels import _build
    from repro_torch.kernels.topk import ops
    cs.CARD = ab_runs.card()
    cs.log(cs.CARD)
    torch.backends.cuda.matmul.allow_tf32 = False
    build_out = ROOT / "build" / "topk_probe"
    jobs = {tag: cut_source(tag, build_out) for tag in CUTS if args.cuts}
    if args.parent:
        old = sorted(args.parent.rglob("topk_columns.cu"))
        if not old:
            raise SystemExit(f"no topk_columns.cu under {args.parent}")
        jobs["parent"] = old[0]
    t0 = time.perf_counter()
    secs = _build.build_all(["topk_columns"])
    libs = build(jobs, build_out)
    cs.log(f"built in {time.perf_counter() - t0:.1f} s ({secs})")
    for line in ptxas_lines(_build.build_log("topk_columns")):
        cs.log(f"  ptxas package {line}")
    for tag, (_, log) in libs.items():
        for line in ptxas_lines(log):
            cs.log(f"  ptxas {tag} {line}")
    n_cases = correctness()

    pkg_fn = ops._c_function("topk_columns_f32", NEW_ARGS)
    cuts = {tag: bound_fn(lib, False)[0]
            for tag, (lib, _) in libs.items() if tag in CUTS}
    parent = bound_fn(libs["parent"][0], True) if "parent" in libs else None

    rows, n_valid, ids, vert = snapshot()
    gen = torch.Generator(device="cuda").manual_seed(5)
    scores = torch.randn(1_000_000, 1, device="cuda", generator=gen)
    cases = {"b128_map": (rows, n_valid, ids, 32),
             "b128_vertex": (vert, vert.shape[0], None, 32),
             "b16": (vert[:, :16].contiguous(), vert.shape[0], None, 32),
             "b4": (vert[:, :4].contiguous(), vert.shape[0], None, 32),
             "b1": (vert[:, :1].contiguous(), vert.shape[0], None, 32),
             "retrieval": (scores, scores.shape[0], None, 100)}
    tiny = torch.randn(1024, 1, device="cuda", generator=gen)
    # the wrapper's host time by piece, 500 calls each, not synchronized
    pl_t = ops.plan(1024, 1, 32, 4, True)

    def ctx_stream(dev):
        with torch.cuda.device(dev):
            return torch.cuda.current_stream(dev).cuda_stream

    def host_us(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(500):
            fn()
        dt = (time.perf_counter() - t0) / 500 * 1e6
        torch.cuda.synchronize()
        return dt
    scratch = torch.empty(1 << 20, dtype=torch.uint8, device="cuda")
    out = torch.empty(2, 32, dtype=torch.int32, device="cuda")
    b0 = scratch.data_ptr()
    pieces = {
        "wrapper": lambda: ops.topk_columns(tiny, 32),
        "three torch.empty": lambda: (
            torch.empty(4096, dtype=torch.uint8, device="cuda"),
            torch.empty((1, 32), device="cuda"),
            torch.empty((1, 32), dtype=torch.int32, device="cuda")),
        "device context + stream": lambda: ctx_stream(tiny.device),
        "current_stream": lambda: torch.cuda.current_stream(
            tiny.device).cuda_stream,
        "checks + plan": lambda: (ops._check(tiny, 32, 1024, None),
                                  ops.plan(1024, 1, 32, 4, True)),
        "C entry alone": lambda: pkg_fn(
            tiny.data_ptr(), 0, 1024, 1, 32, b0, pl_t.scratch_bytes,
            out.data_ptr() + 128, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream),
        "torch.add": lambda: torch.add(tiny, 1.0)}
    cs.log(f"[{cs.CARD}] host us a call: " + ", ".join(
        f"{name} {host_us(fn):.1f}" for name, fn in pieces.items()))
    summary = {"card": cs.CARD, "cases": n_cases, "times": {}}
    for rnd in range(args.rounds):
        for name, (x, nv, idx, k) in cases.items():
            cols = x.shape[1]
            pl = ops.plan(nv, cols, k, 4, x.data_ptr() % 16 == 0)
            want = ops.topk_columns(x, k, nv, idx)
            runs = {"package": lambda: call_new(pkg_fn, x, k, nv, idx, pl)}
            for tag, fn in cuts.items():
                runs[tag] = (lambda f=fn: call_new(f, x, k, nv, idx, pl))
            if parent is not None:
                runs["parent"] = lambda: call_old(parent, x, k, nv, idx)
            for tag, fn in runs.items():
                cs.check(tag in CUTS or same(fn(), want),
                         f"{name} {tag}: not the package's bits")
            order = list(runs)
            if "parent" in order:
                order.remove("parent")
                order = ["parent"] + order + order[:1] + ["parent"]
            else:
                order = order + order[:1]
            times: dict = {}
            for tag in order:
                times.setdefault(tag, []).append(
                    cs.time_ms(runs[tag], 20))
            if rnd == 0:
                cs.profile_device(lambda: [runs["package"]()
                                           for _ in range(5)],
                                  f"{name}, 5 calls of the package")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(200):
                    ops.topk_columns(x, k, nv, idx)
                host_us = (time.perf_counter() - t0) / 200 * 1e6
                torch.cuda.synchronize()
                cs.log(f"{name}: the wrapper's host time {host_us:.1f} us "
                       f"a call")
            bytes_ms = (4 * nv * cols + (0 if idx is None else 4 * nv)
                        + 8 * cols * k) / cs.HBM_BYTES_PER_S * 1e3
            cs.log(f"[{cs.CARD}] {name} [{nv} x {cols}] k={k} {pl}: bound "
                   f"{bytes_ms:.4f} ms; " + ", ".join(
                       f"{t} " + " / ".join(f"{v:.4f}" for v in vs)
                       for t, vs in times.items()))
            summary["times"].setdefault(name, []).append(
                {"bound_ms": bytes_ms, "plan": pl._asdict(), **times})
    # the launch floor, warm: the wrapper ranking 1,024 rows
    floor = min(cs.time_ms(lambda: ops.topk_columns(tiny, 32), 100,
                           warmup=20) for _ in range(3))
    cs.log(f"[{cs.CARD}] launch floor (the wrapper on [1024 x 1], k = 32, "
           f"warm, the least of 3 means of 100 calls): {floor:.4f} ms")
    summary["floor_ms"] = floor
    print(json.dumps(summary), flush=True)
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / "summary.json").write_text(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.exit(main())
