"""The window backward of embedding_bag on the card: this checkout's
(compaction and radix sort on the card, then passes over the entries
inside) against another checkout's (`--other DIR`, e.g. a `git archive`
of the parent commit unpacked under build/: torch.sort of every id, then
passes over the whole call's chunk plan that test each id against the
window), timed within one call.

    python3 probes/eb_window_backward_probe.py --other build/parent \\
        [--rounds N] [--variants] [--fixture PATH]

Both `embedding_bag_backward.cu` are built with the port's nvcc flags
(this checkout's also holds the window's compaction and sort). Prints the
card's name and power limit, each source's ptxas lines, and:
- the whole-table kernel of both sources: their ptxas registers and spills
  side by side, and their outputs on one seeded `train_batch`-shaped case
  (`test_torch_gpu.whole_table_case`), which must be bitwise equal; the
  digest of the other source's output goes to `--fixture` (default
  build/eb_window_backward_probe/whole_table.json), the file the card
  test `test_whole_table_backward_bits_unchanged` reads from tests/fixtures;
- the window backward at DLRM-RM2 `train_batch`'s ranks 0 and 255 of the
  (16, 16) mesh (each rank's 4,096 rows of `dlrm_rm2.make_batch`, its
  window of the table's rows, as chip_smoke's M-b) and on the whole window
  [0, V) at `train_batch` (recsys_batch's 1,703,936 ids, as chip_smoke's
  phase 2): the outputs held together (bitwise on [0, V), where the chunk
  plans agree, and there also to the whole-table kernel; within 1e-4 of
  the sum of |terms| at a rank's window), then rounds of other, this,
  this, other, each the device ms per call of 20 calls queued behind a
  spin kernel (chip_smoke's `_device_ms`), every round printed, and this
  source's split into the preparation, its first pass and the two passes;
- with `--variants`, copies of this source's window pieces pass at other
  rows per register group and resident blocks per SM of its block-a-chunk
  shape (kWinDepth, kWinBlocks; the warp-a-chunk shape of larger plans
  keeps the whole-table kernel's), the two passes alone of each on the
  same prepared entries, in rounds in turn and back.
"""
import argparse
import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent   # the repository
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from chip_smoke import check, log  # noqa: E402
from repro_torch.configs import dlrm_rm2  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.embedding_bag import ops as eb_ops  # noqa: E402
from repro_torch.kernels.embedding_bag.ref import \
    embedding_bag_backward_window_ref  # noqa: E402

REL = Path("src/repro_torch/kernels/embedding_bag/csrc")
VARIANTS = ((8, 2), (4, 2), (12, 1), (16, 1))  # kWinDepth, kWinBlocks


def nvcc(src: Path, so: Path) -> subprocess.Popen:
    return subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                             str(so), str(src)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def ptxas(text: str) -> dict:
    """{kernel: "N registers, S bytes spill stores, L bytes spill loads"}
    from nvcc -Xptxas -v output, keyed by the short kernel name and its
    template arguments (V, and the flag of a parent's window template)."""
    out, fn, frame = {}, None, ""
    for line in text.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif "spill stores" in line:
            frame = line.strip()
        elif "registers" in line and fn:
            m = re.search(r"((?:backward|window)_(?:pieces|join)|"
                          r"window_histogram|window_digit_pass)I?"
                          r"((?:L[ib]\d+E)*)", fn)
            key = f"{m[1]}<{','.join(re.findall(r'L[ib](\d+)E', m[2]))}>" \
                if m else fn
            out[key] = f"{line.split('Used ')[1].split(',')[0]}, {frame}"
    return out


def bind(so: Path, name: str, n_ptrs: int, n_ints: int):
    f = getattr(ctypes.CDLL(str(so)), name)
    f.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int64] * n_ints + \
        [ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def whole_table(fn, ids, g, grad):
    """One launch of a whole-table entry point (torch.sort, the plan)."""
    flat = ids.reshape(-1)
    sid, perm = torch.sort(flat, stable=True)
    chunk, n_chunks = eb_ops.backward_plan(flat.numel())
    head, tail = torch.empty((2, n_chunks, g.shape[1]), device="cuda")
    check(fn(sid.data_ptr(), perm.data_ptr(), None, g.data_ptr(),
             grad.data_ptr(), head.data_ptr(), tail.data_ptr(), flat.numel(),
             chunk, ids.shape[1], g.shape[1],
             torch.cuda.current_stream().cuda_stream) == 0, "launch")


def old_window(fn, ids, g, grad, lo: int):
    """One launch of the other source's window entry point: torch.sort of
    every id, the whole call's plan, the window test in the passes."""
    flat = ids.reshape(-1)
    sid, perm = torch.sort(flat, stable=True)
    chunk, n_chunks = eb_ops.backward_plan(flat.numel())
    head, tail = torch.empty((2, n_chunks, g.shape[1]), device="cuda")
    check(fn(sid.data_ptr(), perm.data_ptr(), None, g.data_ptr(),
             grad.data_ptr(), head.data_ptr(), tail.data_ptr(), flat.numel(),
             chunk, ids.shape[1], g.shape[1], lo, grad.shape[0],
             torch.cuda.current_stream().cuda_stream) == 0, "launch")


def build_variants(out: Path) -> dict:
    """{VARIANTS entry: (window entry point, ptxas of its pieces pass)}."""
    text = (ROOT / REL / "embedding_bag_backward.cu").read_text()
    procs = {}
    for key in VARIANTS:
        src = out / ("win_" + "_".join(map(str, key)) + ".cu")
        variant = text
        for name, value in zip(("kWinDepth", "kWinBlocks"), key):
            variant = re.sub(rf"constexpr int {name} = \d+;",
                             f"constexpr int {name} = {value};", variant)
        src.write_text(variant)
        procs[key] = src.with_suffix(".so"), nvcc(src, src.with_suffix(".so"))
    built = {}
    for key, (so, proc) in procs.items():
        text, _ = proc.communicate()
        check(proc.returncode == 0, f"variant {key}: {text}")
        rep = ptxas(text)
        built[key] = (bind(so, "embedding_bag_backward_window_f32", 9, 3),
                      rep.get("window_pieces<2,8>", "?"))
    return built


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--fixture", default=str(
        ROOT / "build" / "eb_window_backward_probe" / "whole_table.json"))
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    chip_smoke.phase_device()
    card = chip_smoke.CARD
    out = ROOT / "build" / "eb_window_backward_probe"
    out.mkdir(parents=True, exist_ok=True)
    other_so = out / "other_backward.so"
    procs = [nvcc(root / REL / "embedding_bag_backward.cu",
                  out / f"{name}_backward.so")
             for name, root in (("other", Path(args.other)), ("this", ROOT))]
    logs = []
    for proc in procs:
        text, _ = proc.communicate()
        check(proc.returncode == 0, f"nvcc: {text}")
        logs.append(text)
    other, this = (ptxas(text) for text in logs)
    for k, v in sorted(this.items()):
        log(f"[{card}] this ptxas {k}: {v}")
    for k, v in sorted(other.items()):
        log(f"[{card}] other ptxas {k}: {v}")
    for v in (1, 2):
        for p in ("pieces", "join"):
            a, b = (d.get(f"backward_{p}<{v},0>", d.get(f"backward_{p}<{v}>"))
                    for d in (this, other))
            log(f"[{card}] whole-table backward_{p}<{v}>: this {a}, other "
                f"{b}: the same {a == b}")
    old_whole = bind(other_so, "embedding_bag_backward_f32", 7, 4)
    old_win = bind(other_so, "embedding_bag_backward_window_f32", 7, 6)
    dev = torch.device("cuda")

    # the whole-table kernel, before and after, on the fixture's case
    from test_torch_gpu import touched_digest, whole_table_case
    spec, ids, g = whole_table_case(dev)
    grad = torch.zeros((spec["rows"], spec["dim"]), device=dev)
    whole_table(old_whole, ids, g, grad)
    before = touched_digest(grad, ids)
    grad.zero_()
    eb_ops._launch_backward(ids, g, grad, None)
    after = touched_digest(grad, ids)
    log(f"[{card}] whole-table kernel on {ids.numel():,} entries: other "
        f"{before}, this {after}: bitwise equal {before == after}")
    check(before == after, "the whole-table kernel's output changed")
    Path(args.fixture).parent.mkdir(parents=True, exist_ok=True)
    Path(args.fixture).write_text(json.dumps({**spec, "sha256": before},
                                             indent=1) + "\n")
    del grad, ids, g
    torch.cuda.empty_cache()

    # the windows: M-b's ranks 0 and 255, and [0, V) at train_batch
    cfg = dlrm_rm2.full_config()
    batch = dlrm_rm2.make_batch(cfg, chip_smoke.M_EB_BATCH, seed=1,
                                device=dev, with_labels=False)
    cases = {}
    for rank in (0, 255):
        data, model = divmod(rank, 16)
        lo_b, hi_b, _ = sh.split(chip_smoke.M_EB_BATCH, 16, data)
        lo, _, n_local = sh.split(cfg.padded_rows, 16, model)
        cases[f"rank {rank}"] = (batch["sparse_ids"][lo_b:hi_b].reshape(
            -1, cfg.bag_size).contiguous(), lo, n_local)
    del batch
    from repro_torch.train.data import RecsysPipelineConfig, recsys_batch
    full = recsys_batch(RecsysPipelineConfig(
        cfg.vocab_sizes, cfg.n_dense, cfg.bag_size, chip_smoke.I4_BATCH), 0,
        "cuda")["sparse_ids"].reshape(-1, cfg.bag_size).contiguous()
    cases["[0, V)"] = (full, 0, cfg.padded_rows)
    built = build_variants(out) if args.variants else {}
    for label, (ids, lo, n_local) in cases.items():
        gen = torch.Generator(device=dev).manual_seed(7)
        g = torch.randn((ids.shape[0], cfg.embed_dim), generator=gen,
                        device=dev)
        new = eb_ops.embedding_bag_backward_window(ids, g, lo, n_local)
        old = torch.zeros_like(new)
        old_window(old_win, ids, g, old, lo)
        flat = ids.reshape(-1)
        n_in = int(((flat >= lo) & (flat < lo + n_local)).sum())
        if lo == 0 and n_local == cfg.padded_rows:
            whole = eb_ops.embedding_bag_backward(ids, g, n_local)
            same = bool(torch.equal(new, old)) and bool(
                torch.equal(new, whole))
            log(f"[{card}] {label}: this vs other and vs the whole-table "
                f"kernel bitwise {same}")
            check(same, f"{label}: outputs differ")
            del whole
        else:
            mag = embedding_bag_backward_window_ref(ids, g.double().abs(),
                                                    lo, n_local)
            share = float(((new.double() - old.double()).abs()
                           / mag.clamp(min=1e-300)).max())
            log(f"[{card}] {label}: this vs other {share:.3e} of sum "
                f"|terms| (limit {chip_smoke.EB_BWD_TOL:g}); bitwise "
                f"{bool(torch.equal(new, old))}")
            check(share <= chip_smoke.EB_BWD_TOL, f"{label}: {share:.3e}")
            del mag
        keys, vals, count = eb_ops.window_sort(ids, lo, n_local)
        calls = {
            "other": lambda: old_window(old_win, ids, g, old, lo),
            "this": lambda: eb_ops._launch_backward(ids, g, new, None, lo)}
        ms = {k: [] for k in calls}
        for _ in range(args.rounds):
            for k in ("other", "this", "this", "other"):
                ms[k].append(chip_smoke._device_ms(calls[k]))
        for k, v in ms.items():
            log(f"[{card}] {label} window [{lo:,}, {lo + n_local:,}), "
                f"{flat.numel():,} ids, {n_in:,} inside: {k} " + ", ".join(
                    f"{x:.4f}" for x in v) + f" ms (median "
                f"{float(np.median(v)):.4f})")
        prep = chip_smoke._device_ms(
            lambda: eb_ops._launch_window_sort(flat, lo, n_local))
        first = chip_smoke._device_ms(
            lambda: eb_ops._launch_window_sort(flat, lo, n_local, passes=1))
        passes = chip_smoke._device_ms(lambda: eb_ops._launch_window_passes(
            keys, vals, count, ids, g, new, None))
        tsort = chip_smoke._device_ms(lambda: torch.sort(flat, stable=True))
        log(f"[{card}] {label} this split: preparation {prep:.4f} ms "
            f"({eb_ops.sort_passes(n_local)} digit passes; the histogram "
            f"and first pass {first:.4f}), the two passes {passes:.4f}; "
            f"torch.sort of all ids {tsort:.4f}")
        by_kernel = chip_smoke.device_time_by_kernel(calls["this"], 20)
        log(f"[{card}] {label} this by kernel (torch.profiler, us per "
            f"call): " + "; ".join(f"{k[:60]} {us:.2f}" for k, us in sorted(
                by_kernel.items(), key=lambda kv: -kv[1])))
        if built:
            runs = {}
            for key, (fn, rep) in built.items():
                n_chunks = min(eb_ops.CHUNKS, -(-flat.numel() // eb_ops.TILE))
                parts = torch.empty((3, n_chunks, cfg.embed_dim), device=dev)
                got = torch.zeros_like(new)

                def run(fn=fn, parts=parts, got=got):
                    check(fn(keys.data_ptr(), vals.data_ptr(),
                             count.data_ptr(), None, g.data_ptr(),
                             got.data_ptr(), *(x.data_ptr() for x in parts),
                             flat.numel(), ids.shape[1],
                             cfg.embed_dim,
                             torch.cuda.current_stream().cuda_stream) == 0,
                          "variant launch")
                run()
                torch.cuda.synchronize()
                log(f"[{card}] {label} variant depth {key[0]}, {key[1]} "
                    f"blocks per SM: ptxas window_pieces<2,8> {rep}; "
                    f"bitwise "
                    f"vs this {bool(torch.equal(got, new))}")
                runs[key] = run, []
            for order in (list(runs), list(runs)[::-1]):
                for key in order:
                    runs[key][1].append(chip_smoke._device_ms(runs[key][0]))
            for key, (_, v) in runs.items():
                log(f"[{card}] {label} variant depth {key[0]}, {key[1]} "
                    f"blocks: the two passes "
                    + ", ".join(f"{x:.4f}" for x in v) + " ms")
        del new, old, g, keys, vals
        torch.cuda.empty_cache()
    log(f"probe {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
