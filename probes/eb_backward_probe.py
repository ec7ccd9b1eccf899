"""Where the time of embedding_bag's backward goes on the card, at DLRM-RM2
train_batch's shapes (chip_smoke's phase 2 inputs: recsys_batch ids at
B = 65,536, 26 bags of one row each, a random [1,703,936, 64] output
gradient, the dense [33.7M, 64] gradient).

    python3 probes/eb_backward_probe.py [--root DIR] [--reps N] [--variants]

Prints, each line with the card's name and power limit: the kernel's
ptxas lines, the whole call's ms (CUDA events over N calls on a zeroed
gradient: the sort and the passes), torch.sort's ms alone (CUDA events),
the device time of every kernel one call launches (torch.profiler, by
kernel name), and the sorted ids' segment statistics per chunk size.
`--root` imports the port from another checkout (a `git archive` of a
parent commit, say), so two versions can be timed in one chip call, each
in its own process: parent, change, change, parent.

`--variants` also builds copies of the kernel's source with other values
of its pieces-pass shape (kDepth rows per register group, kMinBlocks
resident blocks per SM, with the chunk plan that occupancy implies) and
times the two passes of each on the same sorted ids (CUDA events, rounds
in turn and back), beside the card's rate for a plain copy of the output
gradient and for torch's gather of its rows in sorted order
(`index_select`: random 256-byte reads, sequential writes).
"""
import re
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent   # the repository
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402


def arg(name: str, default: str) -> str:
    return sys.argv[sys.argv.index(name) + 1] if name in sys.argv \
        else default


def segment_stats(sorted_ids, tiles=(64, 128, 256, 512)) -> list:
    """Per chunk size T: chunks, segments that span a chunk boundary and
    the most chunks one of them touches."""
    import torch
    n = sorted_ids.numel()
    new = torch.ones(n, dtype=torch.bool, device=sorted_ids.device)
    new[1:] = sorted_ids[1:] != sorted_ids[:-1]
    starts = torch.nonzero(new).flatten()
    ends = torch.cat([starts[1:], starts.new_tensor([n])])
    out = []
    for t in tiles:
        spans = (ends - 1) // t - starts // t + 1
        out.append((t, (n + t - 1) // t, int((spans > 1).sum()),
                    int(spans.max())))
    return out, int(starts.numel()), int((ends - starts).max())


VARIANTS = ((4, 4), (6, 4), (8, 4), (4, 5), (3, 5), (4, 6))   # depth, blocks


def build_variants(root: Path) -> dict:
    """{(depth, blocks): (ctypes function, ptxas report of the pieces
    pass)}, built in parallel from the checkout's source."""
    import ctypes
    import subprocess
    from repro_torch.kernels import _build
    text = _build.sources()["embedding_bag_backward"].read_text()
    out = root / "build" / "eb_bwd_variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for depth, blocks in VARIANTS:
        src = out / f"d{depth}_b{blocks}.cu"
        src.write_text(re.sub(
            r"constexpr int kMinBlocks = \d+;",
            f"constexpr int kMinBlocks = {blocks};",
            re.sub(r"constexpr int kDepth = \d+;",
                   f"constexpr int kDepth = {depth};", text)))
        so = src.with_suffix(".so")
        procs[(depth, blocks)] = so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    built = {}
    for key, (so, proc) in procs.items():
        log, _ = proc.communicate()
        chip_smoke.check(proc.returncode == 0, f"variant {key}: {log}")
        report, fn = [], "?"
        for line in log.splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1]
            elif "backward_pieces" in fn and ("registers" in line
                                              or "spill" in line):
                report.append(line.split(":", 1)[-1].strip())
        f = ctypes.CDLL(str(so)).embedding_bag_backward_f32
        f.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int64] * 4 + \
            [ctypes.c_void_p]
        f.restype = ctypes.c_int
        built[key] = f, "; ".join(report)
    return built


def time_variants(root: Path, ids, g, grad, reps: int, tag: str) -> None:
    import numpy as np
    import torch
    built = build_variants(root)
    flat = ids.reshape(-1)
    n, bag, dim = flat.numel(), ids.shape[1], g.shape[1]
    sid, perm = torch.sort(flat, stable=True)
    uniq = torch.unique(flat).long()
    stream = torch.cuda.current_stream().cuda_stream
    runs, first = {}, None
    for key, (f, report) in built.items():
        chunk = max(256, -(-n // (132 * 8 * key[1])))
        head, tail = torch.empty((2, -(-n // chunk), dim), device="cuda")

        def run(f=f, chunk=chunk, head=head, tail=tail):
            chip_smoke.check(f(sid.data_ptr(), perm.data_ptr(), None,
                               g.data_ptr(), grad.data_ptr(),
                               head.data_ptr(), tail.data_ptr(), n, chunk,
                               bag, dim, stream) == 0, "variant launch")
        run()
        got = grad[uniq].clone()
        run()
        same = bool(torch.equal(grad[uniq], got))
        first = got if first is None else first
        gap = float((got - first).abs().max())
        runs[key] = run, []
        chip_smoke.log(f"{tag} variant depth {key[0]}, {key[1]} blocks per "
                       f"SM: chunk {chunk}; ptxas {report}; second launch "
                       f"bitwise {same}; max |diff| to the first variant "
                       f"{gap:.3e}")
    for order in (list(runs), list(runs)[::-1]) * 2:
        for key in order:
            runs[key][1].append(chip_smoke.time_ms(runs[key][0], reps))
    for key, (_, ms) in runs.items():
        chip_smoke.log(f"{tag} variant depth {key[0]}, {key[1]} blocks: "
                       f"passes {np.mean(ms):.4f} ms (rounds: "
                       f"{', '.join(f'{t:.4f}' for t in ms)})")
    copy_ms = chip_smoke.time_ms(lambda: g.clone(), reps)
    rows = perm // bag
    gather_ms = chip_smoke.time_ms(lambda: g.index_select(0, rows), reps)
    tb = 2 * g.numel() * 4 / 1e9        # bytes read and written, / ms
    chip_smoke.log(f"{tag} g.clone() {copy_ms:.4f} ms ({tb / copy_ms:.3f} "
                   f"TB/s); g.index_select(0, rows in sorted order) "
                   f"{gather_ms:.4f} ms ({tb / gather_ms:.3f} TB/s)")


def main():
    import torch
    root = Path(arg("--root", str(ROOT))).resolve()
    reps = int(arg("--reps", "20"))
    sys.path.insert(0, str(root / "src"))
    chip_smoke.phase_device()
    from repro_torch.configs.dlrm_rm2 import full_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.embedding_bag import ops as eb_ops
    from repro_torch.train.data import RecsysPipelineConfig, recsys_batch
    card = chip_smoke.CARD
    tag = f"[{card}] {root.name}"
    fn = "?"
    for line in _build.build_log("embedding_bag_backward").splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif "registers" in line or "spill" in line:
            chip_smoke.log(f"{tag} ptxas {fn[-48:]}: {line.strip()}")
    cfg = full_config()
    batch = recsys_batch(RecsysPipelineConfig(
        cfg.vocab_sizes, cfg.n_dense, cfg.bag_size, chip_smoke.I4_BATCH), 0,
        "cuda")
    ids = batch["sparse_ids"].reshape(-1, cfg.bag_size).contiguous()
    del batch
    gen = torch.Generator(device="cuda").manual_seed(5)
    g = torch.randn((ids.shape[0], cfg.embed_dim), generator=gen,
                    device="cuda")
    grad = torch.zeros((cfg.padded_rows, cfg.embed_dim), device="cuda")
    flat = ids.reshape(-1)

    def call():
        eb_ops._launch_backward(ids, g, grad, None)
    call_ms = chip_smoke.time_ms(call, reps)
    sort_ms = chip_smoke.time_ms(lambda: torch.sort(flat, stable=True), reps)
    chip_smoke.log(f"{tag} whole call {call_ms:.4f} ms (CUDA events, mean "
                   f"of {reps}); torch.sort alone {sort_ms:.4f} ms")
    by_kernel = chip_smoke.device_time_by_kernel(call, calls=reps)
    total = sum(by_kernel.values())
    chip_smoke.log(f"{tag} device time per call by kernel (torch.profiler, "
                   f"{reps} calls): {total / 1e3:.4f} ms in all")
    for name, us in sorted(by_kernel.items(), key=lambda kv: -kv[1]):
        chip_smoke.log(f"{tag}   {us / 1e3:8.4f} ms  {name[:100]}")
    if "--variants" in sys.argv:
        time_variants(root, ids, g, grad, reps, tag)
    stats, n_seg, longest = segment_stats(torch.sort(flat)[0])
    chip_smoke.log(f"{tag} {flat.numel():,} entries, {n_seg:,} segments, "
                   f"the longest {longest:,}; per chunk size T: " + "; ".join(
                       f"T={t}: {c:,} chunks, {o:,} segments span chunks, "
                       f"up to {k:,} chunks each" for t, c, o, k in stats))


if __name__ == "__main__":
    t0 = time.perf_counter()
    main()
    chip_smoke.log(f"probe {time.perf_counter() - t0:.1f} s")
