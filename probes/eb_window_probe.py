"""The whole-table embedding_bag lookup of two sources, timed within one
call: this checkout's `embedding_bag.cu` (which takes a row window) and
another checkout's (`--other DIR`, e.g. a `git archive` of an earlier
commit unpacked under build/; its kernel may predate the window).

    python3 probes/eb_window_probe.py --other build/parent [--rounds N]

Both are built with the port's nvcc flags, then launched on DLRM-RM2's
`serve_bulk` shape (262,144 samples x 26 bags of one row over the
8.64 GB table, the bags of `dlrm_rm2.make_batch`), in rounds of other,
this, this, other, each time the mean of 20 launches between CUDA events;
the outputs must be bitwise equal. Prints the card's name and power
limit, each source's ptxas line and every round.
"""
import argparse
import ctypes
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent   # the repository
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.configs import dlrm_rm2  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402


def build(src: Path, out: Path):
    """(ctypes function, whether it takes a window, ptxas lines)."""
    so = out / "embedding_bag.so"
    log = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                          str(src)], capture_output=True, text=True)
    chip_smoke.check(log.returncode == 0, f"nvcc {src}: {log.stderr}")
    window = "n_local" in src.read_text()
    fn = ctypes.CDLL(str(so)).embedding_bag_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * (
        5 if window else 3) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lines = [ln.strip() for ln in (log.stdout + log.stderr).splitlines()
             if "registers" in ln]
    return fn, window, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    chip_smoke.phase_device()
    out = ROOT / "build" / "eb_window_probe"
    out.mkdir(parents=True, exist_ok=True)
    rel = Path("src/repro_torch/kernels/embedding_bag/csrc/embedding_bag.cu")
    fns = {}
    for name, root in (("this", ROOT), ("other", Path(args.other))):
        d = out / name
        d.mkdir(exist_ok=True)
        fns[name] = build(root / rel, d)
        print(f"{name}: window {fns[name][1]}; ptxas {fns[name][2]}",
              flush=True)
    cfg = dlrm_rm2.full_config()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    table = torch.empty((cfg.padded_rows, cfg.embed_dim), device=dev)
    table.normal_(0.0, 0.01, generator=gen)
    batch = dlrm_rm2.make_batch(cfg, 262_144, seed=1, device=dev,
                                with_labels=False)
    ids = batch["sparse_ids"].reshape(-1, 1).contiguous()
    outs = {k: torch.empty((ids.shape[0], cfg.embed_dim), device=dev)
            for k in fns}
    stream = torch.cuda.current_stream().cuda_stream

    def call(name):
        fn, window, _ = fns[name]
        extra = (0, table.shape[0]) if window else ()
        chip_smoke.check(fn(ids.data_ptr(), table.data_ptr(), None,
                            outs[name].data_ptr(), ids.shape[0], 1,
                            cfg.embed_dim, *extra, stream) == 0, "launch")
    for k in fns:
        call(k)
    torch.cuda.synchronize()
    chip_smoke.check(torch.equal(outs["this"], outs["other"]),
                     "the two kernels' outputs differ")
    ms = {k: [] for k in fns}
    t0 = time.perf_counter()
    for _ in range(args.rounds):
        for k in ("other", "this", "this", "other"):
            ms[k].append(chip_smoke.time_ms(lambda k=k: call(k), 20))
    for k, v in ms.items():
        print(f"[{chip_smoke.CARD}] {k}: " + ", ".join(f"{x:.4f}" for x in v)
              + f" ms (median {sorted(v)[len(v) // 2]:.4f})", flush=True)
    print(f"bitwise equal outputs; {time.perf_counter() - t0:.1f} s",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
