"""The attention kernels on one card: chip_smoke's phase 1 (the parallel
build and every kernel's ptxas line) and its `compare_attention` (phase
2's attention cases: danube's I1 layer in bf16, a ragged windowed GQA case
in f32, each against the plain version, with times beside the bound,
the plain version and SDPA), then the device time of each kernel of a
forward and a backward at danube's I1 layer (torch.profiler), with
--shapes the forward and backward at the other configs' layer shapes
(1 x 4,096, bf16, causal), and with
--variants the package's kernels beside copies of their sources patched
as VARIANTS says (built under build/attention_probe/<tag>/, all nvcc runs
at once), each timed at danube's I1 layer in the order package, variants,
package, its outputs and gradients checked bitwise against the package's;
--against DIR [DIR ...] adds the sources in each DIR (another tree's
csrc/, copied under build/) as one more variant, held to the package
within bf16 rounding:

    python3 probes/attention_probe.py [--shapes] [--variants [TAG ...]]
        [--against DIR [DIR ...]]

Prints the card's name and power limit first; every time is CUDA events,
the mean of chip_smoke's ATTN_REPS calls after a warm-up.
"""
import argparse
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

# (config, heads, kv heads, head dim): granite, deepseek, qwen2.5 and the
# 32,768-token prefill of slice H3 (danube)
SHAPES = (("granite-moe-3b-a800m", 4096, 24, 8, 64),
          ("deepseek-7b", 4096, 32, 32, 128),
          ("qwen2.5-32b", 4096, 40, 8, 128),
          ("h2o-danube-1.8b prefill", 32768, 32, 8, 80))


# the variants: {tag: [(file, text in it, its replacement)]}: the wgmma
# kernels' ring depths and the producer / consumer register split
_SM90 = "attention_sm90.cuh"
VARIANTS = {
    "regs_40_232": [(_SM90, "kProducerRegs = 24, kConsumerRegs = 240;",
                     "kProducerRegs = 40, kConsumerRegs = 232;")],
    "fwd_2_stages": [("attention_fwd.cu",
                      "kStages = DP > 80 ? 2 : 3;   // fwd: ring stages",
                      "kStages = 2;   // fwd: ring stages")],
    "dkdv_3_stages": [("attention_bwd.cu",
                       "kStages = 2;   // dkdv: ring stages",
                       "kStages = 3;   // dkdv: ring stages")],
    "dq_2_stages": [("attention_bwd.cu", "kStages = 3;   // dq: ring stages",
                     "kStages = 2;   // dq: ring stages")],
    "fwd_4_stages": [("attention_fwd.cu",
                      "kStages = DP > 80 ? 2 : 3;   // fwd: ring stages",
                      "kStages = DP > 80 ? 2 : 4;   // fwd: ring stages")],
    "fwd_bn_64": [("attention_fwd.cu",
                   "static constexpr int BN = 128;   // keys of a KV tile",
                   "static constexpr int BN = 64;   // keys of a KV tile")],
    # cut-downs (wrong results, timed to see what holds the kernels): the
    # forward without its exponentials, without O += P v, without S
    "cut_fwd_exp": [("attention_fwd.cu",
                     "exp2_approx(fmaf(sc[j][x], c, -mu[x >> 1]))",
                     "fmaf(sc[j][x], c, -mu[x >> 1])")],
    "cut_fwd_pv": [("attention_fwd.cu",
                    "mma_cols<KS, DP, BN>(acc, pa, saddr(sm.v[st]));", "")],
    "cut_fwd_s": [("attention_fwd.cu", "mma_rows<BN, DP, BM, BN>(sc, "
                   "saddr(sm.q), 64 * wg, saddr(sm.k[st]), 0);", "")],
    "cut_dq_exp": [("attention_bwd.cu",
                    "exp2_approx(p[j][x] * s.scale_log2 - l2[r])",
                    "(p[j][x] * s.scale_log2 - l2[r])")],
    "cut_dq_dq": [("attention_bwd.cu",
                   "mma_cols<KS, DP, BN>(dQ, da, saddr(sm.k[n % kStages]));",
                   "")]}


def build_variants(jobs: dict) -> dict:
    """{tag: {library name: CDLL}} of jobs {tag: (source dir, patches)},
    every copy built by one parallel batch of nvcc runs with the
    package's flags."""
    from repro_torch.kernels import _build
    procs = {}
    for tag, (csrc, patches) in jobs.items():
        out = ROOT / "build" / "attention_probe" / tag
        shutil.rmtree(out, ignore_errors=True)
        shutil.copytree(csrc, out)
        for name, old, new in patches:
            text = (out / name).read_text()
            if old not in text:
                raise SystemExit(f"variant {tag}: {old!r} not in {name}")
            (out / name).write_text(text.replace(old, new))
        for lib in ("attention_fwd", "attention_bwd"):
            so = out / f"{lib}.so"
            procs[(tag, lib)] = (subprocess.Popen(
                [_build._nvcc(), *_build.flags(lib), "-o", str(so),
                 str(out / f"{lib}.cu")], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True), so)
    libs: dict = {}
    for (tag, lib), (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {tag} {lib}: nvcc failed\n{log}")
        spills = sorted({ln.strip() for ln in log.splitlines()
                         if "spill stores" in ln and not ln.strip()
                         .startswith("0 bytes stack")})
        cs.log(f"variant {tag} {lib}: ptxas spills {spills or 'none'}")
        libs.setdefault(tag, {})[lib] = ctypes.CDLL(str(so))
    return libs


def variants(tags: list, against: list) -> None:
    """The package and the variants `tags` (and the sources in each
    directory of `against`) at danube's I1 layer (bf16)."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.attention import ops
    csrc = ROOT / "src/repro_torch/kernels/attention/csrc"
    jobs = {tag: (csrc, VARIANTS[tag]) for tag in tags}
    for path in against:
        jobs[f"against_{Path(path).name}"] = (Path(path), [])
    libs = build_variants(jobs)
    package = {n: _build.library(n) for n in ("attention_fwd",
                                               "attention_bwd")}
    gen = torch.Generator(device="cuda").manual_seed(3)
    q = torch.randn((1, 4096, 32, 80), device="cuda", generator=gen)
    k, v = (torch.randn((1, 4096, 8, 80), device="cuda", generator=gen)
            for _ in range(2))
    g = 0.1 * torch.randn(q.shape, device="cuda", generator=gen)
    q, k, v, g = (t.bfloat16() for t in (q, k, v, g))
    spec = ops._Spec(True, 4096, 0, 4096)
    ref = None
    for tag in ["package", *jobs, "package"]:
        _build._LIBS.update(package if tag == "package" else libs[tag])
        ops._FNS.clear()
        with torch.no_grad():
            o, lse = ops._forward(q, k, v, spec)
            got = [o, *ops._backward(q, k, v, o, lse, g, spec)]
            fwd = cs.time_ms(lambda: ops._forward(q, k, v, spec),
                             cs.ATTN_REPS)
            bwd = cs.time_ms(lambda: ops._backward(q, k, v, o, lse, g, spec),
                             cs.ATTN_REPS)
        torch.cuda.synchronize()
        ref = ref or got
        same = all(torch.equal(a, b) for a, b in zip(got, ref))
        gap = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(got, ref))
        cs.log(f"[{cs.CARD}] variant {tag}: forward {fwd:.4f} ms, backward "
               f"{bwd:.4f} ms; bitwise the package's {same} (max |gap| "
               f"{gap:.3e})")
    _build._LIBS.update(package)
    ops._FNS.clear()


def split() -> None:
    """Device time of each kernel of one forward and one backward at
    danube's I1 layer (torch.profiler, by kernel name)."""
    import torch
    from repro_torch.kernels.attention import ops
    gen = torch.Generator(device="cuda").manual_seed(3)
    q = torch.randn((1, 4096, 32, 80), device="cuda", generator=gen)
    k, v = (torch.randn((1, 4096, 8, 80), device="cuda", generator=gen)
            for _ in range(2))
    g = 0.1 * torch.randn(q.shape, device="cuda", generator=gen)
    q, k, v, g = (t.bfloat16() for t in (q, k, v, g))
    spec = ops._Spec(True, 4096, 0, 4096)
    with torch.no_grad():
        o, lse = ops._forward(q, k, v, spec)

        def both():
            ops._forward(q, k, v, spec)
            ops._backward(q, k, v, o, lse, g, spec)
        by_kernel = cs.device_time_by_kernel(both, calls=cs.ATTN_REPS)
    for name, us in sorted(by_kernel.items(), key=lambda kv: -kv[1]):
        cs.log(f"[{cs.CARD}] danube I1 split: {us / 1e3:8.4f} ms a call  "
               f"{name[:90]}")


def shapes() -> None:
    import torch
    from repro_torch.kernels.attention import ops
    for name, s, h, hkv, dh in SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(3)
        q = torch.randn((1, s, h, dh), device="cuda", generator=gen)
        k, v, = (torch.randn((1, s, hkv, dh), device="cuda", generator=gen)
                 for _ in range(2))
        g = 0.1 * torch.randn(q.shape, device="cuda", generator=gen)
        q, k, v, g = (t.bfloat16() for t in (q, k, v, g))
        spec = ops._Spec(True, None, 0, s)
        with torch.no_grad():
            o, lse = ops._forward(q, k, v, spec)
            fwd = cs.time_ms(lambda: ops._forward(q, k, v, spec),
                             cs.ATTN_REPS)
            bwd = cs.time_ms(lambda: ops._backward(q, k, v, o, lse, g, spec),
                             cs.ATTN_REPS)
        flops = 4 * dh * h * ops.valid_pairs(s, s)
        bound = flops / cs.BF16_DENSE_FLOP_PER_S * 1e3
        cs.log(f"[{cs.CARD}] attention {name}: 1 x {s}, {h} / {hkv} heads, "
               f"Dh {dh}, bf16 causal: forward {fwd:.4f} ms (FLOPs bound "
               f"{bound:.4f}, {bound / fwd:.0%}, {flops / fwd / 1e9:.1f} "
               f"TFLOP/s), backward {bwd:.4f} ms (bound {2.5 * bound:.4f}, "
               f"{2.5 * bound / bwd:.0%})")
        del q, k, v, g, o, lse
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", action="store_true",
                    help="also time the other configs' layer shapes")
    ap.add_argument("--variants", nargs="*", default=None,
                    choices=sorted(VARIANTS), metavar="TAG",
                    help="also time patched copies of the kernels (all "
                    "VARIANTS when no tag is named)")
    ap.add_argument("--against", nargs="+", default=[], metavar="DIR",
                    help="also time the attention sources in each DIR")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("attention_probe: needs a CUDA card", file=sys.stderr)
        return 2
    cs.phase_device()
    cs.compare_attention()      # logs ptxas, "Performance Loss" lines too
    split()
    if args.shapes:
        shapes()
    if args.variants is not None or args.against:
        variants(args.variants or ([] if args.variants is None
                                   else list(VARIANTS)), args.against)
    return 0


if __name__ == "__main__":
    sys.exit(main())
