"""chip_smoke's slice B tick (the PPR service on NACA0015 x10 at the
paper's size, n = 1,040,000, engine "fused", one tick of 128 distinct
queries, adaptive rounds) of several checkouts on one card, each in a
fresh process, in the order given (`ab_runs.py`): e.g. the parent commit,
this one, this one, the parent, so that two versions are compared on one
host.

    python3 probes/ppr_tick_ab_probe.py --trees build/parent . . build/parent \\
        [--ticks N] [--out DIR]

Each tree is a checkout holding `chip_smoke.py` and `src/` (a `git
archive` unpacked under build/ for another commit). Its process imports
that tree's chip_smoke and package, builds its kernels and the service,
then times `--ticks` ticks of fresh queries (CUDA events around submit
and drain, and the host clock), each with its peak device memory and its
kernel launches, and profiles one tick's solve and top-k by kernel and by
operator (chip_smoke's `profile_device`: device-busy time and idle
share). Prints the card's name and power limit, each run's log and one
summary line per run; each run's log is written to `--out` too.
"""
import sys
import time
from pathlib import Path

import ab_runs


def one(tree: Path, ticks: int) -> dict:
    """Slice B's service and ticks of `tree` in this process."""
    cs = ab_runs.load_tree(tree)
    import torch
    from repro_torch.configs.pagerank_serve import PPRServeConfig, \
        make_service
    from repro_torch.kernels import _build
    from repro_torch.serve.pagerank_service import _solve_topk_adaptive
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    cfg = PPRServeConfig(graphs=(("naca", "NACA0015", 10.0),),
                         engine="fused", max_batch=128, max_top_k=32)
    t0 = time.perf_counter()
    svc = make_service(cfg, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    rows = []
    for i in range(ticks):
        queries = cs.seeded_queries(svc, 128, seed=100 + i, top_k=32)
        cs.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        _, st, secs = cs.drive(svc, queries, [])
        ev1.record()
        torch.cuda.synchronize()
        counts = cs.read_counts()
        rows.append({"ms": ev0.elapsed_time(ev1), "host_ms": secs[0] * 1e3,
                     "peak": torch.cuda.max_memory_allocated(),
                     "rounds": st["rounds_used"] - sum(
                         r["rounds"] for r in rows),
                     "launches": {k: counts.get(k, 0) for k in (
                         "bsr_spmm", "cheb_step", "cheb_step_masked",
                         "cheb_residual")}})
    rg = svc.registry.get("naca")
    p = cs.personalization(svc, queries, 128)
    plan = svc.registry.adaptive_schedule(cfg.c, cfg.tol)
    prof = cs.profile_device(
        lambda: _solve_topk_adaptive(rg.engine, p, plan.c, plan.tol,
                                     max_rounds=plan.max_rounds,
                                     chunk=plan.chunk, k=32),
        "one slice B tick", by_op=True)
    return {"tree": str(tree), "build_s": build_s, "ticks": rows,
            "wall_ms": prof["wall_us"] / 1e3,
            "busy_ms": prof["busy_us"] / 1e3,
            "top": [(d / 1e3, c, k[:60]) for d, c, k in prof.get("top", [])],
            "ops": [(d / 1e3, c, k[:60]) for d, c, k in prof.get("ops", [])]}


def summary(i: int, r: dict) -> str:
    return (f"run {i} {r['tree']}: ticks " + ", ".join(
        f"{t['ms']:.1f} ms ({t['rounds']} rounds, host "
        f"{t['host_ms']:.1f} ms, peak {t['peak']})" for t in r["ticks"])
        + f"; profiled solve + top-k wall {r['wall_ms']:.1f} ms, busy "
        f"{r['busy_ms']:.1f} ms; launches of the last tick "
        f"{r['ticks'][-1]['launches']}")


if __name__ == "__main__":
    sys.exit(ab_runs.main(__doc__, __file__, one, summary, "ticks", 3))
