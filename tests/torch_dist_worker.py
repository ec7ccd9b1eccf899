"""One rank of the port's sharded-engine battery over gloo.

Run by tests/test_torch_sharded.py, one process per rank, with torchrun's
environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT):

    python tests/torch_dist_worker.py OUT_DIR

Every rank builds the same engines over its own shard and runs the same
solves (SPMD). Rank 0 pickles the results to OUT_DIR/results.pkl for the
test process to hold against the JAX package; every rank writes a digest
of its whole-vector answers to OUT_DIR/rank<r>.json, so the test can check
that all ranks hold the same answers. `battery(ws)` also runs in-process
at world size 1. Imports no jax.
"""
from __future__ import annotations

import contextlib
import hashlib
import io
import json
import pickle
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch.core import distributed as dist_mod
from repro_torch.core.chebyshev import make_schedule
from repro_torch.core.distributed import (cpaa_distributed_1d,
                                          cpaa_distributed_2d, init_mesh,
                                          pad_personalization,
                                          put_partition_1d, put_partition_2d)
from repro_torch.core.engine import (Sharded1DEngine, Sharded2DEngine,
                                     ShardedEngine, collective_counts, factor_grid,
                                     reset_collective_counts, select_engine)
from repro_torch.core.pagerank import (cpaa, cpaa_adaptive, forward_push,
                                       power, power_refine)
from repro_torch.graph import generators
from repro_torch.graph.partition import (col_layout_perm, partition_1d,
                                         partition_2d)
from repro_torch.graph.structure import Graph

CPU = "cpu"
GRAPHS = {
    "mesh": lambda: generators.tri_mesh(9, 11),
    "powerlaw": lambda: generators.powerlaw_ba(120, 3, seed=2),
    "kmer": lambda: generators.kmer_chains(200, seed=4),
}
KINDS = ("1d", "2d")
SERVE_SEEDS = ((3, 40), (7,), (11, 50, 60), (3, 40), (21,))
# after the update: fresh seed sets, so each answer is a solve on the new
# graph (re-stamped cache entries are approximations by design)
SERVE_SEEDS_AFTER = ((5, 66), (30,), (12, 44))


def ring(n: int) -> Graph:
    """Cycle plus one chord (tests/test_partition_padding.py's graph)."""
    u = np.arange(n, dtype=np.int64)
    return Graph.from_undirected_edges(
        n, np.concatenate([u, [0]]), np.concatenate([(u + 1) % n, [n // 2]]))


def mesh_of(kind: str, ws: int):
    if kind == "1d":
        return init_mesh((ws,), ("dev",), device=CPU)
    return init_mesh(factor_grid(ws), ("row", "col"), device=CPU)


def engine(kind: str, g, ws: int, **kw):
    cls = Sharded1DEngine if kind == "1d" else Sharded2DEngine
    return cls.from_graph(g, mesh=mesh_of(kind, ws), lane=kw.pop("lane", 4),
                          device=CPU, **kw)


def seeded_p(n: int, cols: int, seed: int, broad_first: bool = False):
    """The reference tests' seeded personalization matrices."""
    rng = np.random.default_rng(seed)
    p = np.zeros((n, cols), np.float32)
    start = 0
    if broad_first:
        p[:, 0] = 1.0 / n
        start = 1
    for j in range(start, cols):
        p[rng.choice(n, rng.integers(1, 4), replace=False), j] = 1.0
    return p


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def solver_cases(ws: int) -> dict:
    out = {}
    for gname, make in GRAPHS.items():
        g = make()
        for kind in KINDS:
            eng = engine(kind, g, ws)
            out[("vec", gname, kind)] = _np(cpaa(eng, 0.85, 1e-8).pi)
            r = cpaa_adaptive(eng, 0.85, 1e-8)
            out[("adaptive", gname, kind)] = (_np(r.pi), r.iterations,
                                              r.rounds_bound)
    g = GRAPHS["mesh"]()
    for kind in KINDS:
        eng = engine(kind, g, ws)
        p = torch.from_numpy(seeded_p(g.n, 4, 3))
        out[("batched", kind)] = _np(cpaa(eng, 0.85, 1e-8, p=p).pi)
        p = torch.from_numpy(seeded_p(g.n, 4, 5, broad_first=True))
        r = cpaa_adaptive(eng, 0.85, 1e-8, p=p)
        out[("adaptive_batched", kind)] = (_np(r.pi), r.column_rounds,
                                           r.rounds_bound)
        r = power(eng, 0.85, tol=1e-6)
        out[("power", kind)] = (_np(r.pi), r.iterations)
        out[("forward_push", kind)] = _np(forward_push(eng, 0.85,
                                                       rounds=30).pi)
        x0 = torch.from_numpy(seeded_p(g.n, 3, 7)) + 0.01
        p = torch.from_numpy(seeded_p(g.n, 3, 8))
        out[("power_refine", kind)] = _np(power_refine(eng, x0, p, 0.85, 20))
        rng = np.random.default_rng(2)
        x = torch.from_numpy(rng.standard_normal(g.n).astype(np.float32))
        out[("apply", kind)] = _np(eng.from_internal(
            eng.apply(eng.to_internal(x))))
        # collectives of ONE apply at B = 3
        xb = eng.to_internal(torch.ones(g.n, 3))
        reset_collective_counts()
        eng.apply(xb)
        out[("counts", kind)] = (collective_counts(), eng.n_pad)
        reset_collective_counts()
        gp = GRAPHS["powerlaw"]()
        ep = engine(kind, gp, ws)
        same = []
        for shape in [(gp.n,), (gp.n, 5)]:
            xr = torch.from_numpy(np.random.default_rng(0).random(shape)
                                  .astype(np.float32))
            same.append(bool(torch.equal(
                ep.from_internal(ep.to_internal(xr)), xr)))
        out[("identity", kind)] = (same, ep.n, ep.n_pad)
        # the sacrificial padding slot on a real vertex (n == n_pad)
        lane = 4
        n_ring = ws * lane if kind == "1d" else int(np.prod(factor_grid(ws))
                                                     * lane)
        er = engine(kind, ring(n_ring), ws, lane=lane)
        out[("padding", kind)] = (_np(cpaa(er, 0.85, 1e-8).pi), er.n_pad,
                                  n_ring)
    return out


def builder_cases(ws: int) -> dict:
    out = {}
    g = GRAPHS["mesh"]()
    sched = make_schedule(0.85, 1e-8)
    uniform = np.full(g.n, 1.0 / g.n, np.float32)
    m1 = mesh_of("1d", ws)
    part = partition_1d(g, ws, lane=4)
    arrs = put_partition_1d(part, m1)
    p = torch.from_numpy(pad_personalization(uniform, part.n))
    out[("builder", "1d")] = tuple(
        _np(cpaa_distributed_1d(m1, part, sched, adaptive=a)(p, *arrs))[:g.n]
        for a in (True, False))
    m2 = mesh_of("2d", ws)
    part2 = partition_2d(g, factor_grid(ws), lane=4)
    arrs2 = put_partition_2d(part2, m2)
    perm = col_layout_perm(part2.n, part2.grid)
    p_col = torch.from_numpy(pad_personalization(uniform, part2.n)[perm])
    out[("builder", "2d")] = tuple(
        _np(cpaa_distributed_2d(m2, part2, sched, adaptive=a)(p_col, *arrs2))
        for a in (True, False))
    # tests/test_multidevice.py's cases: tri_mesh(23, 31), lane 8
    g = generators.tri_mesh(23, 31)
    part = partition_1d(g, ws, lane=8)
    arrs = put_partition_1d(part, m1)
    fn = cpaa_distributed_1d(m1, part, sched)
    ones = torch.from_numpy(pad_personalization(np.ones(g.n, np.float32),
                                                part.n))
    out[("md", "1d")] = _np(fn(ones, *arrs))[:g.n]
    rng = np.random.default_rng(0)
    pm = np.zeros((g.n, 4), np.float32)
    for b in range(4):
        pm[rng.integers(0, g.n), b] = 1.0
    out[("md", "1d_batched")] = (
        _np(fn(torch.from_numpy(pad_personalization(pm, part.n)),
               *arrs))[:g.n], pm)
    part2 = partition_2d(g, factor_grid(ws), lane=8)
    arrs2 = put_partition_2d(part2, m2)
    perm = col_layout_perm(part2.n, part2.grid)
    p_col = torch.from_numpy(pad_personalization(np.ones(g.n, np.float32),
                                                 part2.n)[perm])
    for key, cdt in (("2d", None), ("2d_bf16", torch.bfloat16)):
        reset_collective_counts()
        pi_col = _np(cpaa_distributed_2d(m2, part2, sched,
                                         comm_dtype=cdt)(p_col, *arrs2))
        pi = np.empty(part2.n, np.float32)
        pi[perm] = pi_col
        out[("md", key)] = (pi[:g.n], collective_counts())
    reset_collective_counts()
    return out


def selection_cases(ws: int) -> dict:
    g = GRAPHS["mesh"]()   # n = 99; the bars are lowered instead
    return {("auto", "low_bar"): select_engine(g, sharded_min_n=16, lane=4,
                                               device=CPU).name,
            ("auto", "between_bars"): select_engine(
                g, sharded_min_n=50, lane=4, device=CPU).name,
            ("auto", "default_bar"): select_engine(
                generators.tri_mesh(5, 5), device=CPU).name}


def serve_cases(ws: int, rank: int, tmp: Path) -> dict:
    """The service in lockstep: rank 0 leads, the others follow."""
    from repro_torch.serve.graph_registry import GraphRegistry
    from repro_torch.serve.pagerank_service import PageRankService, PPRQuery
    out = {}
    for mode, sched, async_dispatch in (("sharded-1d", "fifo", False),
                                        ("sharded-2d", "deadline", True)):
        g = generators.tri_mesh(8, 9)
        reg = GraphRegistry(device=CPU, engine=mode, partition_lane=4)
        rg = reg.register("g", g)
        eng0 = rg.engine
        # a sharded graph keeps no whole-graph DeviceGraph on any rank
        out[("serve", mode, "no_dg")] = [rg.dg is None]
        svc = PageRankService(reg, max_batch=4, cache_capacity=16,
                              max_top_k=8, scheduler=sched,
                              default_deadline_s=0.05
                              if sched == "deadline" else None,
                              async_dispatch=async_dispatch,
                              refresh_batch=2, invalidation_radius=1)
        if rank != 0:
            out[("serve", mode, "followed")] = svc.follow()
            out[("serve", mode, "epoch")] = rg.epoch
            out[("serve", mode, "no_dg")].append(rg.dg is None)
            continue
        answers = {}
        for i, seeds in enumerate(SERVE_SEEDS):
            svc.submit(PPRQuery(qid=i, graph="g", seeds=seeds, tol=1e-8,
                                top_k=8))
        for qid, r in svc.run_until_drained().items():
            answers[qid] = (r.indices, r.scores, r.epoch)
        epoch = svc.update_graph("g", insert=[(0, 60)])
        rebuilt = rg.engine is not eng0 and rg.engine.name == eng0.name
        for i, seeds in enumerate(SERVE_SEEDS_AFTER):
            svc.submit(PPRQuery(qid=100 + i, graph="g", seeds=seeds,
                                tol=1e-8, top_k=8))
        for qid, r in svc.run_until_drained().items():
            answers[qid] = (r.indices, r.scores, r.epoch)
        stats = svc.stats
        svc.close()
        out[("serve", mode, "no_dg")].append(rg.dg is None)
        out[("serve", mode)] = dict(answers=answers, epoch=epoch,
                                    rebuilt=rebuilt, stats=stats,
                                    engine=eng0.name,
                                    keys=np.asarray(rg.keys))
    # measured selection: rank 0 decides, every rank builds the same engine
    reg = GraphRegistry(device=CPU, engine="tuned", partition_lane=4,
                        tune_cache=str(tmp / "tuning.json"),
                        tune_budget_s=60.0)
    rg = reg.register("big", generators.tri_mesh(40, 40))
    entry = next(iter(reg.tuner.store.entries().values()), {})
    out[("tuned",)] = (rg.tuned_mode, rg.engine.name,
                       sorted(entry.get("candidates", {})))
    out[("tuned", "no_dg")] = (rg.dg is None,
                               isinstance(rg.engine, ShardedEngine))
    # the lockstep plans' channel: a gloo group of its own beside the
    # world's, which carries host objects only
    if ws > 1:
        grp = dist_mod.host_group()
        out[("host_group",)] = (torch.distributed.get_backend(grp),
                                grp is not torch.distributed.group.WORLD,
                                dist_mod.host_group() is grp)
    # the launcher: rank 0 runs the workload and alone prints
    from repro_torch.launch import serve as launch
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        st = launch.main(["--arch", "pagerank-serve", "--smoke",
                          "--requests", "6", "--updates", "1",
                          "--max-batch", "4", "--engine", "sharded-2d",
                          "--mesh-grid", f"1x{ws}", "--device", CPU])
    out[("launcher",)] = (st, buf.getvalue())
    return out


def digest(results: dict) -> str:
    h = hashlib.sha1()
    for key in sorted(k for k in results if k[0] in ("vec", "batched")):
        h.update(np.ascontiguousarray(results[key]).tobytes())
    return h.hexdigest()


def battery(ws: int, rank: int = 0, tmp: Path | None = None) -> dict:
    """Every case at world size `ws` (the process group is initialized).
    The serve cases need a scratch directory and run only with `tmp`."""
    out = solver_cases(ws)
    out.update(builder_cases(ws))
    out.update(selection_cases(ws))
    if tmp is not None:
        out.update(serve_cases(ws, rank, tmp))
    return out


def main(out_dir: str) -> int:
    torch.set_num_threads(1)
    out = Path(out_dir)
    dist_mod.init_process_group(CPU)
    ws, rank = dist_mod.world_size(), dist_mod.rank()
    res = battery(ws, rank, out)
    (out / f"rank{rank}.json").write_text(json.dumps(
        {"digest": digest(res),
         "followed": {k[1]: v for k, v in res.items()
                      if k[0] == "serve" and len(k) == 3
                      and k[2] == "followed"},
         "tuned": list(res[("tuned",)][:2]),
         "no_dg": {k[1]: v for k, v in res.items()
                   if k[0] == "serve" and len(k) == 3 and k[2] == "no_dg"},
         "launcher": [res[("launcher",)][0], res[("launcher",)][1]]},
        default=str))
    if rank == 0:
        with open(out / "results.pkl", "wb") as f:
            pickle.dump(res, f)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
