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
     bsr_spmm call, cheb_step on [n] and [n, B] at ragged sizes
     (rtol 1e-6), and embedding_bag's backward kernel at DLRM-RM2
     train_batch's shapes (recsys_batch ids at B = 65,536, the dense
     [33.7M, 64] gradient) against a float64 and the plain f32
     index_add_ (1e-4 of sum |terms| per element), untouched rows zero, a
     second launch bitwise; its time beside its bound, index_add_ and the
     dense zero fill, split into torch.sort and its two passes, with the
     passes' registers and spills;
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
     step and the peak device memory;
  6. slice D, the rest of the PPR serve tier:
     - on slice B's service (NACA0015 x10, fused), one 8-edge update
       batch: the re-tile keeps the BFS perm; its time and peak memory;
       the next tick vs the plain solve (L1 <= 1e-5);
     - `full_config()` (auto) under 32 seeded update batches, each
       followed by refresh ticks until the refresh queue is empty, between
       256 warm queries and 10% repeats + 128 fresh ones: answers and
       refreshed entries within 2 tol of a float64 solve on the graph of
       their epoch, a rebuild-mode twin within L1 1e-6, the patched device
       arrays bitwise equal to the host mirror; refresh ticks on naca must
       launch only bsr_spmm's FFMA variant, ticks after the updates the
       wgmma variant and cheb_step; host ms per update and per refreshed
       entry;
     - chunglu-1m (n = 10^6, m = 13,190,004; slice E's cache phase builds
       it) on engine auto (hub/tail):
       128 queries + 13 repeats at max_batch 128, 8 columns vs a float64
       power solve; hub/tail and COO at BT = 128 vs a float64 COO solve
       of the same recurrence (hub/tail L1 <= 1e-5; bf16 inv_deg <= 1e-3
       on a uniform personalization, the reference's case), one apply of
       each, the tick, peak memory and one update batch (a full hub/tail
       rebuild);
     - 256 queries through `full_config()` with FIFO or the deadline
       scheduler (a 50 ms tenant and one without a deadline), sync or
       async dispatch, adaptive or fixed rounds: answers against sync FIFO
       (rtol 1e-5 / atol 1e-6), drain wall time, deadline misses, held
       ticks.
  7. slice E, measured selection, observability, the dataset cache and
     the paper's baselines:
     - cache: `scale_dataset("chunglu-1m")` into an empty cache directory
       twice (build + save, then a memory map of the file); the mapped
       arrays bitwise equal to the build; the mapped graph registers
       (no aliasing upload, the file unchanged) and serves one tick whose
       answers are bitwise those of the fresh graph (deterministic
       algorithms on for those ticks);
     - tuned: a registry with engine "tuned" on a fresh store over
       `full_config()`'s graphs, NACA0015 x10 and chunglu-1m: each
       graph's candidates in us per round, the winner (held to
       `pick_winner`), auto's pick and any skipped candidate; the fused
       candidate's timing must launch wgmma `bsr_spmm` and `cheb_step`; a
       second registry on the same store makes zero measurements; the
       tuned service's answers on NACA0015 x10 within 2 tol of a float64
       solve;
     - obs: `full_config()` drained with metrics detail on and off, five
       interleaved rounds each (medians and ranges, printed, not gated);
       the detailed run's snapshot validates, every tick within the
       Formula 8 bound, the accounting holds, the solve_device spans are
       device-timed; one tick under `profiled` writes a Chrome trace that
       names both PPR kernels; the launcher runs once with --engine
       tuned, --metrics-json and --profile-dir (exit 0, valid snapshot);
     - paper: on NACA0015 x10 (fused, BT = 1, uniform p) CPAA at ERR <
       1e-3, power run to CPAA's L1 gap from a float64 solve, forward push
       at CPAA's round count (rounds, ms, L1, FFMA launches);
       monte_carlo and ortho_pagerank (three bases) against the dense
       oracle at the reference tests' bounds.
  8. slice F, the sharded engines over NCCL at world size 1 (`init_mesh`,
     a single-rank group; no kernel of their own, so no new kernel row):
     on NACA0015 x10 and chunglu-1m, Sharded1DEngine and Sharded2DEngine
     at grid (1, 1) through CPAA at ERR < 1e-3 at BT = 1 and 128, and the
     2D engine with the bf16 wire at BT = 1, each held to the COO solve
     (L1 <= 1e-5 per column; bf16 max rel < 2e-2 and >= 95% of the top
     decile) with the collective counters checked per solve; ms per apply
     beside COO's, the NCCL kernels' device time (torch.profiler),
     partition build seconds and memory; one tick of 128 queries through
     the service over sharded-1d (4 answers against a float64 solve); and
     `configs/pagerank_cpaa.smoke_run` on the card. At world size 1 NCCL
     moves no bytes between cards: this shows the engines and the cost
     of their collective calls on the card, not multi-card scaling.
  9. slice G, the GNN zoo training on the card (no kernel of its own:
     the reference passes messages with XLA gathers and segment ops):
     MeshGraphNet, PNA, DimeNet and GraphCast at their full_config()
     widths on minibatch_lg, full_graph_sm and molecule, G_STEPS AdamW
     steps each from generator seed 0 (finite, the loss falls), one step
     in float64 on the card against f32 (loss rel <= 1e-4, grad norm rel
     <= 1e-3; at minibatch_lg where twice the f32 peak fits the card, else
     at full_graph_sm), TF32 off; at minibatch_lg ms per step (CUDA
     events, after a warm-up step), peak memory and a profile of one step
     by kernel and by operator; then the train_gnn flow on chunglu-1m:
     CPAA PageRank through auto's engine, PNA full_config() widths on
     GraphBatchPipeline batches of 1,024 seeds with fanouts (15, 10) and
     the PPR weights, host ms per batch and device ms per step, an async
     checkpoint, and the replay of the next step bit for bit with
     deterministic algorithms on (the gap with atomics printed).
 10. slice H, the LM serve path (no kernel of its own: the reference's
     attention and MoE dispatch are XLA ops), bf16 compute, TF32 off,
     cuBLAS bf16 reductions in f32, random weights from generator seed 0:
     - gate 1: h2o-danube-1.8b at full width in float32, one request's
       engine tokens equal to naive greedy decoding by full forwards
       (each step's logit gap printed);
     - H1: danube through a ServeEngine of 32 slots x 8,192 positions
       (KV ~16.1 GB): 4 requests with 6,000-token prompts (past the 4,096
       window) and 64 with serve_lm's 3-15 token prompts, 16 new tokens
       each; ms per tick (CUDA events, median over the ticks with all 32
       slots busy) against the bytes bound (bf16 weights but the embedding
       + both whole caches, over 3.35 TB/s), prefill ms per request, tok/s,
       padding ids emitted; the same engine eagerly (no CUDA graph) with a
       profile by operator; gate 2: the first decode step of a short and a
       long prompt against a float64 forward within LOGIT_GAP_BF16 of max
       |logit|; batched vs solo (printed); a 3-tick profile; peak memory;
     - H3: one transformer.prefill of 32,768 tokens on danube: ms, peak;
     - H2: granite-moe-3b-a800m at 32 x 4,096 (KV ~8.6 GB), the short
       requests: the same numbers, MoE assignments dropped per tick, its
       prefill and first decode step against float64 (printed);
     - H4: the launcher, `--arch h2o-danube-1.8b` at full width;
     gate 3 throughout: every request ends with its budget (or at
     max_len) and every logit is finite.
 11. slice I, training on the card (bf16 compute, TF32 off, random
     weights from generator seed 0):
     - I1: h2o-danube-1.8b at full width, make_train_step(loss_fn,
       AdamWConfig(lr=I_LR), 8 microbatches, donated) on token_batch at
       8 x 1 x 4,096 (the published global batch of 256 cut to 8): a
       warm-up and 3 timed steps on 2 cycled batches (the loss falls),
       TFLOP/s of lm_train_flops against the bf16 dense peak, peak
       memory, a profile by operator of one step of one microbatch and
       the device's idle share estimated from it; gate I-b: the state cloned, one step,
       restored and replayed bitwise with deterministic algorithms on
       (the gap with atomics printed); gate I-a: one sequence of 512 with
       compute float32 against float64 (loss rel <= 1e-4, grad norm rel
       <= 1e-3; the bf16 loss printed);
     - I3: the launcher at full width (3 steps of 2 x 4,096), then
       --smoke --ckpt-dir twice (saves, resumes);
     - I2: granite-moe-3b-a800m at full width, 4 x 1 x 4,096, the same
       numbers and dropped MoE assignments per step, gate I-a;
     - I4: DLRM-RM2 full_config() at train_batch (B = 65,536): 5 AdamW
       steps (the loss falls), the first against a float64 step on the
       card (loss rel <= 1e-4, grad norm rel <= 1e-3), both embedding_bag
       counters equal to the steps, ms per step beside its bytes bound,
       AdamW's share, peak memory; after the steps one update from a
       seeded gradient, the table's elements past 2^31 bitwise the plain
       update of those rows, and AdamW alone, adamw_step and sum_squares
       over the leaves beside their bounds, plain versions,
       torch._fused_adamw_ and torch.linalg.vector_norm.
 12. slice J, the expert-parallel all-to-all MoE (no kernel of its own:
     the reference's packing and trips are XLA ops) over NCCL at world
     size 1 on a (1, 1) ("data", "model") mesh (`distributed.use_mesh`,
     ep = 1), bf16 compute, TF32 off:
     - granite-moe-3b-a800m at full width and depth on I2's weights, a
       fresh AdamW state: its train step with impl "a2a" beside the dense
       step, J_ROUNDS rounds of dense a2a a2a dense on one batch of
       4 x 1 x 4,096 (ms, peak, the a2a step's idle share), the
       capacities, dropped assignments per stage beside the dense path's,
       one trip's cost against a device copy; J-d: the trip counters show
       every MoE layer of every step ran the a2a path; J-b: f32 vs
       float64 at 1 x 512 at the config's capacity factor 1.25 (drops
       real; loss rel <= 1e-4, grad norm rel <= 1e-3); J-c: a second call
       (loss and every gradient leaf of 1 x 4,096) bitwise equal with
       deterministic algorithms on; J-a: a2a vs dense at capacity factor
       8 in f32 at 1 x 512, where neither drops (loss rel <= 1e-5, grad
       norm rel <= 1e-4);
     - qwen3-moe-235b-a22b's train_4k_a2a cell through
       `registry.get(...).cell_config`, full width cut to 2 of 94 layers:
       the loss of 1 x 4,096 and its gradient (ms, peaks, drops, trips)
       and J-a on uniform tokens.

 13. slice K, the dry-run tooling (`launch/{dryrun,analysis,roofline,
     mesh}.py`; no kernel of its own), TF32 off:
     - K-a: every registry cell, single-pod and multi-pod, through the
       dry-run's abstract pass under the production mesh (the plan's
       per-device argument bytes from the specs) and
       the card's (1, 1) mesh (a skip only for "does not fit", naming
       both byte counts): every plan on meta tensors, no error, the fit
       table printed; qwen2.5-32b, qwen3-moe-235b-a22b and deepseek-7b's
       train_4k must not fit;
     - K-b: `run_cell(..., mesh="card")` at full width on dlrm-rm2
       serve_p99, serve_bulk, retrieval_cand and train_batch, pna
       molecule, cpaa-pagerank pr_mesh_67m (463M edges, NCCL world size
       1) and h2o-danube-1.8b long_500k (32.2 GB of bf16 KV cache): each
       ok, counted FLOPs and bytes > 0, embedding_bag launched on the
       three DLRM kernel cells and its backward on train_batch, no
       roofline term above 1.05 x the measured step (median of 3, CUDA
       events);
     - K-c: `launch/roofline.py` renders K's records, one roofline row
       per K-b cell;
     - K-d (in slice I3): the training launcher prints its elastic mesh,
       "mesh: (1, 1) over 1 device(s)".
 14. slice L, the static analysis and the examples (no kernel of its own;
     `analysis/{sanitize,retrace}.py`, `launch/{quickstart,serve_pagerank,
     serve_lm,distributed_pagerank}.py`):
     - L-a (right after slice A, on its service): a warm second drain of
       L_QUERIES fresh queries through `full_config()` under
       `sanitize.applied({"debug_nans": True, "sync_debug_mode": "warn"})`:
       no NaN reported, answers within 2 tol of the float64 solve,
       bsr_spmm and cheb_step launched, a deliberate `.item()` in the
       block reported by the sync mode; the synchronizing operations per
       tick with their top call sites, the ops the NaN mode checked and
       the drain's time beside slice A's;
     - L-b: slice A's drain and L-a's inside `RetraceGate()` (zero
       events), slice H's ticks after each engine's capture inside the
       gate (zero events; H1 and H2), and a fresh smoke-size danube
       engine's first tick inside a gate raises `RetraceError` naming a
       NEW capture signature;
     - L-c: `python -m repro_torch.analysis --strict` exits 0;
     - L-d: the four examples on the card: quickstart (CPAA max rel err vs
       the dense solve <= 1e-4), serve_pagerank (24 answers, the repeat
       cached, one invalidation round, the re-query on epoch 1), serve_lm
       (every request drained) and distributed_pagerank at NCCL world size
       1 (1D and 2D rel err <= 1e-5 vs the single-device solve).
 15. slice M, tensor and FSDP parallelism under the reference's sharding
     plans (`distributed/{sharding,parallel}.py`, the sharded models, the
     window variants of both embedding_bag kernels), and the GNNs'
     partitioned message passing and the rank-local CPAA steps (no kernel
     of their own: the reference runs them on XLA ops):
     - M-a: the production dry-run (`run_cell(...,
       mesh="production")`) of every dlrm-rm2, h2o-danube-1.8b,
       granite-moe-3b-a800m, meshgraphnet, pna, dimenet, graphcast and
       cpaa-pagerank cell on the (16, 16) and (2, 16, 16) meshes
       of a fake world in this process, on meta tensors: each ok (or its
       cell's own skip), argument bytes equal to `per_device_bytes`;
       prints per-device argument, peak temp and total bytes, the fit on
       this card, the compute / memory / collective terms and the
       collective bytes by axis (the LM train and prefill counts from the
       reference's probe extrapolation);
     - M-b: rank 0 and rank 255 of the (16, 16) mesh on the card with real
       local shards and collectives that move nothing: DLRM-RM2
       train_batch (one step after a warm-up, CUDA events, one rank's
       device work and no collective time), both window kernels launched
       in the step and held at the rank's window of the real 8.64 GB
       table (lookup bitwise, ids outside giving 0; backward <= 1e-4 of
       sum |terms| vs float64, unread rows 0, bitwise again; their
       device time, queued behind a spin kernel, beside their plain
       versions and bounds); danube train_4k's rank 0, one step and its
       own peak memory; rank 0 of meshgraphnet ogb_products (9,568 nodes
       and 241,640 edges, the all-gathered h 1.25 GB a layer) and of cpaa
       pr_mesh_67m_2d (1,808,896 edges, vectors of 4,194,304 rows), each
       from its plan's `make_args` pieces: one step after a warm-up (CUDA
       events) and its own peak memory;
     - M-c: a (1, 1) NCCL mesh at world size 1, deterministic algorithms
       on: one sharded DLRM-RM2 step (full table, batch 8,192), one
       sharded danube step (full width, 2 layers, 1 x 512, f32) and one
       sharded PNA molecule step (the plan's layout, the GNN gradient
       sum) give the unsharded step's loss to rel <= 1e-6.

Each main path runs with the kernels' launch counters set to 0 just
before and read just after; a kernel of the path that was not launched
fails the run. Every training path (I1, I2, I4, J, G's steps, M-b, M-c)
must launch adamw_step and sum_squares once per leaf and step each, with
no copy of a non-contiguous gradient. The line before the last is the
kernel table as JSON; the last line is {"ok": true, "device": {...}}.
Any failed phase exits non-zero without that line.
"""
from __future__ import annotations

import json
import os
import re
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


CARD = "?"     # nvidia-smi's "name, power.limit" of the card (phase 1)


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
    from repro_torch.kernels.adamw import ops as adamw_ops
    from repro_torch.kernels.bsr_spmm import ops as bsr_ops
    from repro_torch.kernels.cheb_step import ops as cheb_ops
    from repro_torch.kernels.embedding_bag import ops as eb_ops
    bsr_ops.reset_launches()
    cheb_ops.reset_launches()
    eb_ops.reset_launches()
    adamw_ops.reset_launches()
    engine.reset_apply_counts()


def read_counts() -> dict:
    from repro_torch.core import engine
    from repro_torch.kernels.adamw import ops as adamw_ops
    from repro_torch.kernels.bsr_spmm import ops as bsr_ops
    from repro_torch.kernels.cheb_step import ops as cheb_ops
    from repro_torch.kernels.embedding_bag import ops as eb_ops
    return {"bsr_spmm": bsr_ops.launches(), "cheb_step": cheb_ops.launches(),
            "embedding_bag": eb_ops.launches(),
            "embedding_bag_backward": eb_ops.backward_launches(),
            "embedding_bag_window": eb_ops.window_launches(),
            "embedding_bag_window_backward":
                eb_ops.window_backward_launches(),
            "embedding_bag_window_sort": eb_ops.window_sort_launches(),
            "adamw_step": adamw_ops.step_launches(),
            "sum_squares": adamw_ops.norm_launches(),
            "adamw_copies": adamw_ops.contiguous_copies(),
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
    global CARD
    CARD = smi.stdout.strip().splitlines()[0]
    log(CARD)
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


ADAMW_HYPER = {"lr": 3e-4, "b1": 0.9, "b2": 0.95, "eps": 1e-8,
               "weight_decay": 0.1}
NORM_TOL = 1e-6        # sum_squares vs a float64 sum, relative


def compare_adamw() -> dict:
    """adamw_step bitwise its plain version on the card for every dtype
    combination it takes (p, g, m and v; the f64 one with an f64 scale),
    in place and out of place, at an odd length on views one element off
    the 16-byte boundary (the scalar pass) and at 2^22 + 3 (vector and
    tail); sum_squares in f32 and f64 within NORM_TOL of a float64 sum
    and bitwise from one call to the next, at odd lengths, offset views
    and 2^26 + 5. Returns the worst errors."""
    import torch
    from repro_torch.kernels.adamw.ops import adamw_step, sum_squares
    from repro_torch.kernels.adamw.ref import adamw_step_ref
    f32, f64, bf16 = torch.float32, torch.float64, torch.bfloat16
    dtypes = {"f32": (f32, f32, f32), "f32_bf16": (f32, f32, bf16),
              "f64_g32": (f64, f32, f32), "f64": (f64, f64, f32),
              "f64_bf16": (f64, f64, bf16)}
    gen = torch.Generator(device="cuda").manual_seed(5)

    def rand(n, off, dtype, scale, positive=False):
        x = torch.randn(n + off, device="cuda", generator=gen) * scale
        return (x.abs() if positive else x).to(dtype)[off:]
    cases, step_err = 0, 0.0
    for combo, (pd, gd, md) in dtypes.items():
        stepf = torch.tensor(3.0, device="cuda")
        scale = torch.tensor(0.37, device="cuda",
                             dtype=f64 if combo == "f64" else f32)
        bc1 = 1.0 - torch.pow(torch.tensor(0.9, device="cuda"), stepf)
        bc2 = 1.0 - torch.pow(torch.tensor(0.95, device="cuda"), stepf)
        for n, off in ((4099, 1), ((1 << 22) + 3, 0)):
            for in_place in (False, True):
                p, g, m, v = (rand(n, off, pd, 1.0), rand(n, off, gd, 3.0),
                              rand(n, off, md, 0.1),
                              rand(n, off, md, 0.01, positive=True))
                want = adamw_step_ref(p, g, m, v, scale, bc1, bc2,
                                      **ADAMW_HYPER)
                got = adamw_step(p, g, m, v, scale, bc1, bc2,
                                 in_place=in_place, **ADAMW_HYPER)
                torch.cuda.synchronize()
                err = max(float((a.double() - b.double()).abs().max())
                          for a, b in zip(got, want))
                check(all(a.dtype == b.dtype and torch.equal(a, b)
                          for a, b in zip(got, want)),
                      f"adamw_step {combo} n={n} offset {off} in_place "
                      f"{in_place}: kernel vs plain not bitwise (max |err| "
                      f"{err:.3e})")
                cases += 1
                step_err = max(step_err, err)
                del p, g, m, v, want, got
    norm_rel, norm_abs = 0.0, 0.0
    for dtype in (f32, f64):
        for n, off in ((7, 1), (4099, 1), (16_385, 0), ((1 << 26) + 5, 0)):
            x = rand(n, off, dtype, 1.0)
            a, b = sum_squares(x), sum_squares(x)
            want = float(x.double().square().sum())
            check(a.dtype == dtype and torch.equal(a, b),
                  f"sum_squares {dtype} n={n}: two calls differ "
                  f"({float(a)!r}, {float(b)!r})")
            err = abs(float(a) - want)
            check(err <= NORM_TOL * want, f"sum_squares {dtype} n={n}: "
                  f"{float(a)!r} vs float64 {want!r} (rel {err / want:.3e})")
            norm_rel = max(norm_rel, err / want)
            norm_abs = max(norm_abs, err)
            del x
    log(f"adamw_step: {cases} cases ({len(dtypes)} dtype "
        "combinations, in place and new, n 4,099 on offset views and "
        "2^22 + 3) bitwise its plain version; sum_squares f32 and f64 at n "
        f"7 .. 2^26 + 5: max rel err vs float64 {norm_rel:.3e} (limit "
        f"{NORM_TOL:g}), two calls bitwise")
    return {"adamw_step": step_err, "sum_squares": norm_abs,
            "sum_squares_rel": norm_rel}


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
    adamw = compare_adamw()
    return {"bsr_spmm": worst, "cheb_step": cheb_err, "dyn_range": wit,
            "host_us": host_us, "adamw": adamw}


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
    from repro_torch.analysis.retrace import RetraceGate
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
    with RetraceGate() as gate:         # L-b: the PPR path compiles nothing
        results, st, secs = drive(svc, queries, repeats)
    counts = read_counts()
    log(f"L-b: slice A's drain under RetraceGate: {len(gate.events)} "
        "compile events")
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
    return {"launches": counts, "oracle_err": err, "stats": st, "svc": svc,
            "cfg": cfg, "drain_s": secs[0], "n_queries": len(queries)}


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
    del x, p, eng
    return {
        "svc": svc,     # slice D's paper-size refresh reuses the build
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


# ---------------------------------------------------------------- slice D --
def count_delta(before: dict, after: dict) -> dict:
    """Kernel launches between two `read_counts()` snapshots."""
    out = {"bsr_spmm": after["bsr_spmm"] - before["bsr_spmm"],
           "cheb_step": after["cheb_step"] - before["cheb_step"]}
    for k, v in after["bsr_spmm_variants"].items():
        out[k] = v - before["bsr_spmm_variants"][k]
    return out


ADAMW_KEYS = ("adamw_step", "sum_squares", "adamw_copies")
ADAMW_PATHS: dict = {}   # path -> AdamW launches its gates counted


def adamw_delta(before: dict, after: dict) -> dict:
    """The AdamW kernels' launches (and g copies) between two
    `read_counts()` snapshots."""
    return {k: after[k] - before[k] for k in ADAMW_KEYS}


def gate_adamw(path: str, label: str, n: dict, leaves: int,
               steps: int) -> None:
    """Fail unless `steps` AdamW updates of `leaves` leaves launched the
    update and the norm kernel once per leaf and step each, with no copy
    of a non-contiguous g; add them to ADAMW_PATHS[path]."""
    want = leaves * steps
    log(f"{label}: AdamW launches {n['adamw_step']} update, "
        f"{n['sum_squares']} norm, {n['adamw_copies']} copies of g "
        f"({leaves} leaves x {steps} steps = {want})")
    check(n["adamw_step"] == want and n["sum_squares"] == want
          and n["adamw_copies"] == 0,
          f"{label}: AdamW launches {n} for {leaves} leaves x {steps} "
          "steps")
    acc = ADAMW_PATHS.setdefault(path, dict.fromkeys(ADAMW_KEYS, 0))
    for k in ADAMW_KEYS:
        acc[k] += n[k]


def add_counts(*parts) -> dict:
    """Sum of `read_counts()` results of several main paths."""
    flat = ("bsr_spmm", "cheb_step", "embedding_bag",
            "embedding_bag_backward")
    out = dict.fromkeys(flat, 0) | {"bsr_spmm_variants": {}, "applies": {}}
    for c in parts:
        for key in flat:
            out[key] += c.get(key, 0)
        for key in ("bsr_spmm_variants", "applies"):
            for k, v in c[key].items():
                out[key][k] = out[key].get(k, 0) + v
    return out


def update_batches(svc, count: int, seed: int) -> list:
    """`count` edge-update batches alternating over the registry's graphs,
    each edge drawn as the serve launcher draws it (u in the lower half of
    the ids, v in the upper): 1-8 inserts per batch, and every other batch
    of a graph also deletes 1-3 edges an earlier batch of it inserted."""
    rng = np.random.default_rng(seed)
    names = svc.registry.names()
    inserted = {nm: [] for nm in names}
    out = []
    for b in range(count):
        nm = names[b % len(names)]
        n = svc.registry.get(nm).n
        ins = [(int(rng.integers(0, n // 2)), int(rng.integers(n // 2, n)))
               for _ in range(int(rng.integers(1, 9)))]
        dele = []
        if (b // len(names)) % 2 == 1 and inserted[nm]:
            for _ in range(min(len(inserted[nm]), int(rng.integers(1, 4)))):
                dele.append(inserted[nm].pop(
                    int(rng.integers(0, len(inserted[nm])))))
        inserted[nm].extend(ins)
        out.append((nm, ins, dele))
    return out


def ppr_oracle(g, c: float):
    """seeds -> float64 x = (1 - c)(I - cP)^{-1} p (p uniform over the
    seeds) by one sparse LU of I - cP."""
    import scipy.sparse as sp
    from scipy.sparse.linalg import splu
    deg = np.maximum(g.deg, 1).astype(float)
    P = sp.csc_matrix((1.0 / deg[g.src], (g.dst, g.src)), shape=(g.n, g.n))
    lu = splu(sp.identity(g.n, format="csc") - c * P)

    def solve(seeds):
        p = np.zeros(g.n)
        p[list(seeds)] = 1.0 / len(seeds)
        return (1.0 - c) * lu.solve(p)
    return solve


def answer_err(idx, scores, x) -> float:
    return float(np.max(np.abs(np.asarray(scores) - x[np.asarray(idx)])))


def mirror_matches_device(rg) -> bool:
    """The patched device arrays equal the host mirror, the weights cast
    as `device_graph` casts them, bit for bit."""
    import torch
    es, dg = rg.slots, rg.dg
    inv = torch.from_numpy(1.0 / np.maximum(es.deg, 1))
    return (torch.equal(dg.src.cpu(), torch.from_numpy(es.src))
            and torch.equal(dg.dst.cpu(), torch.from_numpy(es.dst))
            and torch.equal(dg.w.cpu(),
                            torch.from_numpy(es.w64).to(dg.w.dtype))
            and torch.equal(dg.inv_deg.cpu(), inv.to(dg.inv_deg.dtype)))


def solve_columns(eng, n: int, seeds):
    """cpaa at tol 1e-6 of one column per seed vertex (L1 parity probe)."""
    import torch
    from repro_torch.core.pagerank import cpaa
    p = torch.zeros(n, len(seeds), device="cuda")
    p[torch.tensor(seeds, device="cuda"),
      torch.arange(len(seeds), device="cuda")] = 1.0
    return cpaa(eng, tol=1e-6, p=p).pi


def phase_slice_d_updates() -> dict:
    """Slice D's update stream at `full_config()` (auto engines, the
    config's incremental updates, invalidation radius 2, refresh batch 8):
    256 seeded queries, 32 batches each followed by refresh ticks until the
    refresh queue is empty, then 10% repeats and 128 fresh queries. A
    second service in update_mode "rebuild" takes the same batches."""
    import torch
    from dataclasses import replace
    from repro_torch.configs.pagerank_serve import full_config, make_service
    from repro_torch.serve.pagerank_service import PPRQuery
    cfg = full_config()
    svc = make_service(cfg, device="cuda")
    svc_r = make_service(replace(cfg, update_mode="rebuild"), device="cuda")
    engines = {nm: type(svc.registry.get(nm).engine).__name__
               for nm in svc.registry.names()}
    queries = seeded_queries(svc, 256, seed=20, top_k=8)
    batches = update_batches(svc, 32, seed=21)
    reset_counts()
    results = {}
    for q in queries:
        svc.submit(q)
    results.update(svc.run_until_drained())
    torch.cuda.synchronize()
    refresh = {"bsr_spmm": 0, "cheb_step": 0, "ffma": 0, "wgmma_3xtf32": 0}
    upd_ms = {nm: [] for nm in svc.registry.names()}
    refresh_s, refreshed, refresh_err, refresh_checked = 0.0, 0, 0.0, 0
    for nm, ins, dele in batches:
        t0 = time.perf_counter()
        svc.update_graph(nm, insert=ins, delete=dele)
        torch.cuda.synchronize()
        upd_ms[nm].append((time.perf_counter() - t0) * 1e3)
        svc_r.update_graph(nm, insert=ins, delete=dele)
        keys = list(svc._refresh)
        before = read_counts()
        done0 = svc.stats["refreshes"]
        t0 = time.perf_counter()
        for _ in range(len(keys) + 1):      # refresh until the queue empties
            if not svc._refresh:
                break
            svc.refresh_tick()
        torch.cuda.synchronize()
        refresh_s += time.perf_counter() - t0
        refreshed += svc.stats["refreshes"] - done0
        for k, v in count_delta(before, read_counts()).items():
            refresh[k] += v
        check(not svc._refresh, "slice D: the refresh queue did not empty")
        rg = svc.registry.get(nm)
        live = [k for k in keys if k[1] == rg.epoch and
                svc.cache.get(k, count=False) is not None][:4]
        if live:
            solve = ppr_oracle(rg.host, cfg.c)
            for key in live:
                idx, scores = svc.cache.get(key, count=False)
                err = answer_err(idx, scores, solve(key[2]))
                check(err <= 2 * cfg.tol, f"slice D: refreshed entry {key} "
                      f"{err:.3e} from the oracle at epoch {rg.epoch}")
                refresh_err = max(refresh_err, err)
                refresh_checked += 1
    repeats = repeats_of(queries, len(queries) // 10)
    fresh = [PPRQuery(qid=1000 + q.qid, graph=q.graph, seeds=q.seeds,
                      top_k=q.top_k)
             for q in seeded_queries(svc, 128, seed=22, top_k=8)]
    before = read_counts()
    for q in repeats + fresh:
        svc.submit(q)
    results.update(svc.run_until_drained())
    torch.cuda.synchronize()
    after_updates = count_delta(before, read_counts())
    counts = read_counts()
    st = svc.stats
    check(len(results) == len(queries) + len(repeats) + len(fresh),
          "slice D: not every query answered")
    check(st["queries"] == st["cache_hits"] + st["solved_queries"]
          + st["dropped_queries"], "slice D: disposition accounting broken")
    for key in ("incremental_updates", "cache_retained", "refreshes"):
        check(st[key] > 0, f"slice D: {key} is 0: {st}")

    # every final answer against the oracle on the graph it was served at
    worst = 0.0
    by_graph = {}
    for q in repeats + fresh:
        by_graph.setdefault(q.graph, []).append(q)
    for nm, qs in by_graph.items():
        rg = svc.registry.get(nm)
        solve = ppr_oracle(rg.host, cfg.c)
        for q in qs:
            r = results[q.qid]
            check(r.epoch == rg.epoch, f"slice D q{q.qid}: stale epoch")
            err = answer_err(r.indices, r.scores, solve(q.seeds))
            check(err <= 2 * cfg.tol, f"slice D {nm} q{q.qid}: |answer - "
                  f"oracle| {err:.3e} > 2 tol (cached {r.cached})")
            worst = max(worst, err)

    # incremental against rebuild, and the patched arrays against the mirror
    l1_rebuild, mirrors = {}, {}
    for nm in svc.registry.names():
        rg, rr = svc.registry.get(nm), svc_r.registry.get(nm)
        check(np.array_equal(rg.keys, rr.keys),
              f"slice D {nm}: incremental and rebuild key sets differ")
        seeds = [int(s) for s in np.linspace(0, rg.n - 1, 8)]
        a = solve_columns(rg.engine, rg.n, seeds)
        b = solve_columns(rr.engine, rr.n, seeds)
        l1_rebuild[nm] = float((a - b).abs().sum(dim=0).max())
        check(l1_rebuild[nm] <= 1e-6, f"slice D {nm}: incremental vs "
              f"rebuild L1 {l1_rebuild[nm]:.3e} > 1e-6")
        mirrors[nm] = rg.slots is not None and mirror_matches_device(rg)
        check(mirrors[nm], f"slice D {nm}: device arrays differ from the "
              "host mirror")
    log(f"slice D update stream: engines {engines}; stats {st}")
    check(engines == {"naca": "FusedBlockEllEngine", "kmer": "CooEngine"},
          f"slice D: auto picked {engines}")
    med = {nm: float(np.median(v)) for nm, v in upd_ms.items()}
    log("slice D: host ms per update batch (median of "
        + ", ".join(f"{nm} {len(v)}" for nm, v in upd_ms.items())
        + "): " + ", ".join(f"{nm} {v:.3f} ms" for nm, v in med.items())
        + f"; {refreshed} refreshed entries at "
        f"{refresh_s * 1e3 / max(refreshed, 1):.3f} ms each")
    log(f"slice D launches: refresh ticks {refresh}; ticks after the "
        f"updates {after_updates}; whole path {counts}")
    check(refresh["ffma"] > 0 and refresh["wgmma_3xtf32"] == 0
          and refresh["cheb_step"] == 0, f"slice D: refresh ticks on naca "
          f"are not all FFMA bsr_spmm without cheb_step: {refresh}")
    check(after_updates["wgmma_3xtf32"] > 0 and after_updates["cheb_step"]
          > 0, f"slice D: ticks after the updates missed a kernel: "
          f"{after_updates}")
    log(f"slice D: max |answer - float64 oracle| {worst:.3e} over the final "
        f"answers, {refresh_err:.3e} over {refresh_checked} refreshed "
        f"entries (bound 2 tol = 2e-04); incremental vs rebuild L1 "
        + ", ".join(f"{k} {v:.3e}" for k, v in l1_rebuild.items())
        + " (bound 1e-6); patched arrays equal the host mirror bitwise")
    del svc, svc_r
    return {"launches": counts, "update_ms": med, "refreshed": refreshed}


def float64_ppr(g, c: float, seeds_list, iters: int = 100) -> np.ndarray:
    """[n, len(seeds_list)] float64 PPR by `iters` power rounds on scipy
    (error below c^iters in L1; an LU of a scale-free graph fills in)."""
    import scipy.sparse as sp
    deg = np.maximum(g.deg, 1).astype(float)
    P = sp.csr_matrix((1.0 / deg[g.src], (g.dst, g.src)), shape=(g.n, g.n))
    p = np.zeros((g.n, len(seeds_list)))
    for j, seeds in enumerate(seeds_list):
        p[list(seeds), j] = 1.0 / len(seeds)
    x = p.copy()
    for _ in range(iters):
        x = c * (P @ x) + (1.0 - c) * p
    return x


def phase_slice_d_scale(g, gen_s: float) -> dict:
    """chunglu-1m (`g`, built by slice E's cache phase in `gen_s` seconds)
    on engine auto (hub/tail) through the service at max_batch 128;
    hub/tail against COO on the card, f32 and bf16."""
    import torch
    from repro_torch.core.engine import CooEngine, HubTailEngine
    from repro_torch.core.pagerank import cpaa_fixed
    from repro_torch.graph.ops import device_graph
    from repro_torch.serve import GraphRegistry, PageRankService
    check(g.n == 1_000_000 and g.m == 13_190_004,
          f"slice D: chunglu-1m is n={g.n} m={g.m}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    reg = GraphRegistry(device="cuda", batch_hint=128)
    rg = reg.register("chunglu", g)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    eng = rg.engine
    check(isinstance(eng, HubTailEngine), f"slice D: auto picked "
          f"{type(eng).__name__} on chunglu-1m")
    hub_edges = int(eng.panel_cols.numel())
    log(f"slice D: chunglu-1m n={g.n} m={g.m} generated in {gen_s:.2f} s, "
        f"registered in {build_s:.2f} s: {eng.n_hubs} hubs, "
        f"{eng.panel_cols.shape[0]} panels of {eng.panel_width} "
        f"({hub_edges} slots), {eng.tail_src.numel()} tail edges; peak "
        f"{torch.cuda.max_memory_allocated()} bytes")
    svc = PageRankService(reg, max_batch=128, cache_capacity=65536,
                          max_top_k=32, adaptive=True)
    queries = seeded_queries(svc, 128, seed=30, top_k=32)
    repeats = repeats_of(queries, 13)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    ev0.record()
    results, st, secs = drive(svc, queries, repeats)
    ev1.record()
    torch.cuda.synchronize()
    counts = read_counts()
    tick_ms = ev0.elapsed_time(ev1)
    peak = torch.cuda.max_memory_allocated()
    log(f"slice D chunglu-1m: stats {st}; applies {counts['applies']}; tick "
        f"{tick_ms:.1f} ms between CUDA events ({secs[0] * 1e3:.1f} ms host) "
        f"for {st['rounds_used']} rounds; peak device memory {peak} bytes")
    check(st["solves"] == 1 and st["cache_hits"] == len(repeats),
          f"slice D chunglu-1m: expected one tick and {len(repeats)} hits")
    check(counts["applies"].get("hub_tail", 0) == st["rounds_used"],
          f"slice D chunglu-1m: the tick did not run on hub/tail: {counts}")
    x = float64_ppr(g, 0.85, [q.seeds for q in queries[:8]])
    worst = 0.0
    for j, q in enumerate(queries[:8]):
        r = results[q.qid]
        err = answer_err(r.indices, r.scores, x[:, j])
        check(err <= 2e-4, f"slice D chunglu-1m q{q.qid}: |answer - "
              f"oracle| {err:.3e} > 2 tol")
        worst = max(worst, err)
    del x

    # hub/tail (f32, bf16) and COO over the registry's padded device graph
    # at BT = 128, held to a float64 COO solve of the same recurrence (16
    # columns): COO's f32 sums over hub rows of tens of thousands of
    # in-edges drift further from float64 than the panels' row sums do
    p = personalization(svc, queries, 128)
    sched, coeffs = reg.schedule(0.85, 1e-4)
    coo = CooEngine(rg.dg)
    pi_c, _ = cpaa_fixed(coo, coeffs, p, rounds=sched.rounds)
    pi_h, _ = cpaa_fixed(eng, coeffs, p, rounds=sched.rounds)
    l1_hc = float((pi_h - pi_c).abs().sum(dim=0).max())
    f64 = CooEngine(device_graph(g, torch.float64, device="cuda"))
    c64 = coeffs.double()
    cols = 16
    pi_d, _ = cpaa_fixed(f64, c64, p[:, :cols].double(), rounds=sched.rounds)

    def l1_f64(pi):
        return float((pi[:, :cols].double() - pi_d).abs().sum(dim=0).max())
    l1_h, l1_c = l1_f64(pi_h), l1_f64(pi_c)
    del pi_h, pi_c
    t0 = time.perf_counter()
    eng_bf = HubTailEngine.from_graph(g, weight_dtype=torch.bfloat16,
                                      device="cuda")
    bf_build_s = time.perf_counter() - t0
    pi_b, _ = cpaa_fixed(eng_bf, coeffs, p, rounds=sched.rounds)
    l1_b = l1_f64(pi_b)
    # the reference's bf16 bound is stated for a uniform personalization
    # (tests/test_hub_tail.py); seeded columns are printed beside it
    u = torch.full((g.n,), 1.0 / g.n, device="cuda")
    pu_b, _ = cpaa_fixed(eng_bf, coeffs, u, rounds=sched.rounds)
    pu_d, _ = cpaa_fixed(f64, c64, u.double(), rounds=sched.rounds)
    l1_bu = float((pu_b.double() - pu_d).abs().sum())
    del pi_b, pi_d, pu_b, pu_d, eng_bf, f64
    check(l1_h <= 1e-5, f"slice D chunglu-1m: hub/tail vs float64 L1 "
          f"{l1_h:.3e}")
    check(l1_bu <= 1e-3, f"slice D chunglu-1m: bf16 hub/tail vs float64 L1 "
          f"{l1_bu:.3e} (uniform p)")
    torch.cuda.reset_peak_memory_stats()
    ht_ms = time_ms(lambda: eng.apply(p), 5)
    ht_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    coo_ms = time_ms(lambda: coo.apply(p), 3)
    coo_peak = torch.cuda.max_memory_allocated()
    log(f"slice D chunglu-1m: |answer - float64 oracle| {worst:.3e} over 8 "
        f"columns (bound 2e-04); L1 per column against a float64 COO solve "
        f"of the same 16-round recurrence ({cols} columns): hub/tail f32 "
        f"{l1_h:.3e} (bound 1e-5), COO f32 {l1_c:.3e}, hub/tail bf16 "
        f"{l1_b:.3e} (uniform p {l1_bu:.3e}, bound 1e-3; built in "
        f"{bf_build_s:.2f} s); hub/tail vs COO {l1_hc:.3e} over 128 "
        f"columns; one apply at BT=128: hub/tail {ht_ms:.3f} ms (peak "
        f"{ht_peak} bytes), COO {coo_ms:.3f} ms (peak {coo_peak} bytes)")
    del coo
    rng = np.random.default_rng(31)
    ins = [(int(rng.integers(0, g.n // 2)), int(rng.integers(g.n // 2, g.n)))
           for _ in range(8)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    svc.update_graph("chunglu", insert=ins)
    torch.cuda.synchronize()
    upd_s = time.perf_counter() - t0
    check(isinstance(rg.engine, HubTailEngine) and rg.epoch == 1,
          "slice D chunglu-1m: the update did not rebuild hub/tail")
    r = svc.query("chunglu", queries[0].seeds, top_k=32)
    check(np.all(np.isfinite(r.scores)) and r.epoch == 1,
          "slice D chunglu-1m: bad answer after the update")
    log(f"slice D chunglu-1m: one update batch of 8 edges (in-place patch "
        f"+ full hub/tail rebuild) {upd_s * 1e3:.1f} ms host")
    del svc, reg, rg, eng, p
    torch.cuda.empty_cache()
    return {"launches": counts, "tick_ms": tick_ms, "ht_ms": ht_ms,
            "coo_ms": coo_ms, "l1_f64": l1_h, "l1_coo": l1_hc,
            "update_s": upd_s, "peak": peak}


def phase_slice_d_paper_refresh(svc) -> dict:
    """One 8-edge update batch on slice B's NACA0015 x10 (fused): the re-tile
    keeps the BFS perm, then one tick checked against the plain solve."""
    import torch
    from repro_torch.core.pagerank import cpaa_adaptive_fixed
    rg = svc.registry.get("naca")
    perm0 = rg.engine.perm.clone()
    rng = np.random.default_rng(40)
    n = rg.n
    ins = [(int(rng.integers(0, n // 2)), int(rng.integers(n // 2, n)))
           for _ in range(8)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    svc.update_graph("naca", insert=ins)
    torch.cuda.synchronize()
    upd_s = time.perf_counter() - t0
    upd_peak = torch.cuda.max_memory_allocated()
    eng = rg.engine
    check(rg.last_update_incremental, "slice D paper: not incremental")
    check(torch.equal(eng.perm, perm0), "slice D paper: the BFS perm was "
          "not reused")
    del perm0
    queries = seeded_queries(svc, 128, seed=41, top_k=32)
    solves0 = svc.stats["solves"]
    reset_counts()
    results, st, secs = drive(svc, queries, [])
    counts = read_counts()
    check(st["solves"] == solves0 + 1, "slice D paper: expected one tick")
    check(counts["bsr_spmm_variants"]["wgmma_3xtf32"] > 0 and
          counts["cheb_step"] > 0, f"slice D paper: a kernel of the tick "
          f"was not launched: {counts}")
    p = personalization(svc, queries, 128)
    plan = svc.registry.adaptive_schedule(0.85, 1e-4)
    pi_k, _, cols_k, _ = cpaa_adaptive_fixed(
        eng, p, plan.c, plan.tol, max_rounds=plan.max_rounds,
        chunk=plan.chunk)
    pi_p, _, cols_p, _ = cpaa_adaptive_fixed(
        eng.with_kernels(False), p, plan.c, plan.tol,
        max_rounds=plan.max_rounds, chunk=plan.chunk)
    l1 = float((pi_k - pi_p).abs().sum(dim=0).max())
    check(torch.equal(cols_k, cols_p) and l1 <= 1e-5, f"slice D paper: "
          f"kernel vs plain solve after the update L1 {l1:.3e}")
    log(f"slice D paper: update of 8 edges on NACA0015 x10 (patch, hop BFS, "
        f"re-tile with the kept perm, 4.26 GB upload) {upd_s:.2f} s host, "
        f"peak device memory {upd_peak} bytes; next tick "
        f"{secs[0] * 1e3:.1f} ms host, launches {counts}; kernel vs plain "
        f"L1 {l1:.3e}")
    del pi_k, pi_p, p, eng
    return {"launches": counts, "update_s": upd_s, "l1": l1,
            "peak": upd_peak}


def phase_slice_d_scheduler() -> dict:
    """The same queries (alternating an "interactive" tenant with a 50 ms
    deadline and a "batch" tenant without one) through `full_config()`'s
    graphs eight ways: FIFO or deadline scheduler, sync or async dispatch,
    adaptive or fixed rounds, five rounds of the eight interleaved (drain
    wall times as median and range). Each answer is held to sync FIFO in
    the same round mode: scores rtol 1e-5 / atol 1e-6, ids equal at every
    rank that no score within 1e-6 could swap."""
    import torch
    from dataclasses import replace
    from repro_torch.configs.pagerank_serve import full_config, make_service
    from repro_torch.serve import PageRankService, TenantSpec
    cfg = full_config()
    svc0 = make_service(cfg, device="cuda")
    reg = svc0.registry
    base = seeded_queries(svc0, 256, seed=50, top_k=8)
    del svc0
    tenants = [TenantSpec(name="interactive", priority=2, deadline_s=0.05),
               TenantSpec(name="batch", priority=1)]

    def run(scheduler, async_dispatch, adaptive, queries):
        svc = PageRankService(
            reg, max_batch=cfg.max_batch, cache_capacity=cfg.cache_capacity,
            max_top_k=cfg.max_top_k, adaptive=adaptive, scheduler=scheduler,
            tenants=tenants, async_dispatch=async_dispatch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for q in queries:
            svc.submit(q)
        res = svc.run_until_drained()
        torch.cuda.synchronize()
        return res, svc.stats, time.perf_counter() - t0

    queries = [replace(q, tenant="interactive" if i % 2 else "batch")
               for i, q in enumerate(base)]
    run("fifo", False, True, queries)           # warm-up, not timed
    reset_counts()
    runs, walls = {}, {}
    for _ in range(5):
        for adaptive in (True, False):
            for scheduler in ("fifo", "deadline"):
                for async_dispatch in (False, True):
                    key = (adaptive, scheduler, async_dispatch)
                    res, st, wall = run(scheduler, async_dispatch, adaptive,
                                        queries)
                    runs.setdefault(key, (res, st))
                    walls.setdefault(key, []).append(wall * 1e3)
    counts = read_counts()
    unpinned = 0
    for (adaptive, scheduler, async_dispatch), (res, _) in runs.items():
        ref = runs[(adaptive, "fifo", False)][0]
        check(sorted(res) == sorted(ref), "slice D scheduler: answers lost")
        for qid, a in ref.items():
            b = res[qid]
            check(np.allclose(b.scores, a.scores, rtol=1e-5, atol=1e-6),
                  f"slice D scheduler {scheduler} async={async_dispatch} "
                  f"adaptive={adaptive} q{qid}: scores differ from sync FIFO")
            s = a.scores.astype(float)
            gap = np.abs(np.diff(s)) > 1e-6
            pinned = np.ones(len(s), bool)
            pinned[1:] &= gap
            pinned[:-1] &= gap
            pinned[-1] = False
            unpinned += int((~pinned).sum())
            check(np.array_equal(a.indices[pinned], b.indices[pinned]),
                  f"slice D scheduler {scheduler} async={async_dispatch} "
                  f"adaptive={adaptive} q{qid}: top-k ids differ")
    for key, (_, st) in runs.items():
        adaptive, scheduler, async_dispatch = key
        w = walls[key]
        log(f"slice D scheduler: {'adaptive' if adaptive else 'fixed'} "
            f"{scheduler} {'async' if async_dispatch else 'sync'}: drain "
            f"median {float(np.median(w)):.2f} ms (range {min(w):.2f}-"
            f"{max(w):.2f}, 5 runs), {st['solves']} solves, deadline "
            f"misses {st['deadline_misses']}, held ticks {st['held_ticks']}")
    log(f"slice D scheduler: every answer agrees with sync FIFO (rtol 1e-5, "
        f"atol 1e-6; ids at every rank no score within 1e-6 could swap, "
        f"{unpinned} ranks unpinned); launches {counts}")
    return {"launches": counts}


# ---------------------------------------------------------------- slice E --
E_DIR = ROOT / "build" / "chip_smoke_e"     # gitignored scratch of slice E


def float64_uniform_pagerank(g, c: float, iters: int = 200) -> np.ndarray:
    """[n] float64 PageRank with a uniform unit-mass p by `iters` power
    rounds on scipy (L1 error below c^iters)."""
    import scipy.sparse as sp
    deg = np.maximum(g.deg, 1).astype(float)
    P = sp.csr_matrix((1.0 / deg[g.src], (g.dst, g.src)), shape=(g.n, g.n))
    p = np.full(g.n, 1.0 / g.n)
    x = p.copy()
    for _ in range(iters):
        x = c * (P @ x) + (1.0 - c) * p
    return x / x.sum()


def file_digest(path: Path) -> str:
    import hashlib
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 24), b""):
            h.update(chunk)
    return h.hexdigest()


def phase_slice_e_cache() -> dict:
    """E3: chunglu-1m through the dataset cache: the first call builds and
    saves, the second maps the file; both bitwise equal to the build, and
    the mapped graph registers (the file untouched) and serves one tick
    whose answers are bitwise those of the fresh graph (deterministic
    algorithms on for those two ticks: hub/tail's `index_add_` adds with
    atomics otherwise)."""
    import warnings
    import torch
    from repro_torch.core.engine import HubTailEngine
    from repro_torch.graph.datasets import scale_dataset
    from repro_torch.serve import GraphRegistry, PageRankService, PPRQuery
    cache_dir = E_DIR / "datasets"
    shutil.rmtree(cache_dir, ignore_errors=True)
    t0 = time.perf_counter()
    fresh = scale_dataset("chunglu-1m", cache_dir=cache_dir)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mapped = scale_dataset("chunglu-1m", cache_dir=cache_dir)
    map_s = time.perf_counter() - t0
    files = sorted(cache_dir.glob("*.npz"))
    check(len(files) == 1, f"slice E cache: files {files}")
    size = files[0].stat().st_size
    check(fresh.src.flags.writeable and not mapped.src.flags.writeable,
          "slice E cache: the second call did not map the file")
    check(np.array_equal(mapped.src, fresh.src) and
          np.array_equal(mapped.dst, fresh.dst) and mapped.n == fresh.n,
          "slice E cache: mapped arrays differ from the fresh build")
    digest = file_digest(files[0])
    reg = GraphRegistry(device="cuda", batch_hint=8)
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        # torch warns when it would alias a read-only (mapped) array
        warnings.filterwarnings("error", message=".*not writable.*")
        rm = reg.register("mapped", mapped)
    reg_s = time.perf_counter() - t0
    rf = reg.register("fresh", fresh)
    torch.cuda.synchronize()
    check(isinstance(rm.engine, HubTailEngine), "slice E cache: auto did "
          f"not pick hub/tail: {type(rm.engine).__name__}")
    for name in ("src", "dst", "w", "inv_deg"):
        check(torch.equal(getattr(rm.dg, name), getattr(rf.dg, name)),
              f"slice E cache: registered {name} differs")
    for name in ("inv_deg", "tail_src", "tail_dst", "panel_cols",
                 "panel_hub", "hub_ids"):
        check(torch.equal(getattr(rm.engine, name),
                          getattr(rf.engine, name)),
              f"slice E cache: hub/tail {name} differs")
    svc = PageRankService(reg, max_batch=8, max_top_k=16, adaptive=True)
    rng = np.random.default_rng(70)
    seeds = [tuple(int(s) for s in rng.choice(fresh.n, 2, replace=False))
             for _ in range(8)]
    reset_counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            for off, name in ((0, "mapped"), (100, "fresh")):
                for j, sd in enumerate(seeds):
                    svc.submit(PPRQuery(qid=off + j, graph=name, seeds=sd,
                                        top_k=16))
            res = svc.run_until_drained()
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
    counts = read_counts()
    nondet = sorted({str(w.message)[:120] for w in caught
                     if "deterministic" in str(w.message)})
    check(svc.stats["solves"] == 2, f"slice E cache: {svc.stats}")
    for j in range(len(seeds)):
        a, b = res[j], res[100 + j]
        check(np.array_equal(a.indices, b.indices) and
              np.array_equal(a.scores, b.scores),
              f"slice E cache: q{j} answers of the mapped and fresh graphs "
              f"differ (non-deterministic ops: {nondet})")
    check(file_digest(files[0]) == digest, "slice E cache: the file changed")
    log(f"slice E cache: chunglu-1m built + saved in {build_s:.2f} s, "
        f"mapped in {map_s:.4f} s, file {size} bytes; mapped arrays "
        f"bitwise equal to the build; registered from the map in "
        f"{reg_s:.2f} s (file unchanged); one tick each: answers bitwise "
        f"equal; launches {counts}; non-deterministic op warnings "
        f"{nondet or 'none'}")
    del svc, reg, rm, rf, mapped
    torch.cuda.empty_cache()
    return {"graph": fresh, "build_s": build_s, "map_s": map_s,
            "size": size, "reg_s": reg_s}


def e1_graphs(chunglu) -> dict:
    from repro_torch.graph import generators
    return {"naca": generators.paper_dataset("NACA0015", 1.0),
            "kmer": generators.paper_dataset("kmer-V2", 1.0),
            "naca10": generators.paper_dataset("NACA0015", 10.0),
            "chunglu": chunglu}


def phase_slice_e_tuned(chunglu) -> dict:
    """E1: a tuned registry on a fresh store over `full_config()`'s graphs,
    the paper-size NACA0015 and chunglu-1m (budget large enough to time
    every feasible candidate); the winners against `pick_winner` and auto;
    the fused candidate's launches; a second registry on the store (zero
    measurements); the tuned service on NACA0015 x10 against float64."""
    import torch
    from repro_torch.core.autotune import TuningStore, WorkloadKey, \
        pick_winner
    from repro_torch.core.engine import heuristic_mode
    from repro_torch.serve import GraphRegistry, PageRankService
    store = E_DIR / "tuning.json"
    store.unlink(missing_ok=True)
    graphs = e1_graphs(chunglu)
    kw = dict(device="cuda", engine="tuned", batch_hint=128,
              tune_cache=store, tune_budget_s=300.0)
    reset_counts()
    reg = GraphRegistry(**kw)
    secs = {}
    for name, g in graphs.items():
        t0 = time.perf_counter()
        reg.register(name, g)
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
    counts = read_counts()
    entries = TuningStore(store).entries()
    table = {}
    for name, g in graphs.items():
        key = WorkloadKey.from_graph(g, 128, device="cuda").as_str()
        e = entries[key]
        auto = heuristic_mode(g, 128, device="cuda")
        cands = e["candidates"]
        check(e["heuristic"] == auto, f"slice E tuned {name}: heuristic "
              f"{e['heuristic']} != auto {auto}")
        check(e["engine"] == pick_winner({m: us * 1e-6 for m, us in
                                          cands.items()}, auto),
              f"slice E tuned {name}: winner {e['engine']} breaks "
              f"pick_winner over {cands}")
        check(reg.get(name).tuned_mode == e["engine"],
              f"slice E tuned {name}: registry runs {reg.get(name)}")
        table[name] = {"n": g.n, "m": g.m, "candidates_us": cands,
                       "winner": e["engine"], "auto": auto,
                       "skipped": e["skipped"],
                       "register_s": secs[name]}
        log(f"slice E tuned {name} (n={g.n}, m={g.m}): us per round "
            + ", ".join(f"{m} {us:.2f}" for m, us in cands.items())
            + f"; winner {e['engine']}, auto {auto}, skipped "
            f"{e['skipped'] or 'none'}; registered in {secs[name]:.2f} s "
            f"(device {e['device_name']})")
    log(f"slice E tuned: decisions {reg.tuner.decision_counts}; launches "
        f"of the measurement pass {counts}")
    check(reg.tuner.decision_counts.get("measured", 0) >= 3,
          f"slice E tuned: {reg.tuner.decision_counts}")
    check(counts["bsr_spmm_variants"]["wgmma_3xtf32"] > 0 and
          counts["cheb_step"] > 0, f"slice E tuned: the fused candidate's "
          f"timing did not launch both kernels: {counts}")
    del reg
    torch.cuda.empty_cache()

    # a restarted service on the same store: zero measurements
    t0 = time.perf_counter()
    reg2 = GraphRegistry(**kw)
    for name, g in graphs.items():
        reg2.register(name, g)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    check(reg2.tuner.measured_count() == 0 and
          reg2.tuner.decision_counts == {"store_hit": len(graphs)},
          f"slice E tuned: warm store decisions "
          f"{reg2.tuner.decision_counts}")
    for name in graphs:
        check(reg2.get(name).tuned_mode == table[name]["winner"],
              f"slice E tuned {name}: the warm start built another engine")
    log(f"slice E tuned: second registry on the store in {warm_s:.2f} s, "
        f"decisions {reg2.tuner.decision_counts}")

    # the tuned service on NACA0015 x10 against a float64 solve
    svc = PageRankService(reg2, max_batch=128, cache_capacity=4096,
                          max_top_k=32, adaptive=True)
    queries = [q for q in seeded_queries(svc, 400, seed=71, top_k=32)
               if q.graph == "naca10"][:4]
    reset_counts()
    t0 = time.perf_counter()
    for q in queries:
        svc.submit(q)
    res = svc.run_until_drained()
    torch.cuda.synchronize()
    tick_s = time.perf_counter() - t0
    tick_counts = read_counts()
    g10 = graphs["naca10"]
    x = float64_ppr(g10, 0.85, [q.seeds for q in queries], iters=100)
    worst = 0.0
    for j, q in enumerate(queries):
        err = answer_err(res[q.qid].indices, res[q.qid].scores, x[:, j])
        check(err <= 2e-4, f"slice E tuned naca10 q{q.qid}: |answer - "
              f"float64| {err:.3e} > 2 tol")
        worst = max(worst, err)
    del x
    log(f"slice E tuned naca10: engine "
        f"{type(reg2.get('naca10').engine).__name__}, one tick of "
        f"{len(queries)} queries {tick_s * 1e3:.1f} ms host, launches "
        f"{tick_counts}; max |answer - float64| {worst:.3e} (bound 2e-04)")
    return {"table": table, "launches": add_counts(counts, tick_counts),
            "registry": reg2, "graphs": graphs, "oracle_err": worst,
            "warm_s": warm_s}


def phase_slice_e_obs() -> dict:
    """E2: `full_config()` drained with metrics detail on, off, and on with
    the garbage collector paused (5 interleaved rounds each; medians and
    ranges, no gate), the detailed
    run's snapshot, ticks, accounting and device spans checked, one tick
    under `profiled`, and the launcher once with --engine tuned,
    --metrics-json and --profile-dir."""
    import gc
    import json as _json
    import os
    import torch
    from repro_torch.configs.pagerank_serve import full_config, make_service
    from repro_torch.obs.export import validate_snapshot
    from repro_torch.obs.trace import profiled
    from repro_torch.serve import PageRankService, ServeMetrics
    cfg = full_config()
    svc0 = make_service(cfg, device="cuda")
    reg = svc0.registry
    queries = seeded_queries(svc0, 256, seed=60, top_k=8)
    repeats = repeats_of(queries, len(queries) // 10)
    del svc0

    def run(detail, gc_off=False):
        svc = PageRankService(
            reg, max_batch=cfg.max_batch, cache_capacity=cfg.cache_capacity,
            max_top_k=cfg.max_top_k, adaptive=cfg.adaptive,
            metrics=ServeMetrics(detail=detail))
        torch.cuda.synchronize()
        if gc_off:
            gc.disable()
        try:
            t0 = time.perf_counter()
            results, st, _ = drive(svc, queries, repeats)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            gc.enable()
        return svc, results, wall

    # detail on, detail off, and detail on with Python's cyclic garbage
    # collector paused (the detail layer allocates per query; a collection
    # walks every tracked object of this large process)
    variants = {"on": (True, False), "off": (False, False),
                "on, gc paused": (True, True)}
    run(True)                                   # warm-up, not timed
    reset_counts()
    walls = {k: [] for k in variants}
    detailed = None
    for _ in range(5):
        for name, (detail, gc_off) in variants.items():
            svc, results, wall = run(detail, gc_off)
            walls[name].append(wall * 1e3)
            if name == "on":
                detailed = (svc, results)
    counts = read_counts()
    med = {k: float(np.median(w)) for k, w in walls.items()}
    log("slice E obs: full_config() drain (256 queries + 25 repeats), 5 "
        "runs each interleaved, median (range) ms: " + "; ".join(
            f"detail {k} {med[k]:.2f} ({min(w):.2f}-{max(w):.2f})"
            for k, w in walls.items())
        + f"; on/off {med['on'] / med['off']:.4f}, (on - off) per query "
        f"{(med['on'] - med['off']) * 1e3 / (len(queries) + len(repeats)):.1f}"
        f" us; launches {counts}")
    svc, results = detailed
    st = svc.stats
    check(len(results) == len(queries) + len(repeats),
          "slice E obs: not every query answered")
    check(st["queries"] == st["cache_hits"] + st["solved_queries"]
          + st["dropped_queries"], f"slice E obs: accounting {st}")
    snap = svc.snapshot({"phase": "slice E obs"})
    errs = validate_snapshot(snap)
    check(errs == [], f"slice E obs: snapshot invalid: {errs}")
    ticks = list(svc.metrics.convergence.ticks)
    check(ticks and all(t.rounds_used <= t.rounds_bound for t in ticks),
          "slice E obs: a tick ran past the Formula 8 bound")
    spans = [sp for t in svc.metrics.tracer.finished for sp in t.spans
             if sp.name == "solve_device"]
    check(spans and all(sp.kind == "device" and sp.duration > 0
                        for sp in spans),
          "slice E obs: solve_device spans not device-timed")
    dev_ms = sorted({round(sp.duration * 1e3, 4) for sp in spans})
    log(f"slice E obs: snapshot valid ({len(snap['metrics'])} families); "
        f"{len(ticks)} ticks, rounds used/bound "
        + ", ".join(f"{t.graph} {t.rounds_used}/{t.rounds_bound} "
                    f"resid {t.residual:.2e}" for t in ticks)
        + f"; solve_device spans {len(spans)}, device ms {dev_ms}")

    # one tick under the profiler: the trace names both kernels
    prof_dir = E_DIR / "profile_tick"
    shutil.rmtree(prof_dir, ignore_errors=True)
    svc = PageRankService(reg, max_batch=cfg.max_batch,
                          max_top_k=cfg.max_top_k, adaptive=cfg.adaptive)
    for q in [q for q in seeded_queries(svc, 400, seed=61, top_k=8)
              if q.graph == "naca"][:64]:
        svc.submit(q)
    reset_counts()
    with profiled(str(prof_dir)):
        out = svc.tick(force=True)
    prof_counts = read_counts()
    traces = sorted(prof_dir.glob("trace_*.json"))
    check(len(traces) == 1 and out, "slice E obs: no profiler trace or "
          "no answers")
    text = traces[0].read_text()
    events = _json.loads(text).get("traceEvents", [])
    kernels = sorted({e.get("name", "")[:60] for e in events
                      if e.get("cat") == "kernel"})
    check("bsr_spmm" in text and "cheb_step" in text,
          f"slice E obs: the profiler trace lacks a kernel: {kernels[:20]}")
    log(f"slice E obs: profiled tick -> {traces[0].name} "
        f"({traces[0].stat().st_size} bytes), launches {prof_counts}, "
        f"kernel events: {kernels}")

    # the launcher as a user runs it
    launch_dir = E_DIR / "launcher"
    shutil.rmtree(launch_dir, ignore_errors=True)
    launch_dir.mkdir(parents=True)
    snap_path = launch_dir / "snapshot.json"
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           "pagerank-serve", "--smoke", "--requests", "64", "--updates",
           "4", "--engine", "tuned", "--tune-cache",
           str(launch_dir / "tuning.json"), "--metrics-json",
           str(snap_path), "--profile-dir", str(launch_dir / "profile")]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)
    launch_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"slice E obs: the launcher exited "
          f"{proc.returncode}:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    check(validate_snapshot(_json.loads(snap_path.read_text())) == [],
          "slice E obs: the launcher's snapshot is invalid")
    check(any((launch_dir / "profile").glob("trace_*.json")),
          "slice E obs: the launcher wrote no profiler trace")
    tail = [ln for ln in proc.stdout.splitlines() if ln.strip()][-9:]
    log(f"slice E obs: launcher --engine tuned exited 0 in "
        f"{launch_s:.2f} s; its summary:\n  " + "\n  ".join(tail))
    return {"launches": add_counts(counts, prof_counts), "walls": walls,
            "median_ms": med, "launch_s": launch_s}


def phase_slice_e_paper(reg, g10) -> dict:
    """E4: the paper's comparison on the paper-size NACA0015 (the tuned
    registry's engine, fused, at BT = 1, uniform p): CPAA at ERR < 1e-3
    (c = 0.85) against power run to the same L1 gap from a float64 solve,
    and forward push at CPAA's round count; then monte_carlo and
    ortho_pagerank on small graphs against the dense oracle."""
    import torch
    from repro_torch.core.chebyshev import make_schedule
    from repro_torch.core.engine import FusedBlockEllEngine
    from repro_torch.core.orthopoly import ortho_pagerank
    from repro_torch.core.pagerank import (cpaa, forward_push, monte_carlo,
                                           power, true_pagerank_dense)
    from repro_torch.graph import generators
    from repro_torch.graph.ops import device_graph
    eng = reg.get("naca10").engine
    if not isinstance(eng, FusedBlockEllEngine):
        eng = FusedBlockEllEngine.from_graph(g10, device="cuda")
    n = g10.n
    p = torch.full((n,), 1.0 / n, device="cuda")
    x64 = float64_uniform_pagerank(g10, 0.85)
    sched = make_schedule(0.85, 1e-3)

    def gap(pi):
        return float(np.abs(pi.double().cpu().numpy() - x64).sum())

    def timed(fn):
        reset_counts()
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        ev0.record()
        r = fn()
        ev1.record()
        torch.cuda.synchronize()
        return r, ev0.elapsed_time(ev1), read_counts()

    rows = {}
    power(eng, tol=0.0, p=p, max_iter=2)            # warm-up
    r, ms, cnt = timed(lambda: cpaa(eng, c=0.85, p=p, schedule=sched))
    rows["cpaa"] = {"rounds": r.iterations, "ms": ms, "l1": gap(r.pi),
                    "counts": cnt}
    target = rows["cpaa"]["l1"]
    k = sched.rounds
    while gap(power(eng, c=0.85, tol=0.0, p=p, max_iter=k).pi) > target:
        k += 1
        check(k <= 500, "slice E paper: power never reached CPAA's gap")
    r, ms, cnt = timed(lambda: power(eng, c=0.85, tol=0.0, p=p,
                                     max_iter=k))
    rows["power"] = {"rounds": r.iterations, "ms": ms, "l1": gap(r.pi),
                     "counts": cnt}
    r, ms, cnt = timed(lambda: forward_push(eng, c=0.85, p=p,
                                            rounds=sched.rounds))
    rows["forward_push"] = {"rounds": r.iterations, "ms": ms,
                            "l1": gap(r.pi), "counts": cnt}
    launches = add_counts(*(row.pop("counts") for row in rows.values()))
    for name, row in rows.items():
        log(f"slice E paper: {name} on NACA0015 x10 (fused, BT = 1, "
            f"uniform p): {row['rounds']} rounds, {row['ms']:.3f} ms, L1 "
            f"from float64 {row['l1']:.3e}")
    log(f"slice E paper: launches {launches} (FFMA bsr_spmm "
        f"{launches['bsr_spmm_variants'].get('ffma', 0)})")
    check(rows["power"]["l1"] <= target and
          launches["bsr_spmm_variants"].get("wgmma_3xtf32", 0) == 0,
          f"slice E paper: {rows}, {launches}")
    del x64, p

    # monte_carlo and ortho_pagerank against the dense oracle (n <= 2000)
    g = generators.powerlaw_ba(150, 3, seed=6)
    mc = monte_carlo(device_graph(g, device="cuda"), walks_per_node=64,
                     max_len=80, seed=1).pi.cpu().numpy()
    corr = float(np.corrcoef(mc, true_pagerank_dense(g, 0.85))[0, 1])
    check(corr > 0.97, f"slice E paper: monte_carlo corr {corr:.4f}")
    gm = generators.tri_mesh(13, 15)
    truth = true_pagerank_dense(gm, 0.85)
    ortho = {}
    for basis in ("chebyshev", "legendre", "chebyshev2"):
        pi = ortho_pagerank(device_graph(gm, device="cuda"), basis, 0.85,
                            rounds=40).double().cpu().numpy()
        ortho[basis] = float(np.max(np.abs(pi - truth) / truth))
        check(ortho[basis] < 1e-4, f"slice E paper: ortho {basis} max rel "
              f"err {ortho[basis]:.3e}")
    log(f"slice E paper: monte_carlo on powerlaw_ba(150) corr with the "
        f"dense oracle {corr:.4f} (bound > 0.97); ortho_pagerank at 40 "
        "rounds on tri_mesh(13, 15), max rel err "
        + ", ".join(f"{b} {e:.3e}" for b, e in ortho.items())
        + " (bound 1e-4)")
    return {"rows": rows, "launches": launches, "mc_corr": corr,
            "ortho": ortho}


# ---------------------------------------------------------------- slice F --
def device_time_by_kernel(fn, calls: int = 3) -> dict:
    """{kernel name: device us per call} over `calls` calls of `fn`
    (torch.profiler, after one warm call); {} if the profiler sees no
    kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0)
        if dev > 0:
            out[e.key] = out.get(e.key, 0.0) + dev / calls
    return out


def sharded_collectives(eng, x):
    """The collectives of one sharded apply on buffers of its shapes, and
    nothing else: 1D one all-gather of x; 2D a reduce-scatter of the
    [rows, ...] partial over the column group and an all-gather over the
    row group (with the bf16 wire's cast)."""
    from repro_torch.core import distributed
    if eng.name == "sharded_1d":
        xs = x if eng.comm_dtype is None else x.to(eng.comm_dtype)
        return distributed.all_gather(xs, eng.group)
    partial = x.new_empty((eng.rows_per_chunk,) + tuple(x.shape[1:]))
    y = distributed.reduce_scatter(partial, eng.col_group)
    if eng.comm_dtype is not None:
        y = y.to(eng.comm_dtype)
    return distributed.all_gather(y, eng.row_group)


# Slice F's gate on the timed (atomic) path: a sharded solve with atomics
# against COO's with atomics. COO against itself moves up to 3.6e-5 in L1
# on chunglu-1m's hubs (H100), from the order of the atomic adds alone; a
# solve one round short or a dropped shard moves 1e-3 or more.
L1_ATOMICS_LIMIT = 2e-4


def deterministic(fn):
    """fn() with torch's deterministic algorithms on (raising on an op that
    has none): `index_add_` then sums in a fixed order on the card."""
    import torch
    torch.use_deterministic_algorithms(True)
    try:
        return fn()
    finally:
        torch.use_deterministic_algorithms(False)


def phase_slice_f(graphs: dict) -> dict:
    """F: the sharded engines over NCCL at world size 1 (`init_mesh`, a
    single-rank group on an in-process store), on NACA0015 x10 and
    chunglu-1m: Sharded1DEngine and Sharded2DEngine at grid (1, 1), CPAA
    at the paper's operating point (ERR < 1e-3, 12 rounds) at BT = 1 and
    BT = 128, the 2D engine with the bf16 wire at BT = 1; each held to the
    COO engine's solve (L1 <= 1e-5 per column; bf16: max rel < 2e-2 and
    >= 95% of the top decile) with deterministic algorithms on for both,
    so both sum in one order (with atomics, COO against itself moves more
    than 1e-5 on chunglu-1m's hubs: that spread is printed, and each f32
    engine's L1 from COO with atomics, the path timed here, is held to
    L1_ATOMICS_LIMIT), the collective counters checked per
    solve; CUDA-event ms per apply beside COO's and of the apply's
    collectives alone, the NCCL kernels of a 2D apply at BT = 128 by
    torch.profiler, partition build seconds and peak memory. Then one service tick of 128 queries on
    NACA0015 x10 over sharded-1d (4 answers against a float64 solve,
    within 2 tol) and `pagerank_cpaa.smoke_run` on the card."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import pagerank_cpaa
    from repro_torch.core import distributed
    from repro_torch.core.chebyshev import make_schedule
    from repro_torch.core.engine import (CooEngine, Sharded1DEngine,
                                         Sharded2DEngine, collective_counts,
                                         reset_collective_counts)
    from repro_torch.core.pagerank import cpaa
    from repro_torch.graph.ops import device_graph
    from repro_torch.serve.graph_registry import GraphRegistry
    from repro_torch.serve.pagerank_service import PageRankService
    t_phase = time.perf_counter()
    mesh1 = distributed.init_mesh((1,), ("dev",), device="cuda")
    mesh2 = distributed.init_mesh((1, 1), ("row", "col"), device="cuda")
    backend = str(dist.get_backend())
    check("nccl" in backend and distributed.world_size() == 1,
          f"slice F: process group {backend!r}, world "
          f"{distributed.world_size()}")
    sched = make_schedule(pagerank_cpaa.C, pagerank_cpaa.TOL)
    rounds = sched.rounds
    rows = {}
    for gname in ("naca10", "chunglu"):
        g = graphs[gname]
        coo = CooEngine(device_graph(g, device="cuda"))
        rng = np.random.default_rng(5)
        p128 = torch.zeros((g.n, 128), device="cuda")
        seeds = torch.from_numpy(rng.choice(g.n, 128, replace=False)).cuda()
        p128[seeds, torch.arange(128, device="cuda")] = 1.0
        ps = {1: torch.full((g.n,), 1.0 / g.n, device="cuda"), 128: p128}

        def solve(eng, p):
            return cpaa(eng, pagerank_cpaa.C, schedule=sched, p=p).pi

        def l1(a, b) -> float:
            return float((a.double() - b.double()).abs().sum(dim=0).max())
        refs = {bt: solve(coo, p) for bt, p in ps.items()}
        refs_det = {bt: deterministic(lambda: solve(coo, p))
                    for bt, p in ps.items()}
        spread = {bt: l1(solve(coo, p), refs[bt]) for bt, p in ps.items()}
        log(f"slice F {gname}: COO against itself with atomics, L1 "
            + ", ".join(f"{v:.3e} at BT {bt}" for bt, v in spread.items()))
        # applies are timed on a dense x, as mid-solve: one-hot or
        # constant columns compress on the card and read faster
        gen = torch.Generator(device="cuda").manual_seed(9)
        xs = {bt: torch.rand((g.n,) if bt == 1 else (g.n, bt),
                             generator=gen, device="cuda") for bt in ps}
        coo_ms = {bt: time_ms(lambda: coo.apply(x), reps=10)
                  for bt, x in xs.items()}
        engines = {}
        for kind, cls, mesh in (("1d", Sharded1DEngine, mesh1),
                                ("2d", Sharded2DEngine, mesh2)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            eng = cls.from_graph(g, mesh=mesh, device="cuda")
            torch.cuda.synchronize()
            engines[kind] = (eng, time.perf_counter() - t0,
                             torch.cuda.max_memory_allocated() - base)
        e2 = engines["2d"][0]
        engines["2d_bf16"] = (Sharded2DEngine(
            mesh=mesh2, src_local=e2.src_local, dst_local=e2.dst_local,
            weight=e2.weight, perm=e2.perm, inv_perm=e2.inv_perm,
            n_orig=e2.n_orig, n_pad=e2.n_pad,
            rows_per_chunk=e2.rows_per_chunk, comm_dtype=torch.bfloat16),
            0.0, 0)
        for kind, (eng, build_s, build_mem) in engines.items():
            for bt in ((1,) if kind == "2d_bf16" else (1, 128)):
                p = ps[bt]
                torch.cuda.reset_peak_memory_stats()
                reset_counts()
                reset_collective_counts()
                pi = solve(eng, p)
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated()
                coll = collective_counts()
                counts = read_counts()
                check(counts["applies"] == {eng.name: rounds},
                      f"slice F {gname} {kind} BT {bt}: applies {counts}")
                vec = eng.n_pad * bt * 4
                if kind == "1d":
                    want = {f"{eng.name}/apply/all_gather/world":
                            {"calls": rounds, "bytes": rounds * vec},
                            f"{eng.name}/layout/all_gather/world":
                            {"calls": 1, "bytes": vec}}
                else:
                    wire = 2 if kind == "2d_bf16" else 4
                    want = {f"{eng.name}/apply/reduce_scatter/col":
                            {"calls": rounds, "bytes": rounds * vec},
                            f"{eng.name}/apply/all_gather/row":
                            {"calls": rounds,
                             "bytes": rounds * eng.n_pad * bt * wire},
                            f"{eng.name}/layout/all_gather/col":
                            {"calls": 1, "bytes": vec}}
                check(coll == want, f"slice F {gname} {kind} BT {bt}: "
                      f"collectives {coll} != {want}")
                row = {"build_s": build_s, "build_bytes": build_mem,
                       "peak_bytes": peak, "collectives": coll,
                       "l1_atomics": l1(pi, refs[bt]),
                       "coo_spread": spread[bt]}
                pi = deterministic(lambda: solve(eng, p))
                if kind == "2d_bf16":
                    a = pi.double().cpu().numpy()
                    b = refs_det[bt].double().cpu().numpy()
                    rel = float(np.max(np.abs(a - b) / b))
                    top = set(np.argsort(-b)[: g.n // 10].tolist())
                    kept = len(top & set(np.argsort(-a)[: g.n // 10]
                                         .tolist())) / len(top)
                    check(rel < 2e-2 and kept >= 0.95,
                          f"slice F {gname} bf16: max rel {rel:.3e}, top "
                          f"decile kept {kept:.4f}")
                    row.update(max_rel=rel, top_decile_kept=kept)
                else:
                    row["l1"] = l1(pi, refs_det[bt])
                    check(row["l1"] <= 1e-5, f"slice F {gname} {kind} BT "
                          f"{bt}: L1 {row['l1']:.3e} from COO > 1e-5")
                    check(row["l1_atomics"] <= L1_ATOMICS_LIMIT,
                          f"slice F {gname} {kind} BT {bt}: with atomics, "
                          f"L1 {row['l1_atomics']:.3e} from COO > "
                          f"{L1_ATOMICS_LIMIT:.0e}")
                x = eng.to_internal(xs[bt])
                row["apply_ms"] = time_ms(lambda: eng.apply(x), reps=10)
                row["coo_apply_ms"] = coo_ms[bt]
                row["collectives_ms"] = time_ms(
                    lambda: sharded_collectives(eng, x), reps=10)
                rows[(gname, kind, bt)] = row
                log(f"slice F {gname} (n={g.n}, m={g.m}) {kind} BT {bt}: "
                    + (f"L1 from COO {row['l1']:.3e}" if "l1" in row else
                       f"max rel {row['max_rel']:.3e}, top decile kept "
                       f"{row['top_decile_kept']:.4f}")
                    + f" (with atomics {row['l1_atomics']:.3e})"
                    + f"; apply {row['apply_ms']:.3f} ms (COO "
                    f"{coo_ms[bt]:.3f} ms), its collectives alone "
                    f"{row['collectives_ms']:.3f} ms; partition build "
                    f"{build_s:.2f} s, +{build_mem / 2**20:.0f} MiB; solve "
                    f"peak {peak / 2**30:.2f} GiB; collectives {coll}")
                del x, pi
        e2, x2 = engines["2d"][0], engines["2d"][0].to_internal(xs[128])
        kern = device_time_by_kernel(lambda: e2.apply(x2))
        nccl = {k: v for k, v in kern.items() if "nccl" in k.lower()}
        log(f"slice F {gname}: torch.profiler over a 2D apply at BT 128: "
            f"device {sum(kern.values()):.1f} us per apply (CUDA events "
            f"{rows[(gname, '2d', 128)]['apply_ms'] * 1e3:.1f} us), NCCL "
            + (", ".join(f"{k} {v:.1f} us" for k, v in nccl.items())
               or "none seen"))
        rows[(gname, "2d", 128)]["profiler_nccl_us"] = nccl
        del e2, x2
        del engines, coo, ps, xs, refs, refs_det, p128
        torch.cuda.empty_cache()

    # one tick of 128 queries through the service over sharded-1d
    g10 = graphs["naca10"]
    reg = GraphRegistry(device="cuda", engine="sharded-1d", batch_hint=128)
    t0 = time.perf_counter()
    reg.register("naca10", g10)
    torch.cuda.synchronize()
    reg_s = time.perf_counter() - t0
    check(reg.get("naca10").dg is None,
          "slice F service: a sharded registry uploaded the whole graph")
    svc = PageRankService(reg, max_batch=128, cache_capacity=4096,
                          max_top_k=32, adaptive=True)
    queries = seeded_queries(svc, 128, seed=81, top_k=32)
    reset_counts()
    t0 = time.perf_counter()
    for q in queries:
        svc.submit(q)
    res = svc.run_until_drained()
    torch.cuda.synchronize()
    tick_s = time.perf_counter() - t0
    st = svc.stats
    check(st["ticks"] == 1 and len(res) == 128 and st["solves"] == 1,
          f"slice F service: {st}")
    tick_counts = read_counts()
    check(set(tick_counts["applies"]) == {"sharded_1d"},
          f"slice F service: applies {tick_counts['applies']}")
    sub = queries[:4]
    x = float64_ppr(g10, 0.85, [q.seeds for q in sub], iters=100)
    worst = max(answer_err(res[q.qid].indices, res[q.qid].scores, x[:, j])
                for j, q in enumerate(sub))
    check(worst <= 2e-4, f"slice F service: |answer - float64| "
          f"{worst:.3e} > 2 tol")
    log(f"slice F service: NACA0015 x10 on sharded-1d registered in "
        f"{reg_s:.2f} s; one tick of 128 queries {tick_s * 1e3:.1f} ms "
        f"host ({st['rounds_used']} rounds of bound {st['rounds_bound']}); "
        f"max |answer - float64| over 4 queries {worst:.3e} (bound 2e-04)")
    svc.close()
    del svc, reg, x
    torch.cuda.empty_cache()

    smoke = pagerank_cpaa.smoke_run(device="cuda")
    check(smoke["max_rel_err"] < 5e-5 and
          smoke["adaptive_max_rel_err"] < 5e-5 and
          smoke["adaptive_rounds"] <= smoke["adaptive_rounds_bound"],
          f"slice F pagerank_cpaa.smoke_run: {smoke}")
    log("slice F pagerank_cpaa.smoke_run on the card: "
        + ", ".join(f"{k} {v}" for k, v in smoke.items()))
    dist.destroy_process_group()
    secs = time.perf_counter() - t_phase
    log(f"slice F: {secs:.1f} s")
    return {"rows": rows, "tick_s": tick_s, "oracle_err": worst,
            "smoke": smoke, "seconds": secs}


# ---------------------------------------------------------------- slice G --
G_DIR = ROOT / "build" / "chip_smoke_g"     # gitignored scratch of slice G
G_DEVICE = "cuda"      # a CPU rehearsal at smoke widths patches this
G_ARCHS = ("meshgraphnet", "pna", "dimenet", "graphcast")
G_SHAPES = ("minibatch_lg", "full_graph_sm", "molecule")
G_STEPS = 5            # AdamW steps on one batch; the loss must fall
G_LR = 1e-4            # small enough that 5 steps descend at every width
G_FLOW_STEPS = 6       # train_gnn flow: checkpoint after step 3, replay 4
LOSS_GAP_F64 = 1e-4    # f32 vs float64 on the card, relative
GNORM_GAP_F64 = 1e-3


def gnn_case(arch: str, shape: str, dev):
    """(config module, model module, full_config, params, batch) for
    `arch` at `shape`, from torch.Generator seed 0 (params) and the
    config's make_batch seed 0, on `dev`."""
    import importlib
    import torch
    from repro_torch.configs import gnn_common as gc
    cfg_mod = importlib.import_module(f"repro_torch.configs.{arch}")
    model = importlib.import_module(f"repro_torch.models.gnn.{arch}")
    dims = gc.GNN_SHAPES[shape]
    cfg = cfg_mod.full_config(d_in=dims["d_feat"])
    gen = torch.Generator(device=dev).manual_seed(0)
    params = cfg_mod._init(gen, cfg, dims["d_feat"]) if arch == "graphcast" \
        else model.init_params(gen, cfg)
    batch = cfg_mod.make_batch(cfg, dims, seed=0, device=dev)
    return cfg_mod, model, cfg, params, batch


def f64_gap(loss_fn, params, batch, m32) -> dict:
    """The same step's loss and grad norm in float64 on the card (the same
    parameters and batch, widened), each as a relative gap to f32's."""
    import torch
    from torch.utils import _pytree as pytree
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.train_loop import make_train_step
    p64 = pytree.tree_map(lambda t: t.detach().double(), params)
    b64 = {k: v.double() if v.is_floating_point() else v
           for k, v in batch.items()}
    cfg = AdamWConfig(lr=G_LR)
    _, _, m64 = make_train_step(loss_fn, cfg, donate=False)(
        p64, adamw_init(p64, cfg), b64)
    out = {}
    for k in ("loss", "grad_norm"):
        a, b = float(m32[k]), float(m64[k])
        out[k] = abs(a - b) / abs(b)
        out[k + "_f64"] = b
    del p64, b64
    torch.cuda.empty_cache()
    return out


def gnn_steps(arch: str, shape: str, f64: str) -> dict:
    """G_STEPS AdamW steps (lr G_LR, donated) of `arch` at full width on
    `shape` on one batch: a warm-up step that leaves the state as it was
    gives f32's loss and grad norm; then the timed steps (CUDA events),
    peak memory, and at minibatch_lg a torch.profiler breakdown of one
    step. f64: "here" runs the float64 check on this shape, "if_fits"
    runs it when twice the f32 peak fits the card (else the caller runs it
    on another shape), "no" skips it."""
    import torch
    from functools import partial
    from torch.utils import _pytree as pytree
    from repro_torch.configs.gnn_common import GNN_SHAPES
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.train_loop import make_train_step
    dev = torch.device(G_DEVICE)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg_mod, model, cfg, params, batch = gnn_case(arch, shape, dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    loss_fn = partial(model.loss_fn, cfg=cfg)
    opt_cfg = AdamWConfig(lr=G_LR)
    opt = adamw_init(params, opt_cfg)
    n_params = sum(t.numel() for t in pytree.tree_leaves(params))
    _, _, m32 = make_train_step(loss_fn, opt_cfg, donate=False)(
        params, opt, batch)
    loss32, gn32 = float(m32["loss"]), float(m32["grad_norm"])
    check(np.isfinite(loss32) and np.isfinite(gn32),
          f"{arch} at {shape}: loss {loss32} grad norm {gn32}")
    p0 = pytree.tree_map(lambda t: t.detach().clone(), params)
    step = make_train_step(loss_fn, opt_cfg, donate=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(G_STEPS + 1)]
    losses, gnorms = [], []
    before = read_counts()
    ev[0].record()
    for i in range(G_STEPS):
        params, opt, m = step(params, opt, batch)
        ev[i + 1].record()
        losses.append(m["loss"])
        gnorms.append(m["grad_norm"])
    torch.cuda.synchronize()
    gate_adamw("slice_g", f"G {arch} at {shape}",
               adamw_delta(before, read_counts()),
               len(pytree.tree_leaves(params)), G_STEPS)
    step_ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(G_STEPS)]
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    gnorms = [float(x) for x in gnorms]
    check(all(np.isfinite(losses)) and all(np.isfinite(gnorms)),
          f"{arch} at {shape}: non-finite loss or grad norm {losses} "
          f"{gnorms}")
    check(losses[-1] < losses[0],
          f"{arch} at {shape}: the loss did not fall over {G_STEPS} steps "
          f"({losses})")
    dims = GNN_SHAPES[shape]
    flops = 3.0 * cfg_mod.model_flops(cfg, dims)
    ms = float(np.mean(step_ms))
    log(f"G {arch} at {shape} (n={dims['n']:,}, e={dims['e']:,}, "
        f"{n_params:,} params): set-up {setup_s:.2f} s, step {ms:.3f} ms "
        f"(CUDA events, mean of {G_STEPS}: "
        f"{', '.join(f'{t:.3f}' for t in step_ms)}), "
        f"{flops / ms / 1e9:.2f} TFLOP/s of 3x model_flops, peak "
        f"{peak:,} bytes; loss {', '.join(f'{x:.6g}' for x in losses)}")
    out = {"arch": arch, "shape": shape, "ms": ms, "step_ms": step_ms,
           "peak": peak, "losses": losses, "grad_norms": gnorms,
           "params": n_params, "loss32": loss32, "gn32": gn32,
           "tflops": flops / ms / 1e9}
    if shape == "minibatch_lg":
        prof = profile_device(lambda: step(params, opt, batch),
                              f"one {arch} train step at {shape}",
                              by_op=True)
        out["profile"] = prof
    del params, opt, m, step
    total = torch.cuda.get_device_properties(0).total_memory
    if f64 == "here" or (f64 == "if_fits" and 2.1 * peak < 0.9 * total):
        gap = f64_gap(loss_fn, p0, batch, m32)
        log(f"G {arch} at {shape}: f32 vs float64 on the card: loss "
            f"{loss32:.9g} vs {gap['loss_f64']:.9g} (rel {gap['loss']:.3e}"
            f", limit {LOSS_GAP_F64:g}), grad norm {gn32:.9g} vs "
            f"{gap['grad_norm_f64']:.9g} (rel {gap['grad_norm']:.3e}, limit "
            f"{GNORM_GAP_F64:g})")
        check(gap["loss"] <= LOSS_GAP_F64 and gap["grad_norm"] <= GNORM_GAP_F64,
              f"{arch} at {shape}: f32 vs float64 gaps {gap}")
        out["f64"] = gap
    del p0, batch
    torch.cuda.empty_cache()
    return out


def phase_slice_g_steps() -> dict:
    """G1-G3: each GNN of the zoo at its full_config() widths on
    minibatch_lg, full_graph_sm and molecule: AdamW steps on the card
    (finite, loss falling), f32 vs float64 of one step (at minibatch_lg
    where twice the f32 peak fits the card, else at full_graph_sm), and at
    minibatch_lg ms per step, peak memory and a profile of one step."""
    import torch
    log("slice G: TF32 off (torch.backends.cuda.matmul.allow_tf32 = "
        f"{torch.backends.cuda.matmul.allow_tf32}, float32 matmul precision "
        f"{torch.get_float32_matmul_precision()!r}); cuBLAS workspace "
        f"{os.environ.get('CUBLAS_WORKSPACE_CONFIG')}")
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    t0 = time.perf_counter()
    rows = []
    for arch in G_ARCHS:
        need_f64 = True
        for shape in G_SHAPES:
            mode = "if_fits" if shape == "minibatch_lg" else \
                ("here" if need_f64 else "no")
            r = gnn_steps(arch, shape, mode)
            need_f64 = need_f64 and "f64" not in r
            rows.append(r)
        check(not need_f64, f"{arch}: no float64 check ran")
    secs = time.perf_counter() - t0
    log(f"slice G steps: {secs:.1f} s")
    return {"rows": rows, "seconds": secs}


def phase_slice_g_flow(g) -> dict:
    """G4: the train_gnn flow at a size users would call real: CPAA
    PageRank on `g` (chunglu-1m) on the card through auto's engine, PNA
    full_config() widths on GraphBatchPipeline batches of 1,024 seeds with
    fanouts (15, 10) and the PPR weights, G_FLOW_STEPS steps with an async
    checkpoint after step 3, then the replay of step 4 from the restored
    state: bit for bit with deterministic algorithms on, and the gap with
    atomics on (index_add_) printed."""
    import dataclasses
    import shutil as _shutil
    import torch
    from functools import partial
    from repro_torch.configs import pna as pna_cfg
    from repro_torch.launch import train_gnn
    from repro_torch.models.gnn import pna
    from repro_torch.train.data import GraphBatchPipeline
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.train_loop import make_train_step
    dev = torch.device(G_DEVICE)
    t0 = time.perf_counter()
    reset_counts()
    pr, feats, targets, delta = train_gnn.pagerank_task(g, dev)
    launches = read_counts()
    ppr_s = time.perf_counter() - t0
    check(np.isfinite(pr).all() and abs(pr.sum() - 1.0) < 1e-3,
          f"PageRank sums to {pr.sum()}")
    log(f"G4 chunglu-1m (n={g.n:,}, m={g.m:,}): CPAA PageRank + features "
        f"{ppr_s:.2f} s, engine applies {launches['applies']}, kernels "
        f"bsr_spmm {launches['bsr_spmm']} cheb_step "
        f"{launches['cheb_step']}")
    cfg = dataclasses.replace(pna_cfg.full_config(d_in=feats.shape[1]),
                              d_out=targets.shape[1], delta=delta)
    params = pna.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    opt_cfg = AdamWConfig(lr=2e-3, weight_decay=0.01)
    step = make_train_step(partial(pna.loss_fn, cfg=cfg), opt_cfg,
                           donate=False)
    t0 = time.perf_counter()
    pipe = GraphBatchPipeline(g, feats, targets, 1024, (15, 10), seed=1,
                              ppr_weights=pr, device=dev)
    csr_s = time.perf_counter() - t0
    ckpt_dir = G_DIR / "checkpoints"
    _shutil.rmtree(ckpt_dir, ignore_errors=True)
    out = deterministic(lambda: train_gnn.fit(
        step, params, adamw_init(params, opt_cfg), pipe, G_FLOW_STEPS,
        ckpt_dir, async_save=True))
    like = {"params": out["params"], "opt": out["opt"]}
    rp, rm, data_step = deterministic(
        lambda: train_gnn.replay(step, ckpt_dir, like, pipe))
    ref_params, ref_m = out["reference"]
    gap = train_gnn.tree_max_gap(ref_params, rp)
    same_loss = bool(torch.equal(ref_m["loss"], rm["loss"]))
    ap, am, _ = train_gnn.replay(step, ckpt_dir, like, pipe)
    gap_atomic = train_gnn.tree_max_gap(ref_params, ap)
    loss_gap_atomic = abs(float(ref_m["loss"]) - float(am["loss"]))
    host = out["host_ms"]
    dev_ms = out["device_ms"][1:]
    # the training path (atomics on), on batches already on the card
    batches = [pipe.batch(i) for i in range(3)]
    p, o = out["params"], out["opt"]
    atomic_ms = []
    for b in batches:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        p, o, _ = step(p, o, b)
        ev[1].record()
        torch.cuda.synchronize()
        atomic_ms.append(ev[0].elapsed_time(ev[1]))
    prof = profile_device(lambda: step(p, o, batches[0]),
                          "one train_gnn PNA step (atomics on)", by_op=True)
    host_share = float(np.mean(host)) / (float(np.mean(host))
                                         + float(np.mean(atomic_ms)))
    log(f"G4 device ms per step with atomics (the training path) "
        f"{', '.join(f'{x:.3f}' for x in atomic_ms)}; the host's sampler + "
        f"remap would take {host_share:.1%} of a serial batch + step")
    log(f"G4 PNA (d={cfg.d_hidden}, {cfg.n_layers} layers, d_in "
        f"{cfg.d_in}, d_out {cfg.d_out}, delta {delta:.4f}) on batches of "
        f"n_pad {pipe.n_pad:,}, e_pad {pipe.e_pad:,}: CSR once "
        f"{csr_s:.2f} s; host ms per batch (sampler + remap) "
        f"{', '.join(f'{x:.1f}' for x in host)}; device ms per step "
        f"(CUDA events, deterministic algorithms on, after the first) "
        f"{', '.join(f'{x:.3f}' for x in dev_ms)}; losses "
        f"{', '.join(f'{x:.5g}' for x in out['losses'])}")
    log(f"G4 checkpoint (async) after step {out['ckpt_step'] - 1}, replay of "
        f"step {data_step}: deterministic max param gap {gap:.3e}, loss "
        f"equal {same_loss}; with atomics: max param gap {gap_atomic:.3e}, "
        f"loss gap {loss_gap_atomic:.3e}")
    check(all(np.isfinite(out["losses"])), "G4: non-finite loss")
    check(gap == 0.0 and same_loss,
          f"G4: replay differs from the original step (gap {gap})")
    _shutil.rmtree(ckpt_dir, ignore_errors=True)
    return {"launches": launches, "host_ms": host, "device_ms": dev_ms,
            "atomic_ms": atomic_ms, "ppr_s": ppr_s, "replay_gap": gap,
            "atomic_gap": gap_atomic, "profile": prof}


def phase_slice_g(chunglu) -> dict:
    t0 = time.perf_counter()
    steps = phase_slice_g_steps()
    flow = phase_slice_g_flow(chunglu)
    log(f"slice G: {time.perf_counter() - t0:.1f} s")
    return {"steps": steps, "flow": flow, "launches": flow["launches"]}


# ---------------------------------------------------------------- slice H --
H_DEVICE = "cuda"      # a CPU rehearsal at smoke widths patches this
H_BATCH = 32           # engine slots for H1 and H2
H1_LEN = 8_192         # danube's positions per slot (KV ~16.1 GB)
H2_LEN = 4_096         # granite's (KV ~8.6 GB)
H_SHORT = 64           # requests with serve_lm's 3-15 token prompts
H1_LONG = 4            # danube requests whose prompts pass the 4,096 window
H1_LONG_LEN = 6_000
H_NEW = 16             # max_new_tokens per request
H3_SEQ = 32_768        # prefill_32k's sequence length
BF16_U = 2.0 ** -8     # bf16's unit roundoff (8-bit significand)
# bf16 engine logits vs a float64 forward, as a share of max |logit|
# (PERF.md §6, PR 18: sqrt(N_r) * u * rms/max, times a margin, capped at
# 5e-2)
LOGIT_GAP_BF16 = 5e-2


def lm_requests(vocab: int, count: int, seed: int, max_new: int,
                first_rid: int = 0, length: int | None = None) -> list:
    """serve_lm's requests: prompts of 3-15 tokens (or `length` tokens)
    drawn from np.random.default_rng(seed)."""
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        s = length or int(rng.integers(3, 16))
        out.append(Request(rid=first_rid + i,
                           prompt=rng.integers(0, vocab, s).astype(np.int32),
                           max_new_tokens=max_new))
    return out


def lm_drain(eng, reqs) -> dict:
    """run_until_drained's loop with timing: host ms per submit (prefill
    to the first token, which the host reads), CUDA-event ms per tick and
    whether every slot was busy, the drain's wall time, and whether every
    logit was finite (accumulated on the device, read once). Once the
    engine has captured its decode graph, the rest of the drain runs inside
    `RetraceGate()` (L-b: replays compile nothing)."""
    import contextlib
    import torch
    from repro_torch.analysis.retrace import RetraceGate
    gate, gated = None, 0
    pending = list(reqs)
    prefill_ms, tick_ms, full = {}, [], []
    finite = torch.ones((), dtype=torch.bool, device=eng.device)
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    # leaving the stack exits the gate, which raises RetraceError on events
    with contextlib.ExitStack() as stack:
        t0 = time.perf_counter()
        while pending or eng.active():
            while pending:
                s0 = time.perf_counter()
                if not eng.submit(pending[0]):
                    break
                prefill_ms[pending.pop(0).rid] = \
                    (time.perf_counter() - s0) * 1e3
                finite &= torch.isfinite(eng.last_prefill_logits).all()
            full.append(eng.active() == eng.max_batch)
            ev0.record()
            eng.tick()
            ev1.record()
            ev1.synchronize()
            tick_ms.append(ev0.elapsed_time(ev1))
            finite &= torch.isfinite(eng.last_logits).all()
            if gate is not None:
                gated += 1
            elif eng._graph is not None:
                gate = stack.enter_context(RetraceGate())
        wall = time.perf_counter() - t0
    return {"prefill_ms": prefill_ms, "tick_ms": tick_ms, "full": full,
            "wall_s": wall, "finite": bool(finite), "gated_ticks": gated}


def check_finished(reqs, max_len: int, label: str) -> None:
    for r in reqs:
        check(r.done and (len(r.out_tokens) >= r.max_new_tokens
                          or len(r.prompt) + len(r.out_tokens) >= max_len),
              f"{label}: request {r.rid} ended with {len(r.out_tokens)} "
              f"tokens (prompt {len(r.prompt)}, max_new_tokens "
              f"{r.max_new_tokens}, done {r.done})")


def tick_bound(eng) -> dict:
    """A decode tick's least bytes: every compute-dtype weight but the
    embedding table (its B rows are gathered) read once, and both whole
    [L, B, max_len] caches, which decode_attention reads in full whatever
    the lengths; over the HBM rate."""
    from torch.utils import _pytree as pytree
    w = sum(t.numel() * t.element_size()
            for k, t in pytree.tree_flatten_with_path(eng.params)[0]
            if "embed" not in str(k[0]))
    kv = sum(t.numel() * t.element_size() for t in eng.kv)
    return {"weight_bytes": w, "kv_bytes": kv,
            "ms": (w + kv) / HBM_BYTES_PER_S * 1e3}


def lm_report(label: str, cfg, eng, reqs, run: dict, bound: dict) -> dict:
    """Log and return the drain's numbers: ms per tick (median over the
    ticks with every slot busy) against the bytes bound, prefill ms by
    prompt length, tok/s, padding ids emitted."""
    full_ms = [t for t, f in zip(run["tick_ms"], run["full"]) if f]
    check(full_ms, f"{label}: no tick ran with all {eng.max_batch} slots "
          "busy")
    tick = float(np.median(full_ms))
    tokens = sum(len(r.out_tokens) for r in reqs)
    short = [ms for r in reqs if len(r.prompt) < 16
             for ms in [run["prefill_ms"][r.rid]]]
    long_ = [run["prefill_ms"][r.rid] for r in reqs if len(r.prompt) >= 16]
    pad = sum(t >= cfg.vocab for r in reqs for t in r.out_tokens)
    log(f"{label}: {len(reqs)} requests, {tokens} tokens in "
        f"{run['wall_s']:.3f} s ({tokens / run['wall_s']:.1f} tok/s), "
        f"{len(run['tick_ms'])} ticks ({len(full_ms)} with all "
        f"{eng.max_batch} slots busy: median {tick:.3f} ms, range "
        f"{min(full_ms):.3f}-{max(full_ms):.3f} ms; CUDA events); bytes "
        f"bound {bound['ms']:.3f} ms ({bound['weight_bytes']:,} B of "
        f"weights + {bound['kv_bytes']:,} B of KV at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s): tick at "
        f"{bound['ms'] / tick:.1%} of the bound")
    log(f"{label}: prefill ms (host clock, submit to first token): short "
        f"prompts median {np.median(short):.3f} (range {min(short):.3f}-"
        f"{max(short):.3f}, {len(short)} requests)"
        + (f"; {H1_LONG_LEN}-token prompts "
           f"{', '.join(f'{x:.3f}' for x in long_)}" if long_ else "")
        + f"; padding ids emitted {pad} of {tokens} tokens")
    if run["gated_ticks"]:
        log(f"L-b: {label}'s {run['gated_ticks']} ticks after its CUDA "
            "graph capture ran under RetraceGate: 0 compile events")
    return {"tick_ms": tick, "tick_range": [min(full_ms), max(full_ms)],
            "ticks": len(run["tick_ms"]), "full_ticks": len(full_ms),
            "bound_ms": bound["ms"], "tok_s": tokens / run["wall_s"],
            "tokens": tokens, "prefill_short_ms": float(np.median(short)),
            "prefill_long_ms": long_, "padding_ids": int(pad)}


def f64_logit_gap(params32, cfg, tokens, logits) -> dict:
    """Engine logits (bf16) against the last position of a float64 forward
    over `tokens` with the same parameters: max abs gap and its share of
    max |logit|."""
    import dataclasses
    import torch
    from repro_torch.models import transformer as tf
    dev = torch.device(H_DEVICE)
    cfg64 = dataclasses.replace(cfg, compute_dtype="float64")
    toks = torch.tensor(np.asarray(tokens)[None, :], device=dev)
    ref = tf.forward(params32, toks.long(), cfg64)[0][0, -1]
    gap = (logits.double() - ref).abs().max().item()
    top = ref.abs().max().item()
    return {"max_abs": gap, "max_rel": gap / top, "max_logit": top,
            "argmax_equal": int(logits.argmax()) == int(ref.argmax())}


def gate_f32_engine(params32, cfg) -> dict:
    """Gate 1: with compute_dtype float32 (TF32 off) one request's engine
    tokens equal a naive greedy decode by repeated full forwards, and each
    step's engine logits beside the forward's last-position logits."""
    import dataclasses
    import torch
    from repro_torch.models import transformer as tf
    from repro_torch.serve.engine import Request, ServeEngine
    dev = torch.device(H_DEVICE)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    eng = ServeEngine(params32, cfg32, max_batch=2, max_len=64, device=dev)
    prompt = np.random.default_rng(7).integers(0, cfg.vocab, 7).astype(
        np.int32)
    req = Request(rid=0, prompt=prompt, max_new_tokens=6)
    check(eng.submit(req), "gate 1: submit failed")
    steps = [eng.last_prefill_logits[0].clone()]
    while eng.active():
        eng.tick()
        steps.append(eng.last_logits[0].clone())
    toks, gaps = list(prompt), []
    for j, tok in enumerate(req.out_tokens):
        ref = tf.forward(params32, torch.tensor([toks], device=dev), cfg32)[
            0][0, -1]
        ref_tok = int(ref.argmax())
        gap = (steps[j] - ref).abs().max().item()
        gaps.append((gap, gap / ref.abs().max().item()))
        check(ref_tok == tok, f"gate 1: step {j} engine token {tok} != "
              f"naive greedy {ref_tok} (logit gap {gap:.3e})")
        toks.append(ref_tok)
    log(f"H gate 1 (f32, TF32 off, max_batch 2, max_len 64): engine tokens "
        f"{req.out_tokens} == naive greedy; per step max abs / rel logit "
        f"gap: {', '.join(f'{a:.2e}/{r:.2e}' for a, r in gaps)}")
    del eng
    return {"tokens": req.out_tokens, "gaps": gaps}


def profile_ticks(eng, cfg, label: str) -> dict:
    """torch.profiler over 3 decode ticks with every slot busy (fresh
    requests with room to decode)."""
    for r in lm_requests(cfg.vocab, eng.max_batch, seed=99, max_new=8,
                         first_rid=10_000):
        check(eng.submit(r), f"{label}: profile submit failed")
    return profile_device(lambda: [eng.tick() for _ in range(3)],
                          f"3 {label} decode ticks", by_op=True)


def eager_compare(eng, cfg, graph_reqs, label: str) -> dict:
    """The same engine run eagerly (no CUDA graph) on the same weights
    with its own cache: 32 of the short requests drained, the median full
    tick against the graph's, their tokens against the graph run's
    (printed: their batch mates differ), and a 3-tick profile by operator
    (a graph replay hides which operator launched a kernel)."""
    import torch
    from repro_torch.serve.engine import ServeEngine
    eager = ServeEngine(eng.params, cfg, eng.max_batch, eng.max_len,
                        device=eng.device)
    eager.cuda_graph = False
    reqs = lm_requests(cfg.vocab, eng.max_batch, seed=0, max_new=H_NEW)
    run = lm_drain(eager, reqs)
    full = [t for t, f in zip(run["tick_ms"], run["full"]) if f]
    same = sum(a.out_tokens == b.out_tokens for a, b in zip(reqs, graph_reqs))
    log(f"{label} eager (no CUDA graph): median tick "
        f"{np.median(full):.3f} ms over {len(full)} full ticks; {same} of "
        f"{len(reqs)} requests' tokens equal to the graph run's (their batch "
        "mates differ; printed)")
    prof = profile_ticks(eager, cfg, f"{label} eager")
    del eager
    torch.cuda.empty_cache()
    return {"tick_ms": float(np.median(full)), "same_tokens": same,
            "profile": prof}


def phase_slice_h1(cfg, params32) -> dict:
    """H1: danube at full width through a ServeEngine of 32 slots x 8,192
    positions: the short and long requests, then the bf16-vs-float64 gate
    on a short and a long prompt, batched vs solo, a 3-tick profile."""
    import torch
    from repro_torch.serve.engine import ServeEngine
    dev = torch.device(H_DEVICE)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = ServeEngine(params32, cfg, H_BATCH, H1_LEN, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    reqs = (lm_requests(cfg.vocab, H1_LONG, seed=1, max_new=H_NEW,
                        first_rid=1_000, length=H1_LONG_LEN)
            + lm_requests(cfg.vocab, H_SHORT, seed=0, max_new=H_NEW))
    run = lm_drain(eng, reqs)
    check(run["finite"], "H1: a logit is not finite")
    check_finished(reqs, H1_LEN, "H1")
    out = lm_report("H1 h2o-danube-1.8b", cfg, eng, reqs, run,
                    tick_bound(eng))
    out["build_s"] = build_s
    out["eager"] = eager_compare(eng, cfg, reqs[H1_LONG:], "H1 danube")
    # gate 2: the first decode step of a short and a long prompt
    gates = {}
    for name, r in (("short", lm_requests(cfg.vocab, 1, 5, 1, 2_000)[0]),
                    ("long", lm_requests(cfg.vocab, 1, 6, 1, 2_001,
                                         length=H1_LONG_LEN)[0])):
        check(eng.submit(r), "gate 2: submit failed")
        slot = eng.slot_req.index(r)
        eng.tick()
        logits = eng.last_logits[slot].clone()
        gates[name] = f64_logit_gap(params32, cfg,
                                    np.append(r.prompt, r.out_tokens[0]),
                                    logits)
        g = gates[name]
        log(f"H gate 2, {name} prompt ({len(r.prompt)} tokens): bf16 engine "
            f"vs float64 forward max abs {g['max_abs']:.4e}, max rel to max "
            f"|logit| ({g['max_logit']:.4f}) {g['max_rel']:.4e} (limit "
            f"{LOGIT_GAP_BF16:g}); argmax equal {g['argmax_equal']}")
        check(g["max_rel"] <= LOGIT_GAP_BF16,
              f"gate 2: {name} prompt bf16 vs float64 {g['max_rel']:.4e}")
        torch.cuda.empty_cache()
    out["f64"] = gates
    # batched vs solo (bf16; printed, not gated)
    solo = lm_requests(cfg.vocab, H_SHORT, seed=0, max_new=H_NEW)[:2]
    ServeEngine(eng.params, cfg, 1, H1_LEN, device=dev).run_until_drained(
        solo)
    agree = [sum(a == b for a, b in zip(s.out_tokens, r.out_tokens))
             for s, r in zip(solo, reqs[H1_LONG:])]
    log(f"H1 batched vs solo (bf16, printed): tokens equal {agree} of "
        f"{[len(s.out_tokens) for s in solo]}")
    out["solo_agree"] = agree
    out["profile"] = profile_ticks(eng, cfg, "H1 danube")
    out["peak"] = torch.cuda.max_memory_allocated()
    log(f"H1 engine build {build_s:.2f} s; peak {out['peak']:,} bytes")
    return out, eng.params


def phase_slice_h3(cfg, params_c) -> dict:
    """H3: one transformer.prefill of H3_SEQ tokens (batch 1, no pad_to)
    on the engine's compute-dtype weights: ms (CUDA events, after a
    2,048-token warm-up) and peak memory."""
    import torch
    from repro_torch.models import transformer as tf
    dev = torch.device(H_DEVICE)
    gen = torch.Generator(device=dev).manual_seed(3)
    toks = torch.randint(0, cfg.vocab, (1, H3_SEQ), generator=gen,
                         device=dev)
    tf.prefill(params_c, toks[:, :2048], cfg)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    ev0.record()
    logits, (k, v) = tf.prefill(params_c, toks, cfg)
    ev1.record()
    torch.cuda.synchronize()
    ms = ev0.elapsed_time(ev1)
    peak = torch.cuda.max_memory_allocated()
    check(bool(torch.isfinite(logits).all()), "H3: a logit is not finite")
    check(tuple(k.shape) == (cfg.n_layers, 1, H3_SEQ, cfg.n_kv_heads,
                             cfg.head_dim), f"H3: KV shape {tuple(k.shape)}")
    from repro_torch.configs.lm_common import lm_attn_flops
    flops = 2.0 * cfg.n_active_params() * H3_SEQ + lm_attn_flops(
        cfg, 1, H3_SEQ)
    log(f"H3 prefill of {H3_SEQ:,} tokens (danube, {cfg.compute_dtype}): "
        f"{ms:.3f} ms (CUDA events), {flops / ms / 1e9:.2f} TFLOP/s of "
        f"model flops, KV {2 * k.numel() * k.element_size():,} bytes, peak "
        f"{peak:,} bytes")
    del logits, k, v
    torch.cuda.empty_cache()
    return {"ms": ms, "peak": peak, "seq": H3_SEQ}


def phase_slice_h2() -> dict:
    """H2: granite-moe-3b-a800m at full width through a ServeEngine of 32
    slots x 4,096 positions: the short requests, dropped assignments per
    tick, a prompt's prefill and first decode step vs float64 (printed:
    bf16 and float64 may route a token to different experts, and the
    decode step's MoE routes all 32 slots' tokens where the forward
    routes the prompt's, so their capacities differ), a 3-tick profile."""
    import torch
    from repro_torch.configs import granite_moe_3b
    from repro_torch.models import transformer as tf
    from repro_torch.serve.engine import ServeEngine
    dev = torch.device(H_DEVICE)
    cfg = granite_moe_3b.full_config()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params32 = tf.init_params(torch.Generator(device=dev).manual_seed(0),
                              cfg)
    eng = ServeEngine(params32, cfg, H_BATCH, H2_LEN, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    reqs = lm_requests(cfg.vocab, H_SHORT, seed=0, max_new=H_NEW)
    run = lm_drain(eng, reqs)
    check(run["finite"], "H2: a logit is not finite")
    check_finished(reqs, H2_LEN, "H2")
    out = lm_report("H2 granite-moe-3b-a800m", cfg, eng, reqs, run,
                    tick_bound(eng))
    dropped = int(eng.stats["dropped"])
    per_tick = dropped / eng.stats["ticks"]
    assigned = cfg.n_layers * H_BATCH * cfg.moe.top_k
    log(f"H2 MoE capacity drops: {dropped} assignments over "
        f"{eng.stats['ticks']} ticks, {per_tick:.1f} per tick of {assigned} "
        f"({cfg.n_layers} layers x {H_BATCH} tokens x top-{cfg.moe.top_k}; "
        f"capacity {int(1.25 * H_BATCH * cfg.moe.top_k / cfg.moe.n_experts)}"
        f" -> 8 per expert)")
    out.update(build_s=build_s, dropped_per_tick=per_tick)
    r = lm_requests(cfg.vocab, 1, 5, 1, 2_000)[0]
    check(eng.submit(r), "H2: submit failed")
    pre = eng.last_prefill_logits[0].clone()
    slot = eng.slot_req.index(r)
    eng.tick()
    out["f64"] = {}
    for name, toks, logits in (
            ("prefill", r.prompt, pre),
            ("first decode step", np.append(r.prompt, r.out_tokens[0]),
             eng.last_logits[slot].clone())):
        g = out["f64"][name] = f64_logit_gap(params32, cfg, toks, logits)
        log(f"H2 {name} ({len(r.prompt)}-token prompt) vs float64 forward "
            f"(printed, not gated): max abs {g['max_abs']:.4e}, rel to max "
            f"|logit| {g['max_rel']:.4e}; argmax equal {g['argmax_equal']}")
    del params32
    torch.cuda.empty_cache()
    out["profile"] = profile_ticks(eng, cfg, "H2 granite")
    out["eager"] = eager_compare(eng, cfg, reqs, "H2 granite")
    out["peak"] = torch.cuda.max_memory_allocated()
    log(f"H2 engine build {build_s:.2f} s; peak {out['peak']:,} bytes")
    del eng
    torch.cuda.empty_cache()
    return out


def phase_slice_h4() -> dict:
    """H4: the launcher, `--arch h2o-danube-1.8b` at full width."""
    import torch
    from repro_torch.launch import serve as launch_serve
    argv = ["--arch", "h2o-danube-1.8b", "--requests", "8", "--max-batch",
            "4", "--max-len", "64", "--max-new-tokens", "8"]
    if H_DEVICE != "cuda":
        argv += ["--device", H_DEVICE]
    out = launch_serve.main(argv)
    reqs = out.pop("requests_done")
    eng = out.pop("engine")
    check_finished(reqs, 64, "H4")
    check(bool(torch.isfinite(eng.last_logits).all()),
          "H4: a logit is not finite")
    del eng
    torch.cuda.empty_cache()
    return out


def phase_slice_h() -> dict:
    """Slice H, the LM serve path (no kernel of its own: the reference's
    attention and MoE dispatch are XLA ops). Danube's gates and H1-H3 on
    one set of f32 weights, then granite (H2) and the launcher (H4)."""
    import torch
    from repro_torch.configs import h2o_danube_1_8b
    from repro_torch.models import transformer as tf
    dev = torch.device(H_DEVICE)
    t0 = time.perf_counter()
    prev = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    # f32 accumulation throughout, as the reference's dots accumulate
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    reset_counts()
    try:
        cfg = h2o_danube_1_8b.full_config()
        params32 = tf.init_params(
            torch.Generator(device=dev).manual_seed(0), cfg)
        log(f"H danube: {cfg.n_params():,} params (f32 "
            f"{4 * cfg.n_params():,} bytes), TF32 "
            f"{torch.backends.cuda.matmul.allow_tf32}")
        g1 = gate_f32_engine(params32, cfg)
        h1, params_c = phase_slice_h1(cfg, params32)
        del params32
        h3 = phase_slice_h3(cfg, params_c)
        del params_c
        torch.cuda.empty_cache()
        h2 = phase_slice_h2()
        h4 = phase_slice_h4()
    finally:
        torch.backends.cuda.matmul.\
            allow_bf16_reduced_precision_reduction = prev
    launches = read_counts()
    log(f"slice H kernel launches (no kernel on this path): bsr_spmm "
        f"{launches['bsr_spmm']}, cheb_step {launches['cheb_step']}, "
        f"embedding_bag {launches['embedding_bag']}; "
        f"{time.perf_counter() - t0:.1f} s")
    return {"gate1": g1, "h1": h1, "h2": h2, "h3": h3, "h4": h4,
            "launches": launches}


# ---------------------------------------------------------------- slice I --
I_DEVICE = "cuda"      # a CPU rehearsal at smoke widths patches this
I_DIR = ROOT / "build" / "chip_smoke_i"     # gitignored scratch of slice I
I1_SEQ = 4_096         # train_4k's sequence length
I1_MICRO = 4           # danube: 4 microbatches of 1 sequence (global 4;
                       # 8 until slice M took the time)
I2_MICRO = 4           # granite: 4 microbatches of 1 sequence (global 4)
I2_LAYERS = None       # granite's depth (None: all 32)
I_TIMED = 3            # timed steps after one warm-up, on 2 cycled batches
I_LR = 3e-6            # AdamW lr of I1 / I2 (see lm_train_cell)
I_GATE_SEQ = 512       # the f32 vs float64 gate: one sequence of 512
I_REPLAY_MICRO = 2     # the replay gate: 2 microbatches of 1 x I1_SEQ
I3_STEPS = 3           # the launcher at full width: 3 steps of 2 x I1_SEQ
I4_BATCH = 65_536      # DLRM-RM2 train_batch
I4_STEPS = 5
I4_LR = 1e-3
I4_HIGH = 2 ** 31      # the table's elements from here on need 64-bit offsets
EB_BWD_TOL = 1e-4      # backward kernel vs float64, share of sum |terms|
BF16_DENSE_FLOP_PER_S = 989e12   # H100 SXM bf16 tensor core, dense


def ptxas_report(name: str) -> dict:
    """{kernel function: "N registers, S bytes spill stores, L bytes spill
    loads"} from the last build log of library `name` ({} when it was
    loaded from disk)."""
    from repro_torch.kernels import _build
    out, fn, spill = {}, None, ""
    for line in _build.build_log(name).splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif "spill stores" in line:
            spill = line.strip().split(", ", 1)[1]
        elif "registers" in line and fn:
            regs = line.split("Used ")[1].split(",")[0]
            out[fn] = f"{regs}, {spill}"
    return out


def phase_backward_kernel() -> dict:
    """Phase 2 for embedding_bag's backward kernel at DLRM-RM2 train_batch's
    shapes: recsys_batch's power-law ids at B = 65,536 (26 bags of one row
    each, 1,703,936 entries; RM2's tables of 3-27 rows take ~20,000 adds
    per row), a random output gradient, the dense [33.7M, 64] gradient.
    Held on the touched rows to a float64 index_add_ and to the plain f32
    version, each within EB_BWD_TOL of sum |terms| per element (f32 sums
    of up to ~38,000 terms in no common order: a typical gap is
    ~sqrt(n) u ~ 1e-5 of it); untouched rows zero; a second launch
    bitwise equal. Timed (CUDA events): the kernel on a zeroed gradient
    (the whole call: sort + two passes), torch.sort alone, the plain
    version, index_add_ on the same rows (the library call) and the dense
    zero fill; the two passes by device time (torch.profiler, by kernel
    name); their ptxas registers and spills; the chunk plan and the
    pieces pass's resident blocks per SM."""
    import torch
    from repro_torch.configs.dlrm_rm2 import full_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.embedding_bag import ops as eb_ops
    from repro_torch.kernels.embedding_bag.ref import \
        embedding_bag_backward_ref
    from repro_torch.train.data import RecsysPipelineConfig, recsys_batch
    cfg = full_config()
    batch = recsys_batch(RecsysPipelineConfig(
        cfg.vocab_sizes, cfg.n_dense, cfg.bag_size, I4_BATCH), 0, "cuda")
    ids = batch["sparse_ids"].reshape(-1, cfg.bag_size).contiguous()
    del batch
    gen = torch.Generator(device="cuda").manual_seed(5)
    g = torch.randn((ids.shape[0], cfg.embed_dim), generator=gen,
                    device="cuda")
    v, d, n = cfg.padded_rows, cfg.embed_dim, ids.numel()
    grad = eb_ops.embedding_bag_backward(ids, g, v)
    torch.cuda.synchronize()
    uniq, inv = torch.unique(ids.reshape(-1), return_inverse=True)
    n_rows = uniq.numel()
    ids_u = inv.reshape(ids.shape).to(torch.int32)
    hot = int(torch.bincount(inv).max())
    got = grad[uniq.long()]
    want = embedding_bag_backward_ref(ids_u, g.double(), n_rows)
    mag = embedding_bag_backward_ref(ids_u, g.double().abs(), n_rows)
    share = float(((got.double() - want).abs()
                   / mag.clamp(min=1e-300)).max())
    plain = embedding_bag_backward_ref(ids_u, g, n_rows)
    share_plain = float(((got - plain).abs().double()
                         / mag.clamp(min=1e-300)).max())
    err = float((got.double() - want).abs().max())
    del want, plain
    grad[uniq.long()] = 0.0
    untouched_zero = not bool(grad.any())
    eb_ops._launch_backward(ids, g, grad, None)
    again = bool(torch.equal(grad[uniq.long()], got))
    log(f"[{CARD}] embedding_bag backward at train_batch (B={I4_BATCH:,} "
        f"x 26 bags of 1 = {n:,} entries, D={d}, {n_rows:,} touched rows, "
        f"hottest row {hot:,} adds): max |kernel - float64| {err:.3e}, "
        f"{share:.3e} of sum |terms| (limit {EB_BWD_TOL:g}); vs plain f32 "
        f"{share_plain:.3e}; untouched rows zero {untouched_zero}; second "
        f"launch bitwise {again}")
    check(share <= EB_BWD_TOL and share_plain <= EB_BWD_TOL,
          f"embedding_bag backward: {share:.3e} / {share_plain:.3e} of sum "
          f"|terms| (limit {EB_BWD_TOL})")
    check(untouched_zero and again, "embedding_bag backward: an untouched "
          "row is not zero or a second launch differs")
    chunk, n_chunks = eb_ops.backward_plan(n)
    per_sm = _build.library(
        "embedding_bag_backward").embedding_bag_backward_blocks_per_sm()
    for fn, line in ptxas_report("embedding_bag_backward").items():
        name = re.search(r"((?:backward|window)_(?:pieces|join)|"
                         r"window_histogram|window_digit_pass)I?"
                         r"((?:L[ib]\d+E)*)", fn)
        args = ",".join(re.findall(r"L[ib](\d+)E", name[2])) if name else ""
        log(f"[{CARD}] embedding_bag backward ptxas "
            f"{name[1] if name else fn}<{args}>: {line}")
    idx = ids.reshape(-1).long()
    flat = ids.reshape(-1)

    def call():
        eb_ops._launch_backward(ids, g, grad, None)
    ms = time_ms(call, 20)
    sort_ms = time_ms(lambda: torch.sort(flat, stable=True), 20)
    by_kernel = device_time_by_kernel(call, 20)
    pieces_ms = sum(us for k, us in by_kernel.items()
                    if "backward_pieces" in k) / 1e3
    join_ms = sum(us for k, us in by_kernel.items()
                  if "backward_join" in k) / 1e3
    zero_ms = time_ms(lambda: grad.zero_(), 5)
    lib_ms = time_ms(lambda: grad.index_add_(0, idx, g), 20)
    del grad
    torch.cuda.empty_cache()
    plain_ms = time_ms(lambda: embedding_bag_backward_ref(ids, g, v), 3)
    # each input read once, each output written once: grad_out, ids and
    # the touched rows (the kernel only stores them, into the zero fill
    # timed apart; its sort's permutation is its own, not the function's)
    bytes_ms = (4 * n * d + 4 * n + 4 * n_rows * d) / HBM_BYTES_PER_S * 1e3
    ops_ms = 2.0 * n * d / FP32_FLOP_PER_S * 1e3
    bnd = max(bytes_ms, ops_ms)
    log(f"[{CARD}] embedding_bag backward: whole call {ms:.4f} ms per "
        f"launch (CUDA events): torch.sort alone {sort_ms:.4f} ms, pieces "
        f"pass {pieces_ms:.4f} ms, join pass {join_ms:.4f} ms (device time, "
        f"torch.profiler); chunks of {chunk} entries x {n_chunks:,}, "
        f"{per_sm} resident blocks of 8 warps per SM; bound {bnd:.4f} ms "
        f"(bytes: grad_out + ids + one write of each touched row; "
        f"{bnd / ms:.0%} of it; the passes alone "
        f"{bnd / max(pieces_ms + join_ms, 1e-9):.0%}); plain "
        f"{plain_ms:.3f} ms (zeros + index_add_); index_add_ on the same "
        f"rows {lib_ms:.3f} ms; the dense zero fill of {4 * v * d:,} bytes "
        f"{zero_ms:.3f} ms")
    return {"err": err, "share": share, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "zero_ms": zero_ms, "bytes_ms": bytes_ms,
            "ops_ms": ops_ms, "touched_rows": n_rows, "hot": hot,
            "split_ms": {"sort": sort_ms, "pieces": pieces_ms,
                         "join": join_ms}}


def loss_and_grad_norm(loss_fn, params, batch) -> tuple[float, float]:
    """loss_fn(params, batch) and the global norm of its gradient (leaf
    sums of squares added in tree order, as `global_norm`), each leaf's
    gradient dropped as soon as its square sum is taken (a reduction that
    allocates no leaf-sized temporary: granite's float64 expert leaf is
    7.5 GiB)."""
    import torch
    from torch.utils import _pytree as pytree
    leaves, spec = pytree.tree_flatten(params)
    xs = [p.detach().requires_grad_(True) for p in leaves]
    sq = [torch.zeros((), dtype=p.dtype, device=p.device) for p in xs]

    def hook(i):
        def take(x):
            sq[i] = torch.linalg.vector_norm(x.grad).square()
            x.grad = None
        return take
    hooks = [x.register_post_accumulate_grad_hook(hook(i))
             for i, x in enumerate(xs)]
    try:
        loss = loss_fn(pytree.tree_unflatten(xs, spec), batch)
        torch.autograd.backward(loss, inputs=xs)
    finally:
        for h in hooks:
            h.remove()
    return float(loss.detach()), float(torch.sqrt(sum(sq)))


def lm_f64_gate(label: str, cfg, params, dev, gate: str = "I-a") -> dict:
    """Gate I-a (J-b under a mesh): one step's loss and grad norm at one
    sequence of I_GATE_SEQ tokens with compute_dtype float32 against
    float64 (the same parameters widened), loss rel <= LOSS_GAP_F64 and
    grad norm rel <= GNORM_GAP_F64 (slice G's gates); the bf16 loss
    against float64 printed."""
    import dataclasses
    import torch
    from functools import partial
    from torch.utils import _pytree as pytree
    from repro_torch.models import transformer as tf
    from repro_torch.train.data import TokenPipelineConfig, token_batch
    batch = token_batch(TokenPipelineConfig(cfg.vocab, I_GATE_SEQ, 1), 11,
                        dev)
    l32, g32 = loss_and_grad_norm(partial(
        tf.loss_fn, cfg=dataclasses.replace(cfg, compute_dtype="float32")),
        params, batch)
    with torch.no_grad():
        lbf = float(tf.loss_fn(params, batch, cfg))
    p64 = pytree.tree_map(lambda t: t.detach().double(), params)
    l64, g64 = loss_and_grad_norm(partial(
        tf.loss_fn, cfg=dataclasses.replace(cfg, compute_dtype="float64")),
        p64, batch)
    del p64
    torch.cuda.empty_cache()
    out = {"loss": abs(l32 - l64) / abs(l64),
           "grad_norm": abs(g32 - g64) / abs(g64),
           "bf16_loss": abs(lbf - l64) / abs(l64), "loss_f64": l64,
           "grad_norm_f64": g64}
    log(f"[{CARD}] {gate} {label} at 1 x {I_GATE_SEQ}: f32 vs float64 loss "
        f"{l32:.9g} vs {l64:.9g} (rel {out['loss']:.3e}, limit "
        f"{LOSS_GAP_F64:g}), grad norm {g32:.9g} vs {g64:.9g} (rel "
        f"{out['grad_norm']:.3e}, limit {GNORM_GAP_F64:g}); bf16 loss "
        f"{lbf:.9g} (rel {out['bf16_loss']:.3e}, printed)")
    check(out["loss"] <= LOSS_GAP_F64 and out["grad_norm"] <= GNORM_GAP_F64,
          f"{gate} {label}: f32 vs float64 gaps {out}")
    return out


def moe_drops(cfg, params, tokens) -> int:
    """MoE assignments the step's forward drops over `tokens` [M, S+1]
    (one microbatch per row, as the step sees them)."""
    return moe_drop_stats(cfg, params, tokens)["dropped"]


def moe_drop_stats(cfg, params, tokens) -> dict:
    """The MoE's drop counters (`stats`, as ints) of the step's forward
    over `tokens` [M, S+1], one microbatch per row, under the active mesh
    (the all-to-all path counts each stage too)."""
    import torch
    from repro_torch.models import transformer as tf
    stats = {}
    with torch.inference_mode():
        cp = tf.cast_params(params, cfg.cdtype)
        for row in tokens.split(1):
            tf._trunk(cp, row[:, :-1], cfg, stats=stats)
    return {k: int(v) for k, v in stats.items()}


def lm_step_idle(label: str, cfg, opt_cfg, params, opt, tokens,
                 n_micro: int, step_ms: float) -> dict:
    """The device's idle share of one train step of n_micro microbatches
    taking step_ms: torch.profiler over one microbatch's forward and
    backward (`tokens` [1, S+1]; its gradients drained into an f32
    accumulator by the step's own hooks), by operator (a whole step is
    ~10^5 launches, whose events take the profiler minutes to sort), and
    AdamW alone (in place, from that gradient) between CUDA events beside
    its bound (the profiler, started just before, misses the first of
    AdamW's few launches); idle = 1 - (n_micro x the microbatch's busy
    time + AdamW's) / step_ms. Takes three steps of the state from that
    microbatch."""
    import torch
    from torch.utils import _pytree as pytree
    from repro_torch.models import transformer as tf
    from repro_torch.train.optimizer import adamw_update
    leaves, spec = pytree.tree_flatten(params)
    xs = [p.detach().requires_grad_(True) for p in leaves]
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for p in leaves]

    def drain(a):
        def hook(x):
            a.add_(x.grad)
            x.grad = None
        return hook
    hooks = [x.register_post_accumulate_grad_hook(drain(a))
             for x, a in zip(xs, acc)]

    def forward_backward():
        loss = tf.loss_fn(pytree.tree_unflatten(xs, spec),
                          {"tokens": tokens}, cfg)
        torch.autograd.backward(loss, inputs=xs)
    try:
        fb = profile_device(forward_backward, f"{label}: one microbatch's "
                            f"forward and backward (1 x {tokens.shape[1] - 1},"
                            f" no optimizer)", by_op=True, warm=False)
    finally:
        for h in hooks:
            h.remove()
    del xs
    adam_ms = time_ms(lambda: adamw_update(pytree.tree_unflatten(acc, spec),
                                           opt, params, opt_cfg,
                                           in_place=True), 2)
    n = sum(t.numel() for t in acc)
    adam_bound = 8 * 4 * n / HBM_BYTES_PER_S * 1e3
    log(f"[{CARD}] {label}: AdamW alone (in place, {n:,} params in "
        f"{len(acc)} leaves, f32): {adam_ms:.3f} ms (CUDA events, mean of "
        f"2 after a warm-up), bound {adam_bound:.3f} ms (bytes: the norm's "
        f"read and the update's 7 passes; {adam_bound / adam_ms:.0%} of it)")
    del acc
    torch.cuda.empty_cache()
    idle = 1 - (n_micro * fb["busy_us"] / 1e3 + adam_ms) / step_ms
    log(f"[{CARD}] {label}: device idle share of a step, estimated as 1 - "
        f"({n_micro} x {fb['busy_us'] / 1e3:.1f} ms busy per microbatch + "
        f"{adam_ms:.1f} ms of AdamW) / {step_ms:.1f} ms: {idle:.3f}")
    return {"idle": idle, "profile": fb, "adam_ms": adam_ms,
            "adam_bound_ms": adam_bound}


def lm_train_cell(label: str, cfg, n_micro: int, dev,
                  profile: bool) -> tuple:
    """I1 / I2: make_train_step(loss_fn, AdamWConfig(lr=I_LR), n_micro,
    donate) on token_batch at I1_SEQ, global batch n_micro: one warm-up
    step and I_TIMED timed steps (CUDA events) on 2 cycled batches (each
    batch's loss must fall from one of its steps to the next), TFLOP/s of
    lm_train_flops against the bf16 dense peak, peak memory over all of
    them and the MoE's dropped assignments per step. With `profile`, the
    device's idle share of a step (`lm_step_idle`).
    Returns (report, params, opt).

    The lr is AdamWConfig's default (3e-4) cut to I_LR: AdamW (with no
    warm-up, as the reference's) first moves every weight by about lr in
    the sign of its gradient, and from random weights at width 2,560 the
    loss along that direction is least near 3e-6 (danube, batch 0:
    10.896 at 0, 10.678 at 3e-6, 10.716 at 1e-5, 14.061 at 3e-5). At
    1e-5 batch 0's loss rose to 12.317 after two steps (12.314 in f32)
    while a held-out batch's fell; at 3e-6 and 1e-6 each batch's loss
    fell on its repeat (probes/train_probe.py --lr),
    as slice G cuts its lr to G_LR."""
    import torch
    from functools import partial
    from torch.utils import _pytree as pytree
    from repro_torch.configs.lm_common import lm_train_flops
    from repro_torch.models import transformer as tf
    from repro_torch.train.data import TokenPipelineConfig, token_batch
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.train_loop import make_train_step
    t0 = time.perf_counter()
    params = tf.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    opt_cfg = AdamWConfig(lr=I_LR)
    opt = adamw_init(params, opt_cfg)
    dcfg = TokenPipelineConfig(cfg.vocab, I1_SEQ, n_micro)
    batches = [token_batch(dcfg, i, dev) for i in range(2)]
    step = make_train_step(partial(tf.loss_fn, cfg=cfg), opt_cfg,
                           num_microbatches=n_micro, donate=True)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(I_TIMED + 2)]
    losses, gnorms = [], []
    before = read_counts()
    ev[0].record()
    for i in range(I_TIMED + 1):
        params, opt, m = step(params, opt, batches[i % 2])
        ev[i + 1].record()
        losses.append(m["loss"])
        gnorms.append(m["grad_norm"])
    torch.cuda.synchronize()
    gate_adamw("slice_i", label, adamw_delta(before, read_counts()),
               len(pytree.tree_leaves(params)), I_TIMED + 1)
    peak = torch.cuda.max_memory_allocated()
    all_ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(I_TIMED + 1)]
    losses = [float(x) for x in losses]
    gnorms = [float(x) for x in gnorms]
    check(all(np.isfinite(losses)) and all(np.isfinite(gnorms)),
          f"{label}: non-finite loss or grad norm {losses} {gnorms}")
    # the batches alternate: each step's loss against the same batch's
    # two steps before
    check(all(b < a for a, b in zip(losses, losses[2:])),
          f"{label}: the loss on a repeated batch did not fall ({losses})")
    ms = float(np.mean(all_ms[1:]))
    tokens = n_micro * I1_SEQ
    flops = lm_train_flops(cfg, tokens, n_micro, I1_SEQ)
    tflops = flops / ms / 1e9
    out = {"ms": ms, "warmup_ms": all_ms[0], "step_ms": all_ms[1:],
           "losses": losses, "grad_norms": gnorms, "peak": peak,
           "tflops": tflops, "mfu": tflops * 1e12 / BF16_DENSE_FLOP_PER_S,
           "params": cfg.n_params(), "setup_s": setup_s}
    drops = ""
    if cfg.moe:
        out["dropped"] = moe_drops(cfg, params, batches[0]["tokens"])
        total = tokens * cfg.moe.top_k * cfg.n_layers
        drops = (f"; MoE assignments dropped per step {out['dropped']:,} of "
                 f"{total:,}")
    log(f"[{CARD}] {label} ({cfg.n_layers} layers, {cfg.n_params():,} "
        f"params) train step at {n_micro} x 1 x {I1_SEQ} tokens: set-up "
        f"{setup_s:.1f} s, warm-up {all_ms[0]:.1f} ms, {ms:.1f} ms per step "
        f"(CUDA events, mean of {I_TIMED}: "
        f"{', '.join(f'{t:.1f}' for t in all_ms[1:])}), {tflops:.2f} TFLOP/s "
        f"of lm_train_flops ({out['mfu']:.1%} of 989 bf16 dense), peak "
        f"{peak:,} bytes; loss {', '.join(f'{x:.5f}' for x in losses)}"
        f"{drops}")
    if profile:
        out.update(lm_step_idle(label, cfg, opt_cfg, params, opt,
                                batches[0]["tokens"][:1], n_micro, ms))
    del step, batches
    return out, params, opt


def gate_replay(cfg, params, opt, dev) -> dict:
    """Gate I-b on danube: clone the state, take one step (2 microbatches
    of 1 x I1_SEQ, donated), restore the clone and replay it: bitwise with
    deterministic algorithms on; the gap with them off printed."""
    import torch
    from functools import partial
    from torch.utils import _pytree as pytree
    from repro_torch.models import transformer as tf
    from repro_torch.train.data import TokenPipelineConfig, token_batch
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_loop import make_train_step
    batch = token_batch(TokenPipelineConfig(cfg.vocab, I1_SEQ,
                                            I_REPLAY_MICRO), 7, dev)
    step = make_train_step(partial(tf.loss_fn, cfg=cfg),
                           AdamWConfig(lr=I_LR),
                           num_microbatches=I_REPLAY_MICRO, donate=True)
    state = pytree.tree_leaves((params, opt))
    saved = [t.clone() for t in state]

    def restore():
        with torch.no_grad():
            for a, b in zip(state, saved):
                a.copy_(b)

    def gap(ref):
        return max(float((a - b).abs().max())
                   for a, b in zip(pytree.tree_leaves(params), ref))
    m1 = deterministic(lambda: step(params, opt, batch)[2])
    first = [t.clone() for t in pytree.tree_leaves(params)]
    restore()
    m2 = deterministic(lambda: step(params, opt, batch)[2])
    det_gap = gap(first)
    same_loss = bool(torch.equal(m1["loss"], m2["loss"]))
    restore()
    m3 = step(params, opt, batch)[2]
    atomic_gap = gap(first)
    atomic_loss = abs(float(m3["loss"]) - float(m1["loss"]))
    restore()
    del saved, first
    torch.cuda.empty_cache()
    log(f"[{CARD}] I-b danube replay ({I_REPLAY_MICRO} x 1 x {I1_SEQ}): "
        f"deterministic max param gap {det_gap:.3e}, loss equal "
        f"{same_loss}; with atomics: max param gap {atomic_gap:.3e}, loss "
        f"gap {atomic_loss:.3e}")
    check(det_gap == 0.0 and same_loss,
          f"I-b: the replay differs from the step (gap {det_gap})")
    return {"gap": det_gap, "atomic_gap": atomic_gap,
            "atomic_loss_gap": atomic_loss}


def phase_slice_i3() -> dict:
    """I3: the launcher at full width (--arch h2o-danube-1.8b, 3 steps of
    2 x I1_SEQ, no checkpoint: a full-width checkpoint is ~29 GB of
    zlib'd f32; its output must hold the elastic mesh's line, "mesh:
    (1, 1) over 1 device(s)", gate K-d), then --smoke with --ckpt-dir
    twice: it saves, resumes and prints "resumed from step"."""
    import contextlib
    import io
    import shutil as _shutil
    import torch
    from repro_torch.launch import train as launch_train
    dev = [] if I_DEVICE == "cuda" else ["--device", I_DEVICE]
    t0 = time.perf_counter()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        out = launch_train.main(["--arch", "h2o-danube-1.8b", "--steps",
                                 str(I3_STEPS), "--global-batch", "2",
                                 "--seq-len", str(I1_SEQ)] + dev)
    full_s = time.perf_counter() - t0
    log(printed.getvalue().rstrip())
    # K-d: the launcher builds and prints the elastic mesh, as the
    # reference does
    check("mesh: (1, 1) over 1 device(s)" in printed.getvalue()
          and out["mesh"] == (1, 1),
          f"K-d: the launcher's mesh line is missing: {printed.getvalue()}")
    check(all(np.isfinite(out["losses"])), f"I3: losses {out['losses']}")
    del out["params"], out["opt"]
    torch.cuda.empty_cache()
    ckpt_dir = I_DIR / "checkpoints"
    _shutil.rmtree(ckpt_dir, ignore_errors=True)
    smoke = ["--arch", "h2o-danube-1.8b", "--smoke", "--steps", "2",
             "--global-batch", "4", "--seq-len", "12", "--ckpt-dir",
             str(ckpt_dir)] + dev
    runs = []
    for _ in range(2):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            r = launch_train.main(smoke)
        runs.append((r["start_step"], buf.getvalue()))
    _shutil.rmtree(ckpt_dir, ignore_errors=True)
    resumed = "resumed from step 1" in runs[1][1]
    log(f"[{CARD}] I3 launcher, danube at full width, {I3_STEPS} steps of "
        f"2 x {I1_SEQ}: {full_s:.1f} s with set-up, s per step "
        f"{', '.join(f'{x:.2f}' for x in out['step_s'])}, losses "
        f"{', '.join(f'{x:.5f}' for x in out['losses'])}; --smoke "
        f"--ckpt-dir twice: start steps {runs[0][0]} and {runs[1][0]}, "
        f"second run printed 'resumed from step 1' {resumed}")
    check(runs[0][0] == 0 and runs[1][0] == 2 and resumed,
          f"I3: the launcher did not resume ({runs})")
    return {"step_s": out["step_s"], "losses": out["losses"],
            "seconds": full_s}


def dlrm_f64_step(params, batch, cfg) -> tuple[float, float]:
    """The DLRM loss and grad norm of one step in float64 on the card,
    in plain torch (index_select, not the f32-only kernels): the MLPs
    and the rows the batch reads, widened (the other rows' gradient is
    zero, so the norm is the full table's)."""
    import torch
    from torch.utils import _pytree as pytree
    from repro_torch.models.layers import mlp_apply
    from repro_torch.models.recsys import dlrm
    uniq, inv = torch.unique(batch["sparse_ids"].reshape(-1),
                             return_inverse=True)
    sub = params["table"][uniq.long()].double().requires_grad_(True)
    mlps = pytree.tree_map(lambda t: t.detach().double().requires_grad_(
        True), {"bot": params["bot"], "top": params["top"]})
    dense = batch["dense"].double()
    b = dense.shape[0]
    d = mlp_apply(mlps["bot"], dense, final_act=True)
    emb = sub[inv.reshape(-1)].reshape(b, cfg.n_sparse, cfg.bag_size,
                                       cfg.embed_dim).sum(2)
    logit = mlp_apply(mlps["top"], dlrm._interact(d, emb))[:, 0]
    y = batch["labels"].double()
    loss = (torch.maximum(logit, torch.zeros_like(logit)) - logit * y
            + torch.log1p(torch.exp(-logit.abs()))).mean()
    grads = torch.autograd.grad(loss, [sub] + pytree.tree_leaves(mlps))
    return float(loss.detach()), float(torch.sqrt(sum(g.square().sum()
                                             for g in grads)))


def i4_adamw(params, opt, opt_cfg) -> dict:
    """I4's AdamW at the real table, after the timed steps. One update (in
    place) from a seeded gradient; the table's elements from I4_HIGH =
    2^31 on (from two rows before to the end: the update is elementwise,
    so a slice is exact) held bitwise to the plain version of the same update on those
    rows. Then CUDA-event times (3 calls after a warm-up; 2 for the plain
    versions) of AdamW alone (`adamw_update`: the norm's and the update's
    kernels and the scalars between), of each kernel over every leaf, of
    their plain versions, of torch._fused_adamw_ on the same leaves (the
    library call for the update; it clips nothing) and of
    torch.linalg.vector_norm per leaf (the library call for the norm),
    beside their bounds; sum_squares of each leaf against a float64 sum."""
    import torch
    from torch.utils import _pytree as pytree
    from repro_torch.kernels.adamw.ops import adamw_step, sum_squares
    from repro_torch.kernels.adamw.ref import adamw_step_ref, sum_squares_ref
    from repro_torch.train.optimizer import _leaves_like, adamw_update
    gen = torch.Generator(device=params["table"].device).manual_seed(11)
    grads = pytree.tree_map(
        lambda t: torch.empty_like(t).normal_(0.0, 1e-3, generator=gen),
        params)
    dim = params["table"].shape[1]
    first = I4_HIGH // dim - 2
    rows = slice(first, None)
    snap = [t["table"][rows].clone() for t in (params, grads, opt["m"],
                                                opt["v"])]
    _, _, met = adamw_update(grads, opt, params, opt_cfg, in_place=True)
    hyper = {"lr": opt_cfg.lr, "b1": opt_cfg.b1, "b2": opt_cfg.b2,
             "eps": opt_cfg.eps, "weight_decay": opt_cfg.weight_decay}
    scale = torch.clamp(opt_cfg.grad_clip / (met["grad_norm"] + 1e-9),
                        max=1.0)
    stepf = opt["step"].to(torch.float32)
    bc1, bc2 = (1.0 - torch.pow(torch.tensor(b, dtype=torch.float32,
                                             device=stepf.device), stepf)
                for b in (opt_cfg.b1, opt_cfg.b2))
    want = adamw_step_ref(*snap, scale, bc1, bc2, **hyper)
    got = (params["table"][rows], opt["m"]["table"][rows],
           opt["v"]["table"][rows])
    n_high = got[0].numel()
    high_ok = n_high > 2 * dim and all(torch.equal(a, b)
                                       for a, b in zip(got, want))
    log(f"[{CARD}] I4 AdamW at the real table: elements {first * dim:,} "
        f"to {params['table'].numel():,} (past {I4_HIGH:,}) of p, m and v "
        f"after one update bitwise the plain version on those rows: "
        f"{high_ok} ({n_high:,} elements each)")
    check(high_ok, f"I4: the update past element {I4_HIGH:,} differs from "
          "plain")
    del snap, want, got
    p_l = pytree.tree_leaves(params)
    g_l = _leaves_like(grads, params)
    m_l, v_l = _leaves_like(opt["m"], params), _leaves_like(opt["v"], params)
    n = sum(t.numel() for t in p_l)
    k_norm = [float(sum_squares(g)) for g in g_l]
    f64 = [sum(float(c.double().square().sum())
               for c in torch.split(g.reshape(-1), 1 << 26)) for g in g_l]
    norm_err = max(abs(a - b) for a, b in zip(k_norm, f64))
    norm_rel = max(abs(a - b) / b for a, b in zip(k_norm, f64))
    check(norm_rel <= NORM_TOL, f"I4: sum_squares vs float64 rel "
          f"{norm_rel:.3e}")

    def update(fn):
        return lambda: [fn(p, g, m, v, scale, bc1, bc2, in_place=True,
                           **hyper) for p, g, m, v in zip(p_l, g_l, m_l,
                                                           v_l)]
    adam_ms = time_ms(lambda: adamw_update(grads, opt, params, opt_cfg,
                                           in_place=True), 3)
    upd_ms = time_ms(update(adamw_step), 3)
    plain_upd_ms = time_ms(update(adamw_step_ref), 2)
    norm_ms = time_ms(lambda: [sum_squares(g) for g in g_l], 3)
    plain_norm_ms = time_ms(lambda: [sum_squares_ref(g) for g in g_l], 2)
    lib_norm_ms = time_ms(lambda: [torch.linalg.vector_norm(g)
                                   for g in g_l], 3)
    steps = [torch.full((), 7.0, device=p.device) for p in p_l]
    lib_ms = time_ms(lambda: torch._fused_adamw_(
        p_l, g_l, m_l, v_l, [], steps, lr=opt_cfg.lr, beta1=opt_cfg.b1,
        beta2=opt_cfg.b2, weight_decay=opt_cfg.weight_decay,
        eps=opt_cfg.eps, amsgrad=False, maximize=False), 3)
    # all f32: p, g, m, v read and p, m, v written once, and the scalars
    upd_bytes = 7 * 4 * n + 12 * len(p_l)
    norm_bytes = 4 * n + 4 * len(p_l)
    upd_b, upd_by = bound(upd_bytes / HBM_BYTES_PER_S * 1e3,
                          17 * n / FP32_FLOP_PER_S * 1e3)
    norm_b, norm_by = bound(norm_bytes / HBM_BYTES_PER_S * 1e3,
                            2 * n / FP32_FLOP_PER_S * 1e3)
    adam_b = (upd_bytes + norm_bytes) / HBM_BYTES_PER_S * 1e3
    log(f"[{CARD}] I4 AdamW alone (adamw_update in place, {len(p_l)} "
        f"leaves, {n:,} params): {adam_ms:.3f} ms, bound {adam_b:.3f} ms "
        f"(bytes: the norm's read and the update's 7 passes, "
        f"{upd_bytes + norm_bytes:,} bytes; {adam_b / adam_ms:.0%} of it); "
        f"adamw_step over the leaves {upd_ms:.3f} ms (bound {upd_b:.3f} ms "
        f"by {upd_by}, {upd_b / upd_ms:.0%}; plain {plain_upd_ms:.3f} ms, "
        f"torch._fused_adamw_ {lib_ms:.3f} ms); sum_squares over the leaves "
        f"{norm_ms:.3f} ms (bound {norm_b:.3f} ms by {norm_by}, "
        f"{norm_b / norm_ms:.0%}; plain {plain_norm_ms:.3f} ms, "
        f"torch.linalg.vector_norm {lib_norm_ms:.3f} ms), max |err| vs "
        f"float64 {norm_err:.3e} (rel {norm_rel:.3e})")
    del grads, steps
    torch.cuda.empty_cache()
    return {"adam_ms": adam_ms, "adam_bound_ms": adam_b,
            "step": {"ms": upd_ms, "plain_ms": plain_upd_ms,
                     "library_ms": lib_ms, "bound_ms": upd_b,
                     "bound_by": upd_by},
            "norm": {"ms": norm_ms, "plain_ms": plain_norm_ms,
                     "library_ms": lib_norm_ms, "bound_ms": norm_b,
                     "bound_by": norm_by, "err": norm_err,
                     "rel": norm_rel},
            "high_elements": n_high}


def phase_slice_i4() -> dict:
    """I4: DLRM-RM2 full_config() (8.64 GB table) at train_batch
    (B = 65,536): I4_STEPS AdamW steps (lr I4_LR, donated) on 2 cycled
    recsys_batch batches (finite, the loss falls), the first against a
    float64 step (loss rel <= LOSS_GAP_F64, grad norm rel <=
    GNORM_GAP_F64), both embedding_bag counters equal to the steps, ms per
    step beside its bytes bound, the optimizer's share, peak memory, a
    profile of one step by operator."""
    import torch
    from functools import partial
    from repro_torch.configs.dlrm_rm2 import full_config
    from repro_torch.models.recsys import dlrm
    from repro_torch.train.data import RecsysPipelineConfig, recsys_batch
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.train_loop import make_train_step
    from torch.utils import _pytree as pytree
    dev = torch.device(I_DEVICE)
    cfg = full_config()
    params = dlrm.init_params(cfg, seed=0, device=dev)
    pcfg = RecsysPipelineConfig(cfg.vocab_sizes, cfg.n_dense, cfg.bag_size,
                                I4_BATCH)
    batches = [recsys_batch(pcfg, i, dev) for i in range(2)]
    l64, g64 = dlrm_f64_step(params, batches[0], cfg)
    torch.cuda.empty_cache()
    opt_cfg = AdamWConfig(lr=I4_LR)
    opt = adamw_init(params, opt_cfg)
    step = make_train_step(partial(dlrm.loss_fn, cfg=cfg), opt_cfg,
                           donate=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(I4_STEPS + 1)]
    ms_list, losses, gnorms = [], [], []
    ev[0].record()
    for i in range(I4_STEPS):
        params, opt, m = step(params, opt, batches[i % 2])
        ev[i + 1].record()
        losses.append(m["loss"])
        gnorms.append(m["grad_norm"])
    torch.cuda.synchronize()
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    ms_list = [ev[i].elapsed_time(ev[i + 1]) for i in range(I4_STEPS)]
    losses = [float(x) for x in losses]
    gnorms = [float(x) for x in gnorms]
    check(all(np.isfinite(losses)), f"I4: losses {losses}")
    check(losses[-1] < losses[0], f"I4: the loss did not fall ({losses})")
    check(launches["embedding_bag"] == I4_STEPS
          and launches["embedding_bag_backward"] == I4_STEPS,
          f"I4: embedding_bag launches {launches['embedding_bag']} forward, "
          f"{launches['embedding_bag_backward']} backward for {I4_STEPS} "
          "steps")
    gate_adamw("slice_i", "I4 DLRM-RM2", launches,
               len(pytree.tree_leaves(params)), I4_STEPS)
    gap_l = abs(losses[0] - l64) / abs(l64)
    gap_g = abs(gnorms[0] - g64) / abs(g64)
    log(f"[{CARD}] I4 DLRM-RM2 f32 vs float64, first step: loss "
        f"{losses[0]:.9g} vs {l64:.9g} (rel {gap_l:.3e}, limit "
        f"{LOSS_GAP_F64:g}), grad norm {gnorms[0]:.9g} vs {g64:.9g} (rel "
        f"{gap_g:.3e}, limit {GNORM_GAP_F64:g})")
    check(gap_l <= LOSS_GAP_F64 and gap_g <= GNORM_GAP_F64,
          f"I4: f32 vs float64 gaps {gap_l:.3e}, {gap_g:.3e}")
    n_bytes = 4 * sum(t.numel() for t in pytree.tree_leaves(params))
    table_bytes = 4 * params["table"].numel()
    bound_ms = (table_bytes + 8 * n_bytes) / HBM_BYTES_PER_S * 1e3
    ms = float(np.mean(ms_list[1:]))
    prof = profile_device(lambda: step(params, opt, batches[0]),
                          "one DLRM-RM2 train step at train_batch",
                          by_op=True, warm=False)
    adam = i4_adamw(params, opt, opt_cfg)
    adam_ms = adam["adam_ms"]
    log(f"[{CARD}] I4 DLRM-RM2 train_batch (B={I4_BATCH:,}, table "
        f"{table_bytes:,} bytes): {ms:.3f} ms per step (CUDA events, mean "
        f"of steps 2-{I4_STEPS}; all: "
        f"{', '.join(f'{t:.3f}' for t in ms_list)}), bound {bound_ms:.3f} ms "
        f"(bytes: the table gradient's zero fill, the norm's read and "
        f"AdamW's read of p, g, m, v and write of p, m, v: "
        f"{table_bytes + 8 * n_bytes:,} bytes; {bound_ms / ms:.0%} of it); "
        f"AdamW alone {adam_ms:.3f} ms ({adam_ms / ms:.0%} of the step); "
        f"peak {peak:,} bytes; loss {', '.join(f'{x:.6f}' for x in losses)};"
        f" embedding_bag launches {launches['embedding_bag']} forward, "
        f"{launches['embedding_bag_backward']} backward")
    del params, opt, step, batches
    torch.cuda.empty_cache()
    return {"ms": ms, "step_ms": ms_list, "bound_ms": bound_ms,
            "adam_ms": adam_ms, "adam": adam, "peak": peak,
            "losses": losses,
            "f64": {"loss": gap_l, "grad_norm": gap_g}, "profile": prof,
            "launches": launches}


def phase_slice_i() -> dict:
    """Slice I, training on the card: I1 danube at full width (with gates
    I-b and I-a on its state), I3 the launcher, I4 DLRM-RM2 at
    train_batch, I2 granite (with I-a). bf16 compute as the configs set
    it, TF32 off, cuBLAS bf16 reductions in f32, random weights from
    generator seed 0. Returns each part, the kernel launches of I4's path
    (the LM paths launch no kernel of the repo) and granite's config and
    parameters after I2, which slice J trains on (its AdamW state goes
    before I-a, whose float64 copy would not fit beside it)."""
    import dataclasses
    import torch
    from repro_torch.configs import granite_moe_3b, h2o_danube_1_8b
    dev = torch.device(I_DEVICE)
    t0 = time.perf_counter()
    prev = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    try:
        reset_counts()
        cfg = h2o_danube_1_8b.full_config()
        i1, params, opt = lm_train_cell("I1 danube", cfg, I1_MICRO, dev,
                                        profile=True)
        lm_launches = read_counts()
        replay = gate_replay(cfg, params, opt, dev)
        del opt
        torch.cuda.empty_cache()
        gate_d = lm_f64_gate("danube", cfg, params, dev)
        del params
        torch.cuda.empty_cache()
        i3 = phase_slice_i3()
        torch.cuda.empty_cache()
        i4 = phase_slice_i4()
        cfg2 = granite_moe_3b.full_config()
        if I2_LAYERS:
            cfg2 = dataclasses.replace(cfg2, n_layers=I2_LAYERS)
        reset_counts()
        i2, params, opt = lm_train_cell("I2 granite", cfg2, I2_MICRO, dev,
                                        profile=True)
        lm_launches = add_counts(lm_launches, read_counts())
        del opt
        torch.cuda.empty_cache()
        gate_g = lm_f64_gate("granite", cfg2, params, dev)
        torch.cuda.empty_cache()
    finally:
        torch.backends.cuda.matmul.\
            allow_bf16_reduced_precision_reduction = prev
    check(lm_launches["bsr_spmm"] == lm_launches["cheb_step"]
          == lm_launches["embedding_bag"] == 0,
          f"the LM train steps launched a kernel off their path: "
          f"{lm_launches}")
    secs = time.perf_counter() - t0
    log(f"[{CARD}] slice I: {secs:.1f} s")
    return {"i1": i1, "i2": i2, "i3": i3, "i4": i4, "replay": replay,
            "f64": {"danube": gate_d, "granite": gate_g},
            "launches": i4["launches"], "seconds": secs,
            "granite": (cfg2, params)}


# ---------------------------------------------------------------- slice J --
J_MICRO = I2_MICRO     # granite: 4 microbatches of 1 x I1_SEQ, as I2
J_NODROP_CF = 8.0      # J-a's capacity factor, raised to E / k where that
                       # is more, so neither path can drop an assignment
J_QWEN_GATE_SEQ = 128  # qwen3's J-a sequence: at E / k = 16 its f32 a2a
                       # expert buffer is [128, 16 T, 4,096]
J_ROUNDS = 1           # timed rounds of dense, a2a, a2a, dense steps
                       # (probes/slice_j_probe.py --rounds takes more)
J_A2A_LOSS_GAP = 1e-5  # J-a: a2a vs dense, relative
J_A2A_GNORM_GAP = 1e-4
J_QWEN_LAYERS = 2      # qwen3-moe-235b-a22b cut from 94 layers (f32 ~24 GB)


def with_moe(cfg, **kw):
    """cfg with its MoEConfig fields `kw` replaced."""
    import dataclasses
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **kw))


def trip_calls() -> dict:
    """{site: calls} of the all-to-all MoE's collectives since the last
    `reset_collective_counts` (dispatch, return, their _grad, aux)."""
    from repro_torch.core.distributed import collective_counts
    from repro_torch.models.moe import TRIPS
    return {k.split("/")[1]: v["calls"]
            for k, v in collective_counts().items()
            if k.startswith(TRIPS + "/")}


def a2a_capacities(cfg, tokens: int, ep: int = 1) -> dict:
    """moe_apply_a2a's capacities and buffer bytes at `tokens` per rank
    (the reference's formulas), beside the dense path's capacity."""
    from repro_torch.models.moe import a2a_capacities as caps, moe_capacity
    m, d = cfg.moe, cfg.d_model
    e_loc = m.n_experts // ep
    cap_loc, cap2 = caps(m, tokens, ep)
    width = 2 if cfg.compute_dtype == "bfloat16" else 4
    return {"cap_loc": cap_loc, "cap2": cap2,
            "dense_cap": moe_capacity(m, tokens),
            "send_x_bytes": ep * cap_loc * d * width,
            "buf_bytes": e_loc * cap2 * d * width}


def gate_a2a_dense(label: str, cfg, params, mesh, dev,
                   seq: int | None = None) -> dict:
    """J-a: the loss and grad norm of one sequence of `seq` tokens
    (default I_GATE_SEQ) with
    compute float32, through the all-to-all path under `mesh` against the
    dense path, at capacity factor max(J_NODROP_CF, E / k): from E / k on
    the dense path has a slot per token in every expert (cf T k / E >= T)
    and at ep = 1 so do both a2a stages. The two paths' capacities
    differ, so only where nothing drops do they compute the same
    function: neither path may drop an assignment (their forwards'
    counters). Loss rel <= J_A2A_LOSS_GAP, grad norm rel <=
    J_A2A_GNORM_GAP; the a2a call makes trips and the dense one none."""
    import dataclasses
    from functools import partial
    from repro_torch.core.distributed import reset_collective_counts
    from repro_torch.distributed import use_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.train.data import TokenPipelineConfig, token_batch
    seq = seq or I_GATE_SEQ
    batch = token_batch(TokenPipelineConfig(cfg.vocab, seq, 1), 12, dev)
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    cf = max(J_NODROP_CF, cfg.moe.n_experts / cfg.moe.top_k)
    res, trips, drops = {}, {}, {}
    for name, m in (("a2a", mesh), ("dense", None)):
        c = with_moe(f32, impl=name, capacity_factor=cf)
        reset_collective_counts()
        with use_mesh(m):
            res[name] = loss_and_grad_norm(partial(tf.loss_fn, cfg=c),
                                           params, batch)
            trips[name] = sum(trip_calls().values())
            drops[name] = moe_drop_stats(c, params, batch["tokens"])[
                "dropped"]
    (la, ga), (ld, gd) = res["a2a"], res["dense"]
    out = {"loss": abs(la - ld) / abs(ld), "grad_norm": abs(ga - gd) / abs(gd),
           "trips": trips, "capacity_factor": cf, "dropped": drops}
    log(f"[{CARD}] J-a {label} at 1 x {seq}, f32, capacity factor "
        f"{cf:g}: a2a vs dense loss {la:.9g} vs {ld:.9g} (rel "
        f"{out['loss']:.3e}, limit {J_A2A_LOSS_GAP:g}), grad norm {ga:.9g} "
        f"vs {gd:.9g} (rel {out['grad_norm']:.3e}, limit "
        f"{J_A2A_GNORM_GAP:g}); trips a2a {trips['a2a']}, dense "
        f"{trips['dense']}; dropped a2a {drops['a2a']}, dense "
        f"{drops['dense']}")
    check(out["loss"] <= J_A2A_LOSS_GAP and out["grad_norm"] <= J_A2A_GNORM_GAP
          and trips["a2a"] > 0 and trips["dense"] == 0
          and drops["a2a"] == drops["dense"] == 0,
          f"J-a {label}: a2a vs dense {out}")
    return out


def gate_a2a_bitwise(cfg, params, mesh, tokens) -> dict:
    """J-c: the loss and every gradient leaf of one microbatch (`tokens`
    [1, S+1], the train config) through the all-to-all path, twice with
    deterministic algorithms on: bitwise equal; the gap of a third call
    with them off printed."""
    import torch
    from torch.utils import _pytree as pytree
    from repro_torch.distributed import use_mesh
    from repro_torch.models import transformer as tf
    leaves, spec = pytree.tree_flatten(params)

    def call():
        xs = [p.detach().requires_grad_(True) for p in leaves]
        with use_mesh(mesh):
            loss = tf.loss_fn(pytree.tree_unflatten(xs, spec),
                              {"tokens": tokens}, cfg)
            grads = torch.autograd.grad(loss, xs)
        return loss.detach(), grads
    l1, g1 = deterministic(call)
    l2, g2 = deterministic(call)
    same = bool(torch.equal(l1, l2)) and all(
        bool(torch.equal(a, b)) for a, b in zip(g1, g2))
    del g2
    l3, g3 = call()
    gap = max(float((a - b).abs().max()) for a, b in zip(g1, g3))
    loss_gap = abs(float(l3) - float(l1))
    del g1, g3
    torch.cuda.empty_cache()
    log(f"[{CARD}] J-c granite a2a, 1 x {tokens.shape[1] - 1}: a second "
        f"call with deterministic algorithms on is bitwise equal (loss and "
        f"{len(leaves)} gradient leaves) {same}; with them off: max "
        f"gradient gap {gap:.3e}, loss gap {loss_gap:.3e}")
    check(same, "J-c: a second a2a call is not bitwise equal")
    return {"bitwise": same, "atomic_gap": gap, "atomic_loss_gap": loss_gap}


def trip_cost(mesh, rows: int, d: int, dev, reps: int = 50) -> dict:
    """One dispatch trip's cost at world size 1: `all_to_all` over the
    mesh's "model" group of a [rows, d] bf16 send buffer, against a device
    copy of the same buffer: device ms per call (CUDA events) and host ms
    per call (the host clock around the enqueue of `reps` calls)."""
    import torch
    from repro_torch.core.distributed import all_to_all
    x = torch.ones((rows, d), dtype=torch.bfloat16, device=dev)
    group = mesh.get_group("model")
    out = {}
    for name, fn in (("all_to_all", lambda: all_to_all(x, group)),
                     ("copy", lambda: torch.empty_like(x).copy_(x))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ms = time_ms(fn, reps, warmup=0)
        host = (time.perf_counter() - t0) * 1e3 / reps
        out[name] = {"ms": ms, "host_ms": host}
    log(f"[{CARD}] J one trip at world size 1, [{rows:,}, {d}] bf16 "
        f"({2 * rows * d:,} bytes): all_to_all {out['all_to_all']['ms']:.4f}"
        f" ms device, {out['all_to_all']['host_ms']:.4f} ms host per call; "
        f"a device copy {out['copy']['ms']:.4f} ms, "
        f"{out['copy']['host_ms']:.4f} ms host (mean of {reps})")
    return out


def j_steps(cfg_d, cfg_a, params, mesh, dev) -> dict:
    """Granite's train step (make_train_step, AdamWConfig(lr=I_LR),
    J_MICRO microbatches of 1 x I1_SEQ, donated) dense and all-to-all on
    I2's batches, from a fresh AdamW state (I2's went before gate I-a):
    an a2a warm-up on batch 1, then J_ROUNDS rounds of dense, a2a, a2a, dense
    on batch 0 (the step is host-bound and moves from call to call; the medians
    are compared), each timed with CUDA events and its peak memory taken. J-d:
    the timed a2a steps made their trips (per layer and microbatch: 3 dispatch
    and 1 return forward, as many again where the checkpointed block is
    recomputed, which stops after the return trip, and the 2 gradient trips),
    the dense steps none; a forward over batch 0 makes exactly 4 per layer and
    microbatch. Dropped assignments of that forward at each stage beside the
    dense path's; the device's idle share of an a2a step
    (`lm_step_idle`, which takes one more step)."""
    import torch
    from functools import partial
    from torch.utils import _pytree as pytree
    from repro_torch.core.distributed import reset_collective_counts
    from repro_torch.distributed import use_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.train.data import TokenPipelineConfig, token_batch
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.train_loop import make_train_step
    opt_cfg = AdamWConfig(lr=I_LR)
    opt = adamw_init(params, opt_cfg)
    batches = [token_batch(TokenPipelineConfig(cfg_d.vocab, I1_SEQ, J_MICRO),
                           i, dev) for i in range(2)]
    steps = {"dense": make_train_step(partial(tf.loss_fn, cfg=cfg_d),
                                      opt_cfg, J_MICRO, donate=True)}
    a2a_step = make_train_step(partial(tf.loss_fn, cfg=cfg_a), opt_cfg,
                               J_MICRO, donate=True)

    def under_mesh(p, o, b):
        with use_mesh(mesh):
            return a2a_step(p, o, b)
    steps["a2a"] = under_mesh
    steps["a2a"](params, opt, batches[1])
    torch.cuda.synchronize()
    reset_collective_counts()
    ms = {"dense": [], "a2a": []}
    peak = {"dense": 0, "a2a": 0}
    losses = []
    before = read_counts()
    for kind in ("dense", "a2a", "a2a", "dense") * J_ROUNDS:
        torch.cuda.reset_peak_memory_stats()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        _, _, m = steps[kind](params, opt, batches[0])
        ev[1].record()
        torch.cuda.synchronize()
        ms[kind].append(ev[0].elapsed_time(ev[1]))
        peak[kind] = max(peak[kind], torch.cuda.max_memory_allocated())
        losses.append((kind, float(m["loss"])))
    gate_adamw("slice_j", "J granite dense and a2a steps",
               adamw_delta(before, read_counts()),
               len(pytree.tree_leaves(params)), 4 * J_ROUNDS)
    trips = trip_calls()
    # each round's a2a steps over its dense steps: the rounds' interleaving
    # cancels a drift of the host's speed that is linear within a round
    ratios = [(ms["a2a"][2 * r] + ms["a2a"][2 * r + 1])
              / (ms["dense"][2 * r] + ms["dense"][2 * r + 1])
              for r in range(J_ROUNDS)]
    with use_mesh(mesh):
        idle = lm_step_idle("J granite a2a", cfg_a, opt_cfg, params, opt,
                            batches[0]["tokens"][:1], J_MICRO,
                            float(np.median(ms["a2a"])))
    del opt
    torch.cuda.empty_cache()
    lm = cfg_d.n_layers * J_MICRO
    n = 2 * J_ROUNDS          # timed a2a steps
    want = {"dispatch": n * 6 * lm, "return": n * 2 * lm,
            "dispatch_grad": n * lm, "return_grad": n * lm}
    tokens = batches[0]["tokens"]
    drops_d = moe_drop_stats(cfg_d, params, tokens)
    reset_collective_counts()
    with use_mesh(mesh):
        drops_a = moe_drop_stats(cfg_a, params, tokens)
    fwd_trips = trip_calls()
    caps = a2a_capacities(cfg_a, I1_SEQ)
    cost = trip_cost(mesh, caps["cap_loc"], cfg_a.d_model, dev)
    check(all(np.isfinite([x for _, x in losses])), f"J: losses {losses}")
    log(f"[{CARD}] J granite ({cfg_d.n_layers} layers, {cfg_d.n_params():,} "
        f"params) train step at {J_MICRO} x 1 x {I1_SEQ}, (data, model) "
        f"mesh (1, 1): a2a {', '.join(f'{t:.1f}' for t in ms['a2a'])} ms "
        f"(median {np.median(ms['a2a']):.1f}) beside dense "
        f"{', '.join(f'{t:.1f}' for t in ms['dense'])} ms (median "
        f"{np.median(ms['dense']):.1f}) on the same batch (CUDA events, "
        f"{J_ROUNDS} rounds of dense a2a a2a dense); peak "
        f"a2a {peak['a2a']:,} bytes, dense {peak['dense']:,}; losses "
        f"{', '.join(f'{k} {x:.5f}' for k, x in losses)}")
    log(f"[{CARD}] J granite a2a / dense step time per round: "
        f"{', '.join(f'{x:.4f}' for x in ratios)} (median "
        f"{np.median(ratios):.4f}, range {min(ratios):.4f} to "
        f"{max(ratios):.4f}); dense steps {min(ms['dense']):.1f} to "
        f"{max(ms['dense']):.1f} ms")
    log(f"[{CARD}] J granite capacities at T = {I1_SEQ}: cap_loc "
        f"{caps['cap_loc']:,}, cap2 {caps['cap2']:,} per expert (dense "
        f"{caps['dense_cap']:,}); per layer send_x {caps['send_x_bytes']:,} "
        f"bytes, buf {caps['buf_bytes']:,}; dropped assignments per step "
        f"(forward over the {J_MICRO} microbatches, of "
        f"{J_MICRO * I1_SEQ * cfg_d.moe.top_k * cfg_d.n_layers:,}): a2a "
        f"stage 1 {drops_a['dropped_stage1']:,}, stage 2 "
        f"{drops_a['dropped_stage2']:,}; dense {drops_d['dropped']:,}")
    log(f"[{CARD}] J-d trips of the {n} a2a steps {trips} (want {want}, "
        f"the dense steps none); the forward over {J_MICRO} microbatches "
        f"{fwd_trips} (want dispatch {3 * lm}, return {lm})")
    check(all(trips.get(k) == v for k, v in want.items())
          and fwd_trips.get("dispatch") == 3 * lm
          and fwd_trips.get("return") == lm,
          f"J-d: not every MoE layer ran the a2a path: {trips}, forward "
          f"{fwd_trips}")
    return {"ms": ms, "ratios": ratios, "peak": peak, "losses": losses,
            "trips": trips, "idle": idle["idle"], "forward_trips": fwd_trips,
            "trip_cost": cost, "dropped": {"a2a": drops_a, "dense": drops_d},
            "capacities": caps}


def phase_slice_j_qwen(mesh, dev) -> dict:
    """qwen3-moe-235b-a22b's train_4k_a2a cell, resolved through
    `registry.get` and `cell_config` (impl "a2a", train_4k's sequence),
    at full width cut to J_QWEN_LAYERS layers, random weights from
    generator seed 0: the loss of 1 x 4,096 in bf16 through the a2a path
    (CUDA events, peak), its dropped assignments and trips, then the loss
    and gradient norm (peak); gate J-a at 1 x J_QWEN_GATE_SEQ."""
    import dataclasses
    import torch
    from repro_torch.configs import registry
    from repro_torch.configs.lm_common import LM_SHAPES
    from repro_torch.core.distributed import reset_collective_counts
    from repro_torch.distributed import use_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.train.data import TokenPipelineConfig, token_batch
    from functools import partial
    cfg, shape = registry.get("qwen3-moe-235b-a22b").cell_config(
        "train_4k_a2a")
    cfg = dataclasses.replace(cfg, n_layers=J_QWEN_LAYERS)
    check(cfg.moe.impl == "a2a" and shape == "train_4k",
          f"qwen3 train_4k_a2a resolves to {cfg.moe}, {shape}")
    seq = LM_SHAPES[shape]["seq"]
    t0 = time.perf_counter()
    params = tf.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    batch = token_batch(TokenPipelineConfig(cfg.vocab, seq, 1), 0, dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    caps = a2a_capacities(cfg, seq)
    torch.cuda.reset_peak_memory_stats()
    reset_collective_counts()
    stats = {}
    with use_mesh(mesh), torch.no_grad():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        loss = tf.loss_fn(params, batch, cfg)
        ev[1].record()
        torch.cuda.synchronize()
        tf._trunk(tf.cast_params(params, cfg.cdtype),
                  batch["tokens"][:, :-1], cfg, stats=stats)
    loss_ms = ev[0].elapsed_time(ev[1])
    loss_peak = torch.cuda.max_memory_allocated()
    trips = trip_calls()
    loss = float(loss)
    check(np.isfinite(loss), f"qwen3 a2a loss {loss}")
    check(trips.get("dispatch") == 2 * 3 * cfg.n_layers
          and trips.get("return") == 2 * cfg.n_layers,
          f"qwen3: not every MoE layer ran the a2a path: {trips}")
    out = {"loss": loss, "loss_ms": loss_ms, "loss_peak": loss_peak,
           "setup_s": setup_s, "capacities": caps, "trips": trips,
           "dropped": {k: int(v) for k, v in stats.items()},
           "params": cfg.n_params()}
    log(f"[{CARD}] J qwen3-moe-235b-a22b train_4k_a2a ({cfg.n_layers} of 94 "
        f"layers, {cfg.n_params():,} params, set-up {setup_s:.1f} s): loss "
        f"of 1 x {seq} in {cfg.compute_dtype} through a2a {loss:.6f} in "
        f"{loss_ms:.1f} ms (CUDA events), peak {loss_peak:,} bytes; cap_loc "
        f"{caps['cap_loc']:,}, cap2 {caps['cap2']:,} (dense "
        f"{caps['dense_cap']:,}); dropped stage 1 "
        f"{out['dropped']['dropped_stage1']:,}, stage 2 "
        f"{out['dropped']['dropped_stage2']:,} of "
        f"{seq * cfg.moe.top_k * cfg.n_layers:,}; trips {trips}")
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    with use_mesh(mesh):
        lg, gn = loss_and_grad_norm(partial(tf.loss_fn, cfg=cfg), params,
                                    batch)
    torch.cuda.synchronize()
    out.update(grad_s=time.perf_counter() - t1, grad_norm=gn,
               grad_peak=torch.cuda.max_memory_allocated())
    check(np.isfinite(lg) and np.isfinite(gn),
          f"qwen3 a2a loss {lg}, grad norm {gn}")
    log(f"[{CARD}] J qwen3 loss and gradient through a2a: loss {lg:.6f}, "
        f"grad norm {gn:.6g}, {out['grad_s']:.2f} s (host clock), peak "
        f"{out['grad_peak']:,} bytes")
    # at random init the tokens route alike (attention averages the
    # prefix), so at capacity factor 8 one of 128 experts takes more than
    # its 256 dense slots of 512 tokens; at E / k = 16, where nothing can
    # drop, the a2a buffers of 512 tokens would not fit beside the weights
    out["gate"] = gate_a2a_dense("qwen3", cfg, params, mesh, dev,
                                 seq=J_QWEN_GATE_SEQ)
    del params
    torch.cuda.empty_cache()
    return out


def phase_slice_j(granite) -> dict:
    """Slice J, the expert-parallel all-to-all MoE on the card at NCCL
    world size 1 on a (1, 1) ("data", "model") mesh (ep = 1; no kernel of
    its own: the reference's packing and trips are XLA ops), bf16
    compute, TF32 off, cuBLAS bf16 reductions in f32: granite at full
    width and depth on I2's weights (`j_steps` with J-d and the cost of
    one trip; J-b: gate I-a on the a2a config at its own capacity factor
    1.25 under the mesh; J-c; J-a), then qwen3's train_4k_a2a cell
    (`phase_slice_j_qwen`)."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch.core.distributed import init_mesh
    from repro_torch.distributed import axis_size, use_mesh
    cfg_d, params = granite
    del granite
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    mesh = init_mesh((1, 1), ("data", "model"), dev)
    backend = str(dist.get_backend(mesh.get_group("model")))
    check(axis_size(mesh, "data") == axis_size(mesh, "model") == 1
          and "nccl" in backend, f"J: mesh {mesh} on {backend}")
    cfg_a = with_moe(cfg_d, impl="a2a")
    prev = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    try:
        steps = j_steps(cfg_d, cfg_a, params, mesh, dev)
        torch.cuda.empty_cache()
        with use_mesh(mesh):
            gate_b = lm_f64_gate("granite a2a (capacity factor "
                                 f"{cfg_a.moe.capacity_factor:g})", cfg_a,
                                 params, dev, gate="J-b")
            stats = moe_drop_stats(
                dataclasses.replace(cfg_a, compute_dtype="float32"), params,
                gate_batch(cfg_a, dev))
        log(f"[{CARD}] J-b granite a2a at 1 x {I_GATE_SEQ}: dropped "
            f"assignments stage 1 {stats['dropped_stage1']:,}, stage 2 "
            f"{stats['dropped_stage2']:,} of "
            f"{I_GATE_SEQ * cfg_a.moe.top_k * cfg_a.n_layers:,} (f32 "
            f"forward of the gate's sequence)")
        gate_b["dropped"] = stats
        torch.cuda.empty_cache()
        bitwise = gate_a2a_bitwise(cfg_a, params, mesh,
                                   token_batch_row(cfg_d, dev))
        gate_a = gate_a2a_dense("granite", cfg_d, params, mesh, dev)
        del params
        torch.cuda.empty_cache()
        qwen = phase_slice_j_qwen(mesh, dev)
    finally:
        torch.backends.cuda.matmul.\
            allow_bf16_reduced_precision_reduction = prev
    secs = time.perf_counter() - t0
    log(f"[{CARD}] slice J: {secs:.1f} s")
    return {"granite": steps, "bitwise": bitwise,
            "f64": gate_b, "a2a_vs_dense": gate_a, "qwen3": qwen,
            "seconds": secs}


# ---------------------------------------------------------------- slice K --
K_DIR = ROOT / "build" / "chip_smoke_k"     # gitignored scratch of slice K
# K-b: the cells run at full width on the card's (1, 1) mesh
K_CELLS = (("dlrm-rm2", "serve_p99"), ("dlrm-rm2", "serve_bulk"),
           ("dlrm-rm2", "retrieval_cand"), ("dlrm-rm2", "train_batch"),
           ("pna", "molecule"), ("cpaa-pagerank", "pr_mesh_67m"),
           ("h2o-danube-1.8b", "long_500k"))
K_EB_CELLS = ("serve_p99", "serve_bulk", "train_batch")
K_TERM_SLACK = 1.05    # no roofline term may exceed 1.05 x the step
# K-a: cells that cannot fit one card (f32 weights; qwen3's bf16 moments
# do not save it; deepseek-7b's train_4k params + m + v ~83 GB, and its
# f32 gradient)
K_NO_FIT = {"qwen2.5-32b": None, "qwen3-moe-235b-a22b": None,
            "deepseek-7b": ("train_4k",)}


def _must_not_fit(arch: str, shape: str) -> bool:
    return arch in K_NO_FIT and (K_NO_FIT[arch] is None
                                 or shape in K_NO_FIT[arch])


def phase_slice_k_abstract() -> dict:
    """K-a: every registry cell, single-pod and multi-pod, through the
    dry-run's abstract pass under both meshes: each plan not skipped by
    its cell builds on meta tensors; the production mesh's plan states
    `per_device_bytes` (slice M runs them); the card skips only what does not fit,
    naming both byte counts; no error. Prints the fit table; returns the
    card's skip records (single-pod) for K-c."""
    import torch
    from torch.utils import _pytree as pytree
    from repro_torch.configs.registry import all_cells
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    total = dryrun.device_bytes(torch.device("cuda"))
    rows, skips, n_plans = [], [], 0
    for arch, cell in all_cells():
        fit = {}
        for mp in (False, True):
            prod, _ = dryrun.plan_cell(arch, cell.shape, mp, "production")
            card, plan = dryrun.plan_cell(arch, cell.shape, mp, "card")
            if cell.skip_reason:
                check(prod["status"] == card["status"] == "skipped"
                      and card["reason"] == cell.skip_reason,
                      f"K-a {arch} {cell.shape}: {prod} {card}")
                fit[mp] = "cell skip"
                continue
            n_plans += 1
            check(all(x.device.type == "meta" for x in
                      pytree.tree_leaves(plan.abstract_args)
                      if isinstance(x, torch.Tensor)),
                  f"K-a {arch} {cell.shape}: a plan leaf is not on meta")
            check(prod["status"] == "fits" and
                  prod["memory"]["argument_bytes"] ==
                  dryrun.per_device_bytes(plan, mp),
                  f"K-a {arch} {cell.shape}: production {prod}")
            need = card["memory"]["argument_bytes"] + \
                card["memory"]["stated_output_bytes"] + \
                card["memory"]["stated_temp_bytes"]
            if card["status"] == "skipped":
                check(card["reason"].startswith("does not fit one card")
                      and f"{need:,}" in card["reason"]
                      and f"{total:,}" in card["reason"],
                      f"K-a {arch} {cell.shape}: card skip {card}")
                if not mp:
                    skips.append(card)
            else:
                check(card["status"] == "fits" and need <= total,
                      f"K-a {arch} {cell.shape}: card {card}")
            if _must_not_fit(arch, cell.shape):
                check(card["status"] == "skipped",
                      f"K-a {arch} {cell.shape} fits ({need:,} bytes)")
            fit[mp] = (card["status"], need,
                       prod["memory"]["argument_bytes"])
        rows.append((arch, cell.shape, fit))
    secs = time.perf_counter() - t0
    log(f"[{CARD}] K-a: {n_plans} plans on meta tensors in {secs:.1f} s "
        f"(each built twice); the card holds {total:,} bytes")
    log("K-a fit table: arch | shape | card 1-pod (args + stated outputs "
        "and buffers, GB) | card 2-pod | production per-device args GB "
        "(1-pod / 2-pod)")
    for arch, shape, fit in rows:
        if fit[False] == "cell skip":
            log(f"  {arch} | {shape} | cell skip | cell skip | -")
            continue
        (s1, n1, p1), (s2, n2, p2) = fit[False], fit[True]
        log(f"  {arch} | {shape} | {s1} {n1 / 1e9:.3f} | {s2} "
            f"{n2 / 1e9:.3f} | {p1 / 1e9:.4f} / {p2 / 1e9:.4f}")
    n_fit = sum(1 for _, _, f in rows if f[False] != "cell skip"
                and f[False][0] == "fits")
    log(f"K-a: {n_fit} of {n_plans // 2} single-pod plans fit one card")
    return {"skips": skips, "plans": n_plans, "fits": n_fit,
            "seconds": secs}


def phase_slice_k_runs() -> dict:
    """K-b: K_CELLS through `launch/dryrun.run_cell(..., mesh="card")`:
    each ok, FLOPs and bytes > 0, embedding_bag launched on the DLRM
    kernel cells and its backward on train_batch, no roofline term over
    K_TERM_SLACK x the measured step. Returns the records and the
    kernels' launches over the phase."""
    import torch
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    reset_counts()
    recs = []
    for arch, shape in K_CELLS:
        rec = dryrun.run_cell(arch, shape, False, "card", verbose=False)
        torch.cuda.empty_cache()
        check(rec["status"] == "ok", f"K-b {arch} {shape}: {rec}")
        rf, ms = rec["roofline"], rec["step_ms"]
        step_s = ms["median"] * 1e-3
        bound = max(rf["compute_s"], rf["memory_s"], rf["collective_s"])
        mem = rec["memory"]
        log(f"[{CARD}] K-b {arch} {shape}: step {ms['median']:.3f} ms "
            f"(min {ms['min']:.3f}, max {ms['max']:.3f}; CUDA events, "
            f"{len(ms['all'])} steps); terms compute "
            f"{rf['compute_s'] * 1e3:.3f} / memory "
            f"{rf['memory_s'] * 1e3:.3f} / collective "
            f"{rf['collective_s'] * 1e3:.3f} ms, dominant {rf['dominant']},"
            f" bound / step {bound / step_s:.3f}; counted "
            f"{rec['cost']['flops']:.6g} FLOPs, "
            f"{rec['cost']['bytes_accessed']:.6g} bytes, model flops "
            f"{rf['model_flops']:.6g} (useful {rf['useful_flops_ratio']:.3f});"
            f" args {mem['argument_bytes']:,} B, peak "
            f"{mem['peak_per_device']} B, launches "
            f"{ {k: v for k, v in rec['launches'].items() if v} }, "
            f"collectives {rf['coll_bytes']:.6g} B, args made in "
            f"{rec['args_s']} s")
        check(rec["cost"]["flops"] > 0 and rec["cost"]["bytes_accessed"] > 0,
              f"K-b {arch} {shape}: nothing counted {rec['cost']}")
        if shape in K_EB_CELLS:
            check(rec["launches"]["embedding_bag"] > 0,
                  f"K-b {shape}: embedding_bag not launched")
        if shape == "train_batch":
            check(rec["launches"]["embedding_bag_backward"] > 0,
                  f"K-b {shape}: the backward kernel not launched")
        for term in ("compute_s", "memory_s", "collective_s"):
            check(rf[term] <= K_TERM_SLACK * step_s,
                  f"K-b {arch} {shape}: {term} {rf[term]:.6g} s over "
                  f"{K_TERM_SLACK} x the step {step_s:.6g} s: the count is "
                  f"wrong")
        recs.append(rec)
    launches = read_counts()
    check(launches["bsr_spmm"] == launches["cheb_step"] == 0,
          f"slice K launched a kernel off its path: {launches}")
    secs = time.perf_counter() - t0
    log(f"[{CARD}] K-b: {len(recs)} cells in {secs:.1f} s; launches "
        f"{launches}")
    return {"records": recs, "launches": launches, "seconds": secs}


def phase_slice_k_report(recs: list, skips: list) -> str:
    """K-c: launch/roofline.py renders K-b's records and K-a's card skips
    (one jsonl) with one roofline row per K-b cell."""
    from repro_torch.launch import roofline
    K_DIR.mkdir(parents=True, exist_ok=True)
    src, out = K_DIR / "dryrun.jsonl", K_DIR / "roofline.md"
    src.write_text("".join(json.dumps(r) + "\n" for r in recs + skips))
    roofline.main(["--in", str(src), "--out", str(out)])
    text = out.read_text()
    body = text.split("## Roofline")[1]
    rows = [ln for ln in body.splitlines() if ln.startswith("| ")
            and not ln.startswith("| arch")]
    check(len(rows) == len(recs),
          f"K-c: {len(rows)} roofline rows for {len(recs)} cells")
    for arch, shape in K_CELLS:
        check(any(ln.startswith(f"| {arch} | {shape} |") for ln in rows),
              f"K-c: no roofline row for {arch} {shape}")
    log(f"K-c: roofline report ({len(rows)} rows):\n{text.rstrip()}")
    return text


def phase_slice_k() -> dict:
    """Slice K, the dry-run tooling on the card: K-a, K-b, K-c (K-d runs
    in slice I3)."""
    t0 = time.perf_counter()
    a = phase_slice_k_abstract()
    b = phase_slice_k_runs()
    phase_slice_k_report(b["records"], a["skips"])
    secs = time.perf_counter() - t0
    log(f"[{CARD}] slice K: {secs:.1f} s")
    return {"abstract": a, "runs": b, "launches": b["launches"],
            "seconds": secs}


# ---------------------------------------------------------------- slice M --
# M-a: the production dry-run of these cells on both production meshes
M_ARCHS = ("dlrm-rm2", "h2o-danube-1.8b", "granite-moe-3b-a800m",
           "meshgraphnet", "pna", "dimenet", "graphcast", "cpaa-pagerank")
# M-b: rank 0 of these (arch, shape) cells of the (16, 16) mesh on the card
M_PLAN_RANKS = (("meshgraphnet", "ogb_products"),
                ("cpaa-pagerank", "pr_mesh_67m_2d"))
M_EB_BATCH = 65_536    # M-b: DLRM-RM2 train_batch (4,096 rows per rank)
M_DANUBE_SHAPE = "train_4k"
M_C_DLRM_BATCH = 8_192
SPIN_CYCLES = 50_000_000   # M-b: ~25 ms of spin ahead of timed calls
M_C_LAYERS = 2         # M-c: danube at full width, cut from 24 layers
M_C_SEQ = 512
M_C_TOL = 1e-6         # M-c: sharded step's loss vs unsharded, relative


def phase_slice_m_dryrun() -> dict:
    """M-a: every cell of M_ARCHS through `launch/dryrun.run_cell(...,
    mesh="production")` on the (16, 16) and (2, 16, 16)
    meshes of a fake world in this process: each ok (long_500k of a
    full-attention arch keeps its own skip) with argument bytes equal to
    `per_device_bytes` of the same plan, and a GNN or cpaa record's
    collective bytes > 0. Prints per cell the per-device argument, peak
    temp and total bytes, the fit on this card, the compute / memory /
    collective terms and the collective bytes by axis."""
    import torch
    from repro_torch.configs.registry import get
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    total = dryrun.device_bytes(torch.device("cuda"))
    recs = []
    for mp in (False, True):
        for arch in M_ARCHS:
            for cell in get(arch).cells():
                rec = dryrun.run_cell(arch, cell.shape, mp, "production",
                                      verbose=False)
                if cell.skip_reason:
                    check(rec["status"] == "skipped" and
                          rec["reason"] == cell.skip_reason,
                          f"M-a {arch} {cell.shape}: {rec}")
                    continue
                check(rec["status"] == "ok", f"M-a {arch} {cell.shape} "
                      f"multi_pod={mp}: {rec}")
                plan = get(arch).build(cell.shape, mp)
                mem, rf = rec["memory"], rec["roofline"]
                want = dryrun.per_device_bytes(plan, mp)
                check(mem["argument_bytes"] == want,
                      f"M-a {arch} {cell.shape}: argument bytes "
                      f"{mem['argument_bytes']:,} != per_device_bytes "
                      f"{want:,}")
                if get(arch).FAMILY in ("gnn", "pagerank"):
                    moved = sum(v for k, v in rec["collectives"].items()
                                if not k.startswith("n_"))
                    check(moved > 0, f"M-a {arch} {cell.shape}: no "
                          f"collective bytes")
                fits = mem["peak_per_device"] <= total
                axes = {a: {k: f"{v:.4g}" for k, v in per.items()}
                        for a, per in rec["collectives_by_axis"].items()}
                how = rec["cost_from"] if isinstance(rec["cost_from"], str) \
                    else "probes L={L} M={M}".format(
                        **rec["cost_from"]["probes"])
                log(f"M-a {arch} {cell.shape} on {rec['chips']} ranks: "
                    f"per device args {mem['argument_bytes']:,} B, peak "
                    f"temp {mem['temp_bytes']:,} B, total "
                    f"{mem['peak_per_device']:,} B "
                    f"({'fits' if fits else 'does not fit'} the card's "
                    f"{total:,}"
                    f"{'; peak estimated' if mem['peak_estimated'] else ''}"
                    f"); terms compute {rf['compute_s'] * 1e3:.3f}"
                    f" / memory {rf['memory_s'] * 1e3:.3f} / collective "
                    f"{rf['collective_s'] * 1e3:.3f} ms (H100 rates), "
                    f"dominant {rf['dominant']}; collective bytes by axis "
                    f"{axes}; counts from {how} in {rec['count_s']} s")
                recs.append(rec)
    secs = time.perf_counter() - t0
    log(f"M-a: {len(recs)} production records in {secs:.1f} s (one "
        f"process, a fake world of 256 / 512 ranks, meta tensors)")
    return {"records": recs, "seconds": secs}


def _window_bound(cost_fn) -> tuple[float, str]:
    flops, nbytes = cost_fn()
    from repro_torch.launch.mesh import PEAK_FLOPS_F32
    return bound(nbytes / HBM_BYTES_PER_S * 1e3,
                 flops / PEAK_FLOPS_F32 * 1e3)


def m_window_check(ids, table, lo: int, label: str) -> dict:
    """The window kernels at one rank's window of the real table, against
    their plain versions on the same inputs (not counted on the path):
    the lookup bitwise (bags of one row), an id outside the window giving
    exactly 0; the backward's index preparation (compaction and radix
    sort) bitwise; the backward within EB_BWD_TOL of the sum of |terms| of
    a float64 plain window version, every window row no inside id reads
    exactly 0, bitwise from launch to launch. Times all three and their
    plain versions, the backward split into its compaction (the histogram
    and the first digit pass), its other digit passes and its two passes
    over the entries inside, beside torch.sort of all the ids and the
    library's index_add_ into a spare row."""
    import torch
    from repro_torch.kernels.embedding_bag import ops as eb_ops
    from repro_torch.kernels.embedding_bag.ref import (
        embedding_bag_backward_window_ref, embedding_bag_window_ref,
        window_sort_ref)
    n_local, dim = table.shape
    inside = (ids >= lo) & (ids < lo + n_local)
    keys, vals, count = eb_ops.window_sort(ids, lo, n_local)
    p_keys, p_vals, p_count = window_sort_ref(ids, lo, n_local)
    n_in = int(p_count)
    prep_exact = bool(int(count) == n_in
                      and torch.equal(keys[:n_in], p_keys)
                      and torch.equal(vals[:n_in], p_vals))
    got = eb_ops.embedding_bag_window(ids, table, lo)
    want = embedding_bag_window_ref(ids, table, lo)
    exact = bool(torch.equal(got, want))
    zero_out = not bool(got[~inside[:, 0]].any())
    g = torch.randn((ids.shape[0], dim), device=ids.device,
                    generator=torch.Generator(device=ids.device)
                    .manual_seed(7))
    gb = eb_ops.embedding_bag_backward_window(ids, g, lo, n_local)
    again = eb_ops.embedding_bag_backward_window(ids, g, lo, n_local)
    w64 = embedding_bag_backward_window_ref(ids, g.double(), lo, n_local)
    mag = embedding_bag_backward_window_ref(ids, g.double().abs(), lo,
                                            n_local)
    share = float(((gb.double() - w64).abs()
                   / mag.clamp(min=1e-300)).max())
    err_b = float((gb.double() - w64).abs().max())
    read = torch.zeros(n_local, dtype=torch.bool, device=ids.device)
    read[(ids[inside] - lo).long()] = True
    zero_rows = not bool(gb[~read].any())
    bitwise = bool(torch.equal(gb, again))
    del w64, mag, again
    # the kernels' device time (at a rank's 106,496 ids a call's host time
    # hides them, `_device_ms`): the lookup's kernel; the backward's index
    # preparation and its two passes into a gradient already zero (the
    # wrapper's zero fill of the shard's n_local x D floats is left out),
    # each part alone beside. The plain versions and the whole calls
    # between CUDA events.
    ms = _device_ms(lambda: eb_ops._launch(ids, table, None, lo))
    ms_b = _device_ms(lambda: eb_ops._launch_backward(ids, g, gb, None, lo))
    sort_b = _device_ms(lambda: torch.sort(ids.reshape(-1), stable=True))
    flat = ids.reshape(-1)
    prep_ms = _device_ms(lambda: eb_ops._launch_window_sort(flat, lo,
                                                            n_local))
    compact_ms = _device_ms(lambda: eb_ops._launch_window_sort(
        flat, lo, n_local, passes=1))
    passes_ms = _device_ms(lambda: eb_ops._launch_window_passes(
        keys, vals, count, ids, g, gb, None))
    prep_plain = time_ms(lambda: window_sort_ref(ids, lo, n_local), 5)
    # the library: one index_add_ into [n_local + 1, D], the ids outside
    # mapped to the spare last row (the mapping not timed)
    spare = torch.zeros((n_local + 1, dim), device=ids.device)
    local = flat.long() - lo
    local = torch.where((local >= 0) & (local < n_local), local, n_local)
    lib_b = _device_ms(lambda: spare.index_add_(0, local, g))
    del spare, local
    plain_ms = time_ms(lambda: embedding_bag_window_ref(ids, table, lo), 5)
    plain_b = time_ms(lambda: embedding_bag_backward_window_ref(
        ids, g, lo, n_local), 5)
    call_ms = time_ms(lambda: eb_ops._launch(ids, table, None, lo), 20)
    call_b = time_ms(lambda: eb_ops._launch_backward(ids, g, gb, None, lo),
                     20)
    fwd_b, fwd_by = _window_bound(
        lambda: eb_ops._lookup_cost(ids, got, lo, n_local))
    bwd_b, bwd_by = _window_bound(
        lambda: eb_ops._backward_cost(ids, dim, lo, n_local))
    # the preparation: each id read once, each key and value written once
    prep_b, prep_by = bound(4 * (flat.numel() + 2 * n_in) / HBM_BYTES_PER_S
                            * 1e3, 0.0)
    log(f"[{CARD}] M-b {label} window [{lo:,}, {lo + n_local:,}) of "
        f"{ids.numel():,} ids ({n_in:,} inside): lookup bitwise vs plain "
        f"{exact}, outside ids give 0 {zero_out}, device {ms:.4f} ms "
        f"(plain {plain_ms:.4f}, bound {fwd_b:.4f} by {fwd_by}; the whole "
        f"call {call_ms:.4f} ms between CUDA events); "
        f"backward {share:.3e} of sum |terms| vs float64 (limit "
        f"{EB_BWD_TOL:g}), max |err| {err_b:.3e}, unread rows 0 "
        f"{zero_rows}, bitwise again {bitwise}, device {ms_b:.4f} ms "
        f"(torch.sort alone {sort_b:.4f}; plain {plain_b:.4f}, bound "
        f"{bwd_b:.4f} by {bwd_by}; the whole call {call_b:.4f} ms between "
        f"CUDA events)")
    log(f"[{CARD}] M-b {label} window backward split (device ms, queued "
        f"behind a spin kernel): preparation {prep_ms:.4f} ("
        f"{eb_ops.sort_passes(n_local)}"
        f" digit passes; compaction, the histogram and the first pass, "
        f"{compact_ms:.4f}; the other passes {prep_ms - compact_ms:.4f}), "
        f"the two passes over the {n_in:,} entries inside {passes_ms:.4f}; "
        f"beside torch.sort of all {flat.numel():,} ids alone {sort_b:.4f}"
        f"; library index_add_ into [{n_local + 1:,}, {dim}] {lib_b:.4f}; "
        f"preparation bitwise vs plain {prep_exact} (plain {prep_plain:.4f}"
        f" ms, bound {prep_b:.4f} by {prep_by})")
    check(exact and zero_out, f"M-b {label}: window lookup vs plain")
    check(prep_exact, f"M-b {label}: window preparation vs plain")
    check(share <= EB_BWD_TOL and zero_rows and bitwise,
          f"M-b {label}: window backward {share:.3e}, rows {zero_rows}, "
          f"bitwise {bitwise}")
    return {"fwd": {"ms": ms, "plain_ms": plain_ms, "bound_ms": fwd_b,
                    "bound_by": fwd_by, "call_ms": call_ms,
                    "err": 0.0 if exact else float(
                        (got - want).abs().max())},
            "bwd": {"ms": ms_b, "plain_ms": plain_b, "bound_ms": bwd_b,
                    "bound_by": bwd_by, "call_ms": call_b,
                    "library_ms": lib_b, "torch_sort_ms": sort_b,
                    "split_ms": {"compaction": compact_ms,
                                 "sort": prep_ms - compact_ms,
                                 "passes": passes_ms}, "err": err_b},
            "prep": {"ms": prep_ms, "plain_ms": prep_plain,
                     "bound_ms": prep_b, "bound_by": prep_by, "err": 0.0}}


def _device_ms(fn, calls: int = 20) -> float:
    """Device ms per call of `fn`: `calls` calls queued behind a spin
    kernel (`torch.cuda._sleep`), so they run back to back on the card
    however slow the host is, timed between CUDA events. Fails unless the
    host queued them all before the spin ended."""
    import torch
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda._sleep(SPIN_CYCLES)
    ev[1].record()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    ev[2].record()
    torch.cuda.synchronize()
    spin_ms = ev[0].elapsed_time(ev[1])
    check(host_ms < spin_ms, f"M-b: queuing {calls} calls took {host_ms:.2f}"
          f" ms, longer than the {spin_ms:.2f} ms spin")
    return ev[1].elapsed_time(ev[2]) / calls


def _step_ms(step, *args) -> tuple[float, object]:
    import torch
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = step(*args)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop), out


def phase_slice_m_ranks() -> dict:
    """M-b: rank 0 and rank 255 of the (16, 16) production mesh on the
    card, on a fake world in this process (real local shards, collectives
    that move nothing): DLRM-RM2 train_batch, whose row shard of the table
    runs through both window kernels (their launches counted over one
    step and checked at the rank's window, `m_window_check`), and
    danube's train_4k on rank 0. The step's ms are one rank's device work
    with no collective time."""
    import torch
    from functools import partial
    from torch.utils import _pytree as pytree
    from repro_torch.configs import dlrm_rm2, h2o_danube_1_8b
    from repro_torch.core import distributed as cdist
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.models.recsys import dlrm
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.train_loop import make_train_step
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    cfg = dlrm_rm2.full_config()
    params = dlrm.init_params(cfg, seed=0, device=dev)
    batch = dlrm_rm2.make_batch(cfg, M_EB_BATCH, seed=1, device=dev)
    specs = sh.dlrm_param_specs(params, False)
    opt_cfg = AdamWConfig(lr=1e-3)
    launches, windows = {"embedding_bag_window": 0,
                         "embedding_bag_window_backward": 0,
                         "embedding_bag_window_sort": 0}, {}
    for rank in (0, 255):
        mesh = make_production_mesh(device=dev, fake=True, rank=rank)
        try:
            with sh.use_mesh(mesh, sharded=True):
                local = sh.shard_tree(params, specs, mesh)
                lo_b, hi_b, _ = sh.split(M_EB_BATCH, 16,
                                         sh.axis_index(mesh, "data"))
                mine = {k: v[lo_b:hi_b] for k, v in batch.items()}
                opt = adamw_init(local, opt_cfg)
                step = make_train_step(partial(dlrm.loss_fn, cfg=cfg),
                                       opt_cfg, donate=True,
                                       grad_specs=specs)
                step(local, opt, mine)                       # warm-up
                torch.cuda.synchronize()
                reset_counts()
                ms, (_, _, metrics) = _step_ms(step, local, opt, mine)
                n = read_counts()
                gate_adamw("slice_m", f"M-b DLRM rank {rank}", n,
                           len(pytree.tree_leaves(local)), 1)
                for k in launches:
                    launches[k] += n[k]
                check(n["embedding_bag_window"] >= 1 and
                      n["embedding_bag_window_backward"] >= 1 and
                      n["embedding_bag_window_sort"] >= 1 and
                      n["embedding_bag"] == n["embedding_bag_backward"] == 0,
                      f"M-b DLRM rank {rank}: launches {n}")
                loss = float(metrics["loss"])
                m = sh.axis_index(mesh, "model")
                lo = sh.split(cfg.padded_rows, 16, m)[0]
                log(f"[{CARD}] M-b DLRM-RM2 train_batch rank {rank} (data "
                    f"{sh.axis_index(mesh, 'data')}, model {m}): one step "
                    f"{ms:.3f} ms (CUDA events; one rank's device work, no "
                    f"collective time: the fake world moves nothing), "
                    f"{hi_b - lo_b:,} rows, table rows [{lo:,}, "
                    f"{lo + local['table'].shape[0]:,}), local loss "
                    f"{loss:.6f}; launches {n['embedding_bag_window']} "
                    f"window lookup, {n['embedding_bag_window_backward']} "
                    f"window backward, {n['embedding_bag_window_sort']} "
                    f"window sort")
                check(np.isfinite(loss), f"M-b DLRM rank {rank}: loss")
                ids = mine["sparse_ids"].reshape(-1, cfg.bag_size)
                windows[rank] = m_window_check(ids, local["table"], lo,
                                               f"rank {rank}")
                del local, opt, step
        finally:
            cdist.destroy_world()
        torch.cuda.empty_cache()
    del params, batch
    torch.cuda.empty_cache()

    dcfg = h2o_danube_1_8b.full_config()
    from repro_torch.configs.lm_common import LM_SHAPES
    info = LM_SHAPES[M_DANUBE_SHAPE]
    mesh = make_production_mesh(device=dev, fake=True, rank=0)
    try:
        with sh.use_mesh(mesh, sharded=True):
            pspecs = sh.lm_param_specs(dcfg, False)
            whole = tf.init_params(torch.Generator(device=dev).manual_seed(0),
                                   dcfg)
            local = sh.shard_tree(whole, pspecs, mesh)
            del whole
            rows = info["global_batch"] // 16
            tokens = torch.randint(0, dcfg.vocab, (rows, info["seq"] + 1),
                                   generator=torch.Generator(device=dev)
                                   .manual_seed(1), device=dev,
                                   dtype=torch.int32)
            d_opt = AdamWConfig(lr=I_LR)
            step = make_train_step(partial(tf.loss_fn, cfg=dcfg), d_opt,
                                   num_microbatches=info["global_batch"]
                                   // 32, donate=True, grad_specs=pspecs)
            opt = adamw_init(local, d_opt)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)   # the step's own peak
            reset_counts()
            ms, (_, _, metrics) = _step_ms(step, local, opt,
                                           {"tokens": tokens})
            gate_adamw("slice_m", f"M-b danube {M_DANUBE_SHAPE} rank 0",
                       read_counts(), len(pytree.tree_leaves(local)), 1)
            loss = float(metrics["loss"])
            args = sum(x.numel() * x.element_size()
                       for x in pytree.tree_leaves((local, opt)))
            log(f"[{CARD}] M-b danube {M_DANUBE_SHAPE} rank 0: one step "
                f"(the first, no warm-up) {ms:.1f} ms (CUDA events; one "
                f"rank's device work, no collective time) on {rows} x "
                f"{info['seq'] + 1} tokens in {info['global_batch'] // 32} "
                f"microbatches, local params + moments {args:,} B, peak "
                f"allocated over the step (arguments included) "
                f"{torch.cuda.max_memory_allocated(dev):,} B, "
                f"loss {loss:.4f}")
            check(np.isfinite(loss), "M-b danube: loss not finite")
            del local, opt, step
    finally:
        cdist.destroy_world()
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    log(f"[{CARD}] M-b: {secs:.1f} s; window launches {launches}")
    return {"launches": launches, "windows": windows, "seconds": secs}


def phase_slice_m_plan_ranks() -> dict:
    """M-b's GNN and cpaa ranks: rank 0 of each M_PLAN_RANKS cell of the
    (16, 16) production mesh on the card, on a fake world in this process:
    the pieces of its plan's `make_args` under the plan's specs (copied,
    the whole arguments freed), one warm-up step and one step timed with
    CUDA events, and the step's own peak memory: the most allocated over
    it less what was allocated just before (the arguments among it, and
    whatever earlier slices still hold), beside the arguments' bytes.
    The ms are one rank's device work with no collective time: the fake
    world moves nothing. The loss (GNN) or pi (cpaa) must be finite."""
    import torch
    from torch.utils import _pytree as pytree
    from repro_torch.configs.registry import get
    from repro_torch.core import distributed as cdist
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import make_production_mesh
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    out = {}
    for arch, shape in M_PLAN_RANKS:
        plan = get(arch).build(shape, False)
        mesh = make_production_mesh(device=dev, fake=True, rank=0)
        try:
            with sh.use_mesh(mesh, sharded=True):
                t1 = time.perf_counter()
                whole = plan.static["make_args"](seed=0, device=dev)
                args = pytree.tree_map(
                    lambda x: x.clone() if isinstance(x, torch.Tensor)
                    else x, sh.shard_tree(tuple(whole),
                                          tuple(plan.in_specs), mesh))
                del whole
                torch.cuda.synchronize()
                args_s = time.perf_counter() - t1
                torch.cuda.empty_cache()
                arg_bytes = sum(x.numel() * x.element_size()
                                for x in pytree.tree_leaves(args)
                                if isinstance(x, torch.Tensor))
                step = plan.step or plan.static["step_builder"](mesh)
                step(*args)                                   # warm-up
                torch.cuda.synchronize()
                before = torch.cuda.memory_allocated(dev)
                torch.cuda.reset_peak_memory_stats(dev)
                reset_counts()
                ms, res = _step_ms(step, *args)
                peak = torch.cuda.max_memory_allocated(dev) - before
                if plan.step is not None:        # a GNN train step
                    gate_adamw("slice_m", f"M-b {arch} {shape} rank 0",
                               read_counts(),
                               len(pytree.tree_leaves(args[0])), 1)
                if plan.step is not None:        # a GNN train step
                    batch = args[-1]
                    value = float(res[2]["loss"])
                    what = (f"{batch['node_feat'].shape[0]:,} nodes and "
                            f"{batch['senders'].shape[0]:,} edges, local "
                            f"loss {value:.6f}")
                else:                            # cpaa: pi's local piece
                    value = float(res.sum())
                    check(bool(torch.isfinite(res).all()),
                          f"M-b {arch} {shape}: pi not finite")
                    what = (f"{args[1].shape[-1]:,} edges, vectors of "
                            f"{args[0].shape[0]:,} rows, local pi sum "
                            f"{value:.6f}")
                check(np.isfinite(value), f"M-b {arch} {shape}: {value}")
                log(f"[{CARD}] M-b {arch} {shape} rank 0 of (16, 16): "
                    f"one step after a warm-up {ms:.3f} ms (CUDA events; "
                    f"one rank's device work, no collective time: the fake "
                    f"world moves nothing) on {what}; local arguments "
                    f"{arg_bytes:,} B (made and cut in {args_s:.1f} s), "
                    f"the step's own peak {peak:,} B (the most allocated "
                    f"over it less the {before:,} B allocated before it)")
                out[f"{arch}:{shape}"] = {"ms": ms, "peak": peak,
                                          "arg_bytes": arg_bytes}
                del args, res, step
        finally:
            cdist.destroy_world()
        torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    log(f"[{CARD}] M-b GNN and cpaa ranks: {secs:.1f} s")
    return {"ranks": out, "seconds": secs}


def phase_slice_m_nccl() -> dict:
    """M-c: the sharded path on a real (1, 1) NCCL mesh at world size 1,
    deterministic algorithms on: one DLRM-RM2 step (full table, a batch of
    M_C_DLRM_BATCH), one danube step (full width, M_C_LAYERS layers,
    one sequence of M_C_SEQ) and one PNA molecule step (the plan's batch
    layout and its GNN gradient sum) give the unsharded step's loss
    within M_C_TOL (relative)."""
    import dataclasses
    import torch
    from functools import partial
    from torch.utils import _pytree as pytree
    from repro_torch.configs import dlrm_rm2, h2o_danube_1_8b
    from repro_torch.configs import pna as pna_cfg
    from repro_torch.configs.gnn_common import GNN_SHAPES
    from repro_torch.core import distributed as cdist
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import transformer as tf
    from repro_torch.models.gnn import pna
    from repro_torch.models.recsys import dlrm
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.train_loop import make_train_step
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    mesh = cdist.init_mesh((1, 1), ("data", "model"), dev)
    out = {}

    def both(label, loss_fn, params, specs, batch, opt_cfg,
             sharded_loss=None, batch_specs=None, rule="mean"):
        before = read_counts()
        plain = make_train_step(loss_fn, opt_cfg, donate=False)
        _, _, m0 = plain(params, adamw_init(params, opt_cfg), batch)
        with sh.use_mesh(mesh, sharded=True):
            local = sh.shard_tree(params, specs, mesh)
            mine = sh.shard_tree(batch, batch_specs, mesh)
            sharded = make_train_step(sharded_loss or loss_fn, opt_cfg,
                                      donate=False, grad_specs=specs,
                                      grad_rule=rule)
            _, _, m1 = sharded(local, adamw_init(local, opt_cfg), mine)
        gate_adamw("slice_m", f"M-c {label} (unsharded and sharded step)",
                   adamw_delta(before, read_counts()),
                   len(pytree.tree_leaves(params)), 2)
        l0, l1 = float(m0["loss"]), float(m1["loss"])
        g0, g1 = float(m0["grad_norm"]), float(m1["grad_norm"])
        rel = abs(l1 - l0) / abs(l0)
        log(f"[{CARD}] M-c {label}: sharded loss {l1:.9g} vs unsharded "
            f"{l0:.9g} (rel {rel:.3e}, limit {M_C_TOL:g}); grad norm "
            f"{g1:.9g} vs {g0:.9g}")
        check(rel <= M_C_TOL, f"M-c {label}: loss rel {rel:.3e}")
        out[label] = rel

    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        cfg = dlrm_rm2.full_config()
        params = dlrm.init_params(cfg, seed=0, device=dev)
        batch = dlrm_rm2.make_batch(cfg, M_C_DLRM_BATCH, seed=2, device=dev)
        reset_counts()
        both("DLRM-RM2", partial(dlrm.loss_fn, cfg=cfg), params,
             sh.dlrm_param_specs(params, False), batch,
             AdamWConfig(lr=1e-3))
        n = read_counts()
        check(n["embedding_bag_window"] >= 1 and n["embedding_bag"] >= 1,
              f"M-c DLRM: launches {n}")
        del params, batch
        torch.cuda.empty_cache()
        dcfg = dataclasses.replace(h2o_danube_1_8b.full_config(),
                                   n_layers=M_C_LAYERS,
                                   compute_dtype="float32")
        whole = tf.init_params(torch.Generator(device=dev).manual_seed(0),
                               dcfg)
        tokens = torch.randint(0, dcfg.vocab, (1, M_C_SEQ + 1),
                               generator=torch.Generator(device=dev)
                               .manual_seed(3), device=dev,
                               dtype=torch.int32)
        both("danube", partial(tf.loss_fn, cfg=dcfg), whole,
             sh.lm_param_specs(dcfg, False), {"tokens": tokens},
             AdamWConfig(lr=I_LR))
        del whole
        plan = pna_cfg.build("molecule", False)
        pcfg = pna_cfg.full_config(d_in=GNN_SHAPES["molecule"]["d_feat"])
        params, _, batch = plan.static["make_args"](seed=0, device=dev)
        both("PNA molecule", partial(pna.loss_fn, cfg=pcfg), params,
             plan.in_specs[0], batch, AdamWConfig(lr=1e-3),
             sharded_loss=partial(pna.loss_fn, cfg=pcfg,
                                  layout=plan.static["layout"]),
             batch_specs=plan.in_specs[2], rule="sum")
        del params, batch
    finally:
        torch.use_deterministic_algorithms(was)
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    log(f"[{CARD}] M-c: {secs:.1f} s")
    return {"rel": out, "seconds": secs}


def phase_slice_m() -> dict:
    """Slice M, tensor, FSDP and graph parallelism under the production
    plans: M-a (the production dry-run on a fake world), M-b (ranks of
    the production mesh on the card: DLRM-RM2, danube, MeshGraphNet,
    cpaa), M-c (the sharded path on a real (1, 1) NCCL mesh)."""
    t0 = time.perf_counter()
    a = phase_slice_m_dryrun()
    b = phase_slice_m_ranks()
    b2 = phase_slice_m_plan_ranks()
    c = phase_slice_m_nccl()
    secs = time.perf_counter() - t0
    log(f"[{CARD}] slice M: {secs:.1f} s (M-a {a['seconds']:.1f}, M-b "
        f"{b['seconds']:.1f} + {b2['seconds']:.1f}, M-c "
        f"{c['seconds']:.1f})")
    return {"dryrun": a, "ranks": b, "plan_ranks": b2, "nccl": c,
            "launches": b["launches"], "windows": b["windows"],
            "seconds": secs}


# ---------------------------------------------------------------- slice L --
L_QUERIES = 128        # L-a's warm second drain of slice A's service
# the sync debug mode's warning at a synchronizing operation (setting the
# mode also warns once that it is a prototype: that one is not counted)
SYNC_WARNING = "called a synchronizing CUDA operation"


def sync_warnings(seen) -> list:
    return [w for w in seen if SYNC_WARNING in str(w.message)]


def sync_sites(seen, top: int = 5) -> list:
    """The sync debug mode's warnings by call site (file:line of the
    Python frame that ran the synchronizing operation), most first."""
    from collections import Counter
    sites = Counter(f"{Path(w.filename).name}:{w.lineno}"
                    for w in sync_warnings(seen))
    return sites.most_common(top)


def phase_slice_l_sanitize(svc, cfg, a_drain_s: float,
                           a_queries: int) -> dict:
    """L-a and L-b on slice A's service: a warm second drain of L_QUERIES
    fresh queries under the NaN mode and the sync debug mode, inside
    RetraceGate; then a deliberate `.item()` in the block."""
    import warnings
    import torch
    from repro_torch.analysis import sanitize
    from repro_torch.analysis.retrace import RetraceGate
    queries = seeded_queries(svc, L_QUERIES, seed=1, top_k=8)
    t0 = time.perf_counter()
    with sanitize.applied({"debug_nans": True}):    # first use: imports
        torch.ones(1, device="cuda").add_(1)
    first_s = time.perf_counter() - t0
    ticks0 = svc.stats["ticks"]
    reset_counts()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        with RetraceGate() as gate:
            with sanitize.applied({"debug_nans": True,
                                   "sync_debug_mode": "warn"}) as ctx:
                for q in queries:
                    svc.submit(q)
                results = svc.run_until_drained()
                torch.cuda.synchronize()
                drain_s = time.perf_counter() - t0
                drain_warn = list(seen)
                torch.ones((), device="cuda").item()  # must be reported
                item_warn = [w for w in sync_warnings(seen[len(drain_warn):])
                             if Path(w.filename).name == "chip_smoke.py"]
    counts = read_counts()
    ticks = svc.stats["ticks"] - ticks0
    log(f"L-a: {len(results)} answers in {ticks} ticks under the NaN mode "
        f"({len(ctx.nan_mode.names):,} CUDA op outputs checked on the "
        "device, flags read once at exit: no NaN) and sync debug mode "
        f"\"warn\"; drain {drain_s:.3f} s for {len(queries)} queries (slice "
        f"A's cold drain without the modes: {a_drain_s:.3f} s for "
        f"{a_queries}; the NaN mode's first entry, outside the timing: "
        f"{first_s:.3f} s); launches {counts}")
    syncs = sync_warnings(drain_warn)
    log(f"L-a: synchronizing operations during the drain: {len(syncs)} "
        f"({len(syncs) / max(ticks, 1):.2f} per tick); top call sites "
        f"{sync_sites(drain_warn)}")
    if syncs:
        log(f"L-a: first sync warning: {str(syncs[0].message)[:160]}")
    log(f"L-a: the deliberate .item() was reported {len(item_warn)} time(s)"
        f" at {sync_sites(item_warn)}")
    log(f"L-b: L-a's drain under RetraceGate: {len(gate.events)} compile "
        "events")
    check(len(results) == len(queries), "L-a: not every query answered")
    check(counts["bsr_spmm"] > 0 and counts["cheb_step"] > 0,
          f"L-a: a kernel of the path was not launched: {counts}")
    check(item_warn, "L-a: the sync debug mode did not report .item()")
    err = oracle_check(svc, results, queries, cfg.c, cfg.tol, per_graph=2)
    log(f"L-a: max |service - float64 oracle| {err:.3e} (bound 2 tol = "
        f"{2 * cfg.tol:.0e})")
    return {"launches": counts, "oracle_err": err, "ticks": ticks,
            "syncs": len(syncs), "drain_s": drain_s, "first_s": first_s,
            "nan_ops": len(ctx.nan_mode.names)}


def phase_slice_l_gate() -> None:
    """L-b: a fresh smoke-size danube engine's first tick (its CUDA graph
    capture) inside RetraceGate raises RetraceError naming a NEW
    signature."""
    import torch
    from repro_torch.analysis.retrace import RetraceError, RetraceGate
    from repro_torch.configs import h2o_danube_1_8b
    from repro_torch.models import transformer as tf
    from repro_torch.serve.engine import ServeEngine
    cfg = h2o_danube_1_8b.smoke_config()
    params = tf.init_params(torch.Generator(device="cuda").manual_seed(0),
                            cfg)
    eng = ServeEngine(params, cfg, 3, 64, device="cuda")
    for r in lm_requests(cfg.vocab, 3, seed=0, max_new=4):
        check(eng.submit(r), "L-b: submit failed")
    try:
        with RetraceGate():
            eng.tick()
    except RetraceError as e:
        msg = str(e)
    else:
        msg = ""
    log("L-b: a fresh engine's first tick inside RetraceGate: "
        + (msg.replace("\n", " | ") if msg else "no RetraceError"))
    check("ServeEngine._decode_core" in msg and "NEW signature" in msg,
          "L-b: the gate did not trip on a fresh capture")


def phase_slice_l_lint() -> None:
    """L-c: torchlint over the port, strict, exits 0."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                          "--strict"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    last = (out.stdout.strip().splitlines() or [""])[-1]
    log(f"L-c: python -m repro_torch.analysis --strict: exit "
        f"{out.returncode}; {last}")
    check(out.returncode == 0, f"L-c: torchlint failed:\n{out.stdout}"
          f"{out.stderr}")


def phase_slice_l_examples() -> dict:
    """L-d: the four examples on the card, in this process (their launches
    are counted)."""
    from repro_torch.launch import (distributed_pagerank, quickstart,
                                    serve_lm, serve_pagerank)

    def tagged(tag):
        return lambda msg: log(f"  [{tag}] {msg}")

    t0 = time.perf_counter()
    reset_counts()
    q = quickstart.run("cuda", log=tagged("quickstart"))
    check(q["errors"]["cpaa"] <= 1e-4,
          f"L-d quickstart: CPAA max rel err {q['errors']['cpaa']:.3e}")
    sp = serve_pagerank.run("cuda", log=tagged("serve_pagerank"))
    check(len(sp["results"]) == len(sp["queries"]) == 24,
          "L-d serve_pagerank: not every query answered")
    check(sp["again"] is not None and sp["again"].cached,
          "L-d serve_pagerank: the repeat was not cached")
    check(sp["stats"]["updates"] == 1 and sp["epoch"] == 1
          and sp["cache"]["invalidations"] > 0 and sp["fresh"].epoch == 1
          and not sp["fresh"].cached,
          f"L-d serve_pagerank: no invalidation round: {sp['stats']}")
    lm = serve_lm.run("cuda", log=tagged("serve_lm"))
    check(all(r.done for r in lm["requests"]),
          "L-d serve_lm: a request did not drain")
    dp = distributed_pagerank.run("cuda", log=tagged("distributed"))
    check(dp["world_size"] == 1 and dp["err_1d"] <= 1e-5
          and dp["err_2d"] <= 1e-5,
          f"L-d distributed: 1D {dp['err_1d']:.3e}, 2D {dp['err_2d']:.3e}")
    counts = read_counts()
    log(f"L-d: four examples in {time.perf_counter() - t0:.1f} s; "
        f"launches {counts}")
    return {"launches": counts, "cpaa_err": q["errors"]["cpaa"],
            "err_1d": dp["err_1d"], "err_2d": dp["err_2d"]}


def phase_slice_l() -> dict:
    """Slice L's phases after slice K (L-a runs after slice A, and the
    gates over slice H's ticks inside slice H)."""
    t0 = time.perf_counter()
    phase_slice_l_gate()
    phase_slice_l_lint()
    d = phase_slice_l_examples()
    log(f"[{CARD}] slice L (gate, lint, examples): "
        f"{time.perf_counter() - t0:.1f} s")
    return d


def token_batch_row(cfg, dev):
    """The first sequence of I2's batch 0, [1, I1_SEQ + 1]."""
    from repro_torch.train.data import TokenPipelineConfig, token_batch
    return token_batch(TokenPipelineConfig(cfg.vocab, I1_SEQ, J_MICRO), 0,
                       dev)["tokens"][:1]


def gate_batch(cfg, dev):
    """The gates' sequence (lm_f64_gate's batch), [1, I_GATE_SEQ + 1]."""
    from repro_torch.train.data import TokenPipelineConfig, token_batch
    return token_batch(TokenPipelineConfig(cfg.vocab, I_GATE_SEQ, 1), 11,
                       dev)["tokens"]


def profile_device(fn, label: str, by_op: bool = False,
                   warm: bool = True) -> dict:
    """Device-time breakdown of one call of `fn` (torch.profiler, after one
    warm call unless `warm` is False): the kernels by device time and the
    device's idle share of the wall time (one stream, so kernel times add
    up); with `by_op`, also the operators that launched them (aten ops by
    self device time, each as a share of the busy time). Informational;
    prints "no device time" if the profiler sees no kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows, ops = [], []
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0)
        if dev <= 0:
            continue
        if getattr(e, "device_type", None) == DeviceType.CUDA:
            rows.append((dev, e.count, e.key))
        else:       # operator rows repeat their kernels' time
            ops.append((dev, e.count, e.key))
    rows.sort(reverse=True)
    ops.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    if not rows:
        log(f"profile of {label}: no device time in key_averages")
        return {"wall_us": wall_us, "busy_us": 0.0}
    log(f"profile of {label}: wall {wall_us / 1e3:.1f} ms, device "
        f"busy {busy_us / 1e3:.1f} ms, idle share "
        f"{max(0.0, 1 - busy_us / wall_us):.3f}")
    for dev, count, key in rows[:12]:
        log(f"  {dev / 1e3:9.3f} ms {count:5d}x  {key[:90]}")
    if by_op:
        log(f"  by operator (self device time, share of busy):")
        for dev, count, key in ops[:12]:
            log(f"  {dev / 1e3:9.3f} ms {dev / busy_us:6.1%} {count:5d}x  "
                f"{key[:70]}")
    return {"wall_us": wall_us, "busy_us": busy_us, "top": rows[:12],
            "ops": ops[:12]}


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
    # cuBLAS is deterministic only with a fixed workspace, which torch
    # checks when deterministic algorithms are on (slice G's replay)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    eb_bwd = phase_backward_kernel()
    a = phase_slice_a()
    l_a = phase_slice_l_sanitize(a.pop("svc"), a.pop("cfg"), a["drain_s"],
                                 a["n_queries"])
    torch.cuda.empty_cache()
    b = phase_slice_b()
    d_paper = phase_slice_d_paper_refresh(b.pop("svc"))
    torch.cuda.empty_cache()
    c = phase_slice_c()
    d_upd = phase_slice_d_updates()
    e_cache = phase_slice_e_cache()
    d_scale = phase_slice_d_scale(e_cache["graph"], e_cache["build_s"])
    d_sched = phase_slice_d_scheduler()
    d = add_counts(d_upd["launches"], d_scale["launches"],
                   d_paper["launches"], d_sched["launches"])
    e_tuned = phase_slice_e_tuned(e_cache.pop("graph"))
    e_obs = phase_slice_e_obs()
    e_graphs = e_tuned.pop("graphs")
    e_paper = phase_slice_e_paper(e_tuned.pop("registry"),
                                  e_graphs["naca10"])
    torch.cuda.empty_cache()
    e = add_counts(e_tuned["launches"], e_obs["launches"],
                   e_paper["launches"])
    log(f"slice E launches: tuned {e_tuned['launches']}; obs "
        f"{e_obs['launches']}; paper {e_paper['launches']}")
    phase_slice_f(e_graphs)
    torch.cuda.empty_cache()
    g = phase_slice_g(e_graphs["chunglu"])["launches"]
    del e_graphs
    torch.cuda.empty_cache()
    h = phase_slice_h()["launches"]
    check(h["bsr_spmm"] == h["cheb_step"] == h["embedding_bag"] == 0,
          f"slice H launched a kernel off its path: {h}")
    torch.cuda.empty_cache()
    i_res = phase_slice_i()
    i = i_res.pop("launches")
    i4_adam = i_res["i4"]["adam"]
    reset_counts()
    phase_slice_j(i_res.pop("granite"))
    j = read_counts()
    check(j["bsr_spmm"] == j["cheb_step"] == j["embedding_bag"]
          == j["embedding_bag_backward"] == 0,
          f"slice J launched a kernel off its path: {j}")
    del i_res
    torch.cuda.empty_cache()
    k = phase_slice_k()["launches"]
    torch.cuda.empty_cache()
    l_d = phase_slice_l()
    l = add_counts(l_a["launches"], l_d["launches"])
    check(l["bsr_spmm"] > 0 and l["cheb_step"] > 0,
          f"slice L: a kernel of its path was not launched: {l}")
    torch.cuda.empty_cache()
    m = phase_slice_m()
    m_win = m["windows"][0]

    bsr_b, bsr_by = bound(b["bsr"]["bytes_ms"], b["bsr"]["ops_ms"])
    cheb_b, cheb_by = bound(b["cheb"]["bytes_ms"], b["cheb"]["ops_ms"])
    eb_b, eb_by = bound(c["eb"]["bytes_ms"], c["eb"]["ops_ms"])
    ebb_b, ebb_by = bound(eb_bwd["bytes_ms"], eb_bwd["ops_ms"])
    table = {"kernels": [
        {"name": "bsr_spmm", "route": "cuda",
         "source": "src/repro_torch/kernels/bsr_spmm/csrc/bsr_spmm.cu",
         "replaces": "src/repro/kernels/bsr_spmm/bsr_spmm.py:42",
         "launches": a["launches"]["bsr_spmm"] + b["launches"]["bsr_spmm"]
         + d["bsr_spmm"] + e["bsr_spmm"] + g["bsr_spmm"] + k["bsr_spmm"]
         + l["bsr_spmm"],
         "launches_by_path": {"slice_a": a["launches"]["bsr_spmm"],
                              "slice_b": b["launches"]["bsr_spmm"],
                              "slice_d": d["bsr_spmm"],
                              "slice_e": e["bsr_spmm"],
                              "slice_g": g["bsr_spmm"],
                              "slice_h": h["bsr_spmm"],
                              "slice_j": j["bsr_spmm"],
                              "slice_k": k["bsr_spmm"],
                              "slice_l": l["bsr_spmm"]},
         "launches_by_variant": {
             k: a["launches"]["bsr_spmm_variants"][k]
             + b["launches"]["bsr_spmm_variants"][k]
             + d["bsr_spmm_variants"].get(k, 0)
             + e["bsr_spmm_variants"].get(k, 0)
             + g["bsr_spmm_variants"].get(k, 0)
             + l["bsr_spmm_variants"].get(k, 0)
             for k in a["launches"]["bsr_spmm_variants"]},
         "slice_e_by_variant": e["bsr_spmm_variants"],
         "max_abs_err": max(kerr["bsr_spmm"], b["bsr"]["err"]),
         "ms": b["bsr"]["ms"], "plain_ms": b["bsr"]["plain_ms"],
         "bound_ms": bsr_b, "bound_by": bsr_by,
         "library_ms": b["bsr"]["library_ms"]},
        {"name": "cheb_step", "route": "cuda",
         "source": "src/repro_torch/kernels/cheb_step/csrc/cheb_step.cu",
         "replaces": "src/repro/kernels/cheb_step/cheb_step.py:40",
         "launches": a["launches"]["cheb_step"] + b["launches"]["cheb_step"]
         + d["cheb_step"] + e["cheb_step"] + g["cheb_step"] + k["cheb_step"]
         + l["cheb_step"],
         "launches_by_path": {"slice_a": a["launches"]["cheb_step"],
                              "slice_b": b["launches"]["cheb_step"],
                              "slice_d": d["cheb_step"],
                              "slice_e": e["cheb_step"],
                              "slice_g": g["cheb_step"],
                              "slice_h": h["cheb_step"],
                              "slice_j": j["cheb_step"],
                              "slice_k": k["cheb_step"],
                              "slice_l": l["cheb_step"]},
         "max_abs_err": kerr["cheb_step"],
         "ms": b["cheb"]["ms"], "plain_ms": b["cheb"]["plain_ms"],
         "bound_ms": cheb_b, "bound_by": cheb_by, "library_ms": None},
        {"name": "embedding_bag", "route": "cuda",
         "source": "src/repro_torch/kernels/embedding_bag/csrc/"
                   "embedding_bag.cu",
         "replaces": "src/repro/kernels/embedding_bag/embedding_bag.py:40",
         "launches": c["launches"]["embedding_bag"] + g["embedding_bag"]
         + i["embedding_bag"] + k["embedding_bag"],
         "launches_by_path": {"slice_c": c["launches"]["embedding_bag"],
                              "slice_g": g["embedding_bag"],
                              "slice_h": h["embedding_bag"],
                              "slice_i": i["embedding_bag"],
                              "slice_j": j["embedding_bag"],
                              "slice_k": k["embedding_bag"],
                              "slice_l": l["embedding_bag"]},
         "max_abs_err": c["err"],
         "ms": c["eb"]["ms"], "plain_ms": c["eb"]["plain_ms"],
         "bound_ms": eb_b, "bound_by": eb_by,
         "library_ms": c["eb"]["library_ms"]},
        {"name": "embedding_bag_backward", "route": "cuda",
         "source": "src/repro_torch/kernels/embedding_bag/csrc/"
                   "embedding_bag_backward.cu",
         "replaces": "src/repro/models/recsys/dlrm.py:104",
         "launches": i["embedding_bag_backward"]
         + k["embedding_bag_backward"],
         "launches_by_path": {"slice_i": i["embedding_bag_backward"],
                              "slice_j": j["embedding_bag_backward"],
                              "slice_k": k["embedding_bag_backward"],
                              "slice_l": l["embedding_bag_backward"]},
         "max_abs_err": eb_bwd["err"],
         "ms": eb_bwd["ms"], "split_ms": eb_bwd["split_ms"],
         "plain_ms": eb_bwd["plain_ms"],
         "bound_ms": ebb_b, "bound_by": ebb_by,
         "library_ms": eb_bwd["library_ms"]},
        {"name": "embedding_bag_window", "route": "cuda",
         "source": "src/repro_torch/kernels/embedding_bag/csrc/"
                   "embedding_bag.cu",
         "replaces": "src/repro/kernels/embedding_bag/embedding_bag.py:40",
         "launches": m["launches"]["embedding_bag_window"],
         "launches_by_path": {"slice_m": m["launches"][
             "embedding_bag_window"]},
         "max_abs_err": m_win["fwd"]["err"],
         "ms": m_win["fwd"]["ms"], "call_ms": m_win["fwd"]["call_ms"],
         "plain_ms": m_win["fwd"]["plain_ms"],
         "bound_ms": m_win["fwd"]["bound_ms"],
         "bound_by": m_win["fwd"]["bound_by"], "library_ms": None},
        {"name": "embedding_bag_window_backward", "route": "cuda",
         "source": "src/repro_torch/kernels/embedding_bag/csrc/"
                   "embedding_bag_backward.cu",
         "replaces": "src/repro/models/recsys/dlrm.py:104",
         "launches": m["launches"]["embedding_bag_window_backward"],
         "launches_by_path": {"slice_m": m["launches"][
             "embedding_bag_window_backward"]},
         "max_abs_err": m_win["bwd"]["err"],
         "ms": m_win["bwd"]["ms"], "call_ms": m_win["bwd"]["call_ms"],
         "split_ms": m_win["bwd"]["split_ms"],
         "torch_sort_ms": m_win["bwd"]["torch_sort_ms"],
         "plain_ms": m_win["bwd"]["plain_ms"],
         "bound_ms": m_win["bwd"]["bound_ms"],
         "bound_by": m_win["bwd"]["bound_by"],
         "library_ms": m_win["bwd"]["library_ms"]},
        {"name": "embedding_bag_window_sort", "route": "cuda",
         "source": "src/repro_torch/kernels/embedding_bag/csrc/"
                   "embedding_bag_backward.cu",
         "replaces": "src/repro/models/recsys/dlrm.py:104",
         "launches": m["launches"]["embedding_bag_window_sort"],
         "launches_by_path": {"slice_m": m["launches"][
             "embedding_bag_window_sort"]},
         "max_abs_err": m_win["prep"]["err"],
         "ms": m_win["prep"]["ms"], "plain_ms": m_win["prep"]["plain_ms"],
         "bound_ms": m_win["prep"]["bound_ms"],
         "bound_by": m_win["prep"]["bound_by"], "library_ms": None},
        {"name": "adamw_step", "route": "cuda",
         "source": "src/repro_torch/kernels/adamw/csrc/adamw_step.cu",
         "replaces": "src/repro/train/optimizer.py:55",
         "launches": sum(v["adamw_step"] for v in ADAMW_PATHS.values()),
         "launches_by_path": {k: v["adamw_step"]
                              for k, v in ADAMW_PATHS.items()},
         "max_abs_err": kerr["adamw"]["adamw_step"],
         "ms": i4_adam["step"]["ms"],
         "plain_ms": i4_adam["step"]["plain_ms"],
         "bound_ms": i4_adam["step"]["bound_ms"],
         "bound_by": i4_adam["step"]["bound_by"],
         "library_ms": i4_adam["step"]["library_ms"]},
        {"name": "sum_squares", "route": "cuda",
         "source": "src/repro_torch/kernels/adamw/csrc/sum_squares.cu",
         "replaces": "src/repro/train/optimizer.py:39",
         "launches": sum(v["sum_squares"] for v in ADAMW_PATHS.values()),
         "launches_by_path": {k: v["sum_squares"]
                              for k, v in ADAMW_PATHS.items()},
         "max_abs_err": max(kerr["adamw"]["sum_squares"],
                            i4_adam["norm"]["err"]),
         "ms": i4_adam["norm"]["ms"],
         "plain_ms": i4_adam["norm"]["plain_ms"],
         "bound_ms": i4_adam["norm"]["bound_ms"],
         "bound_by": i4_adam["norm"]["bound_by"],
         "library_ms": i4_adam["norm"]["library_ms"]},
    ]}
    print(json.dumps(table))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
