"""The port's sharded models against the JAX reference run unsharded.

The reference's production plans (`lm_param_specs`, `dlrm_param_specs`)
are layouts for GSPMD, which computes the same function as one device; so
the reference runs here on one CPU device, and the port runs SPMD on
spawned gloo groups (tests/torch_tp_worker.py) over the ("data",
"model") meshes (1, 2), (2, 2), (2, 4), (1, 8) and the uneven (1, 3), its
parameters sharded by the specs (`sharding.shard_tree`) and the batch by
its rows over "data". The (1, 3) mesh splits the smoke configs' 4 heads
and 256-row vocabulary unevenly (2, 2, 0 heads; 86, 86, 84 rows).

Models: danube-smoke (dense, sliding window), granite-smoke (8 experts:
intra-expert tensor parallelism through the dense dispatch), qwen3-smoke
with 16 experts (expert parallelism over "model", FSDP over "data"),
qwen2.5-smoke (`qkv_bias`) and DLRM-RM2 smoke (the row-sharded table
through the window lookup). qwen3-smoke also runs its all-to-all MoE
(impl "a2a", a capacity factor where nothing drops) with FSDP expert
gathers on the meshes whose model size divides its 16 experts, against
the reference's own all-to-all (`moe_apply_a2a` under `shard_map`, its
aux a per-shard estimate averaged over the mesh) on the same mesh of
fake XLA host devices (tests/jax_tp_a2a_ref.py, in a subprocess started
with the groups). Tolerances: the loss rtol 1e-5;
every gathered gradient leaf rtol 1e-4 / atol 1e-6; one AdamW step's
parameters, m and v, and `grad_norm` rtol 1e-5 (atol 1e-7 where values
land near zero; a parameter whose first moment is tiny, where AdamW's
update is unstable, within the learning rate, as in
tests/test_torch_moe_a2a.py); `forward`, `prefill` and
`decode_step` logits rtol / atol 1e-5 (logits of magnitude ~1 summed
over "model" in another order; the cache's sequence over "model",
decode by split-K); DLRM logits rtol 1e-5
/ atol 1e-6. The window plain versions are held to `jnp.take` on the row
slice in this process.
"""
import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_tp_worker as W
from repro.configs import get as ref_get
from repro.models import transformer as RT
from repro.models.recsys import dlrm as RD
from repro.train import optimizer as ref_opt
from repro_torch.kernels.embedding_bag import ref as eb_ref

HERE = Path(__file__).resolve().parent
SRC = HERE.parent / "src"
MESHES = [(1, 2), (2, 2), (2, 4), (1, 8), (1, 3)]
MESH_IDS = [f"{d}x{m}" for d, m in MESHES]
LOSS = dict(rtol=1e-5, atol=0)
GRAD = dict(rtol=1e-4, atol=1e-6)
STATE = dict(rtol=1e-5, atol=1e-7)
LOGITS = dict(rtol=1e-5, atol=1e-5)
DLRM_LOGITS = dict(rtol=1e-5, atol=1e-6)
G_STABLE = 1e-6           # |g| from which AdamW's update is stable
TINY_SHARE = 0.5          # most of a leaf held below G_STABLE (seen: 42%
                          # of qwen2.5-smoke's key bias, whose gradient is
                          # small where RoPE turns the bias; 2.8% of
                          # qwen3-smoke's experts, few tokens each)
LM_CASES = [c for c in W.CASES if c != "dlrm"]
A2A_MESHES = [m for m in MESHES if 16 % m[1] == 0]
A2A_IDS = [f"{d}x{m}" for d, m in A2A_MESHES]
BATCH, SEQ = 4, 17
TIMEOUT = 600.0

REF_NAMES = {"danube": "h2o-danube-1.8b", "granite": "granite-moe-3b-a800m",
             "qwen3": "qwen3-moe-235b-a22b", "qwen25": "qwen2.5-32b",
             "dlrm": "dlrm-rm2"}


def _ref_config(case: str):
    cfg = ref_get(REF_NAMES[case]).smoke_config()
    if case == "qwen3":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_experts=16))
    return cfg


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _lm_reference(case: str, seed: int):
    """(inputs, expected) of one LM case: the reference's parameters and
    a batch, and its loss, gradients, one AdamW step and the inference
    entry points, all unsharded."""
    cfg = _ref_config(case)
    params = _np_tree(RT.init_params(jax.random.PRNGKey(seed), cfg))
    tokens = np.random.default_rng(seed + 10).integers(
        0, cfg.vocab, (BATCH, SEQ)).astype(np.int32)
    batch = {"tokens": jnp.asarray(tokens)}
    loss, grads = jax.value_and_grad(RT.loss_fn)(params, batch, cfg)
    opt = ref_opt.AdamWConfig(lr=W.LR)
    new_p, new_s, metrics = ref_opt.adamw_update(
        grads, ref_opt.adamw_init(params, opt), params, opt)
    at = W.DECODE_AT
    logits, _ = RT.forward(params, jnp.asarray(tokens[:, :at]), cfg)
    last, kv = RT.prefill(params, jnp.asarray(tokens[:, :at]), cfg,
                          pad_to=W.CACHE)
    dec, _ = RT.decode_step(params, jnp.asarray(tokens[:, at:at + 1]), kv,
                            at, cfg)
    want = {"loss": loss, "step/loss": loss,
            "step/grad_norm": metrics["grad_norm"], "forward": logits,
            "prefill": last, "decode": dec}
    for name, tree in (("grad", grads), ("params", new_p),
                       ("m", new_s["m"]), ("v", new_s["v"])):
        want.update({f"{name}/{k}": v
                     for k, v in W.flatten(_np_tree(tree)).items()})
    return ({"p": W.flatten(params), "b": {"tokens": tokens}},
            {k: np.asarray(v) for k, v in want.items()})


def _dlrm_batch(cfg, bsz: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    ids = np.stack([rng.integers(0, v, (bsz, cfg.bag_size))
                    for v in cfg.vocab_sizes], axis=1)
    return {"dense": rng.standard_normal((bsz, cfg.n_dense)).astype(
                np.float32),
            "sparse_ids": (ids + cfg.offsets[None, :, None]).astype(
                np.int32),
            "labels": (rng.random(bsz) < 0.3).astype(np.float32)}


def _dlrm_reference(seed: int):
    cfg = _ref_config("dlrm")
    params = _np_tree(RD.init_params(jax.random.PRNGKey(seed), cfg))
    batch = _dlrm_batch(cfg, 8, seed + 10)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    # 100 candidates: an uneven split over 3 or 8 ranks, with ties
    cands = np.random.default_rng(seed + 20).standard_normal(
        (100, cfg.embed_dim)).astype(np.float32)
    cands[50] = cands[7]
    scores, idx = RD.retrieval_step(
        params, {"dense": jb["dense"][:1], "candidates": jnp.asarray(cands)},
        cfg, top_k=W.TOP_K)
    loss, grads = jax.value_and_grad(RD.loss_fn)(params, jb, cfg)
    opt = ref_opt.AdamWConfig(lr=W.LR)
    new_p, new_s, metrics = ref_opt.adamw_update(
        grads, ref_opt.adamw_init(params, opt), params, opt)
    want = {"loss": loss, "step/loss": loss,
            "step/grad_norm": metrics["grad_norm"],
            "logits": RD.forward(params, jb, cfg),
            "serve": RD.serve_step(params, jb, cfg),
            "retrieval/scores": scores, "retrieval/idx": idx}
    for name, tree in (("grad", grads), ("params", new_p),
                       ("m", new_s["m"]), ("v", new_s["v"])):
        want.update({f"{name}/{k}": v
                     for k, v in W.flatten(_np_tree(tree)).items()})
    return ({"p": W.flatten(params), "b": {**batch, "candidates": cands}},
            {k: np.asarray(v) for k, v in want.items()})


def _free_ports(count: int) -> list[int]:
    import socket
    socks = [socket.socket() for _ in range(count)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _env(**extra) -> dict:
    return dict(os.environ, OMP_NUM_THREADS="1",
                PYTHONPATH=os.pathsep.join(
                    [str(SRC), str(HERE), os.environ.get("PYTHONPATH", "")]),
                **extra)


def _run_group(in_dir: Path, out_dir: Path, dp: int, tp: int,
               port: int) -> None:
    ws = dp * tp
    procs = [subprocess.Popen(
        [sys.executable, str(HERE / "torch_tp_worker.py"), str(in_dir),
         str(out_dir), str(dp), str(tp)],
        env=_env(RANK=str(r), WORLD_SIZE=str(ws), LOCAL_RANK=str(r),
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(ws)]
    t0, errs = time.perf_counter(), []
    for r, p in enumerate(procs):
        try:
            out, err = p.communicate(
                timeout=max(1.0, TIMEOUT - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise AssertionError(f"mesh {dp}x{tp}: rank {r} timed out")
        if p.returncode != 0:
            errs.append(f"mesh {dp}x{tp} rank {r} rc {p.returncode}\n"
                        f"{err[-4000:]}")
    assert not errs, "\n".join(errs)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(expected, get): the reference's results per case, and get(mesh,
    case) -> the port's on that mesh; get.a2a_ref() -> the reference's
    all-to-all results on A2A_MESHES. The groups run one mesh at a time
    (at most 8 processes alive), beside the reference's subprocess."""
    tmp = tmp_path_factory.mktemp("tp")
    in_dir = tmp / "in"
    in_dir.mkdir()
    expected = {}
    for seed, case in enumerate(W.CASES):
        inputs, want = _dlrm_reference(seed) if case == "dlrm" else \
            _lm_reference(case, seed)
        np.savez(in_dir / f"{case}.npz",
                 **{f"p/{k}": v for k, v in inputs["p"].items()},
                 **{f"b/{k}": v for k, v in inputs["b"].items()})
        expected[case] = want
    t0 = time.perf_counter()
    ref_proc = subprocess.Popen(
        [sys.executable, str(HERE / "jax_tp_a2a_ref.py"),
         str(in_dir / "qwen3.npz"), str(tmp / "a2a_ref.npz"), *A2A_IDS],
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=8",
                 JAX_PLATFORMS="cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    done = {}

    def get(shape, case):
        if shape not in done:
            out = tmp / f"m{shape[0]}x{shape[1]}"
            out.mkdir()
            _run_group(in_dir, out, *shape, _free_ports(1)[0])
            done[shape] = out
        with np.load(done[shape] / f"{case}.npz") as z:
            return {k: z[k] for k in z.files}

    def a2a_ref():
        if "a2a" not in done:
            try:
                _, err = ref_proc.communicate(
                    timeout=max(1.0, TIMEOUT - (time.perf_counter() - t0)))
            except subprocess.TimeoutExpired:
                ref_proc.kill()
                raise AssertionError("the JAX a2a reference timed out")
            assert ref_proc.returncode == 0, err[-4000:]
            with np.load(tmp / "a2a_ref.npz") as z:
                done["a2a"] = {k: z[k] for k in z.files}
        return done["a2a"]
    get.a2a_ref = a2a_ref
    yield expected, get
    if ref_proc.poll() is None:
        ref_proc.kill()
        ref_proc.communicate()


def _check_params(got: dict, want: dict) -> None:
    """The stepped parameters leaf by leaf at STATE, except where AdamW's
    update is unstable: an entry whose first moment is tiny (0 < |m| <
    0.1 G_STABLE) moves by m_hat / (sqrt(v_hat) + eps) with sqrt(v_hat)
    near eps, so the f32 sums of another order move it by up to the
    learning rate; at most TINY_SHARE of a leaf may be such, and there
    the step is held to within LR (tests/test_torch_moe_a2a.py's rule)."""
    keys = sorted(k for k in want if k.startswith("params/"))
    assert keys and sorted(k for k in got if k.startswith("params/")) == keys
    for k in keys:
        leaf = k[len("params/"):]
        m_ref = np.abs(want["m/" + leaf])
        tiny = (m_ref > 0) & (m_ref < 0.1 * G_STABLE)
        assert tiny.mean() <= TINY_SHARE, (k, tiny.mean())
        np.testing.assert_allclose(got[k][~tiny], want[k][~tiny], err_msg=k,
                                   **STATE)
        assert np.all(np.abs(got[k] - want[k])[tiny] <= W.LR), k


def _close(got: dict, want: dict, prefix: str, tol: dict) -> None:
    keys = sorted(k for k in want if k.startswith(prefix))
    assert keys and sorted(k for k in got if k.startswith(prefix)) == keys
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


@pytest.mark.parametrize("case", LM_CASES)
@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
class TestShardedLM:
    def test_loss(self, runs, shape, case):
        want, get = runs
        np.testing.assert_allclose(get(shape, case)["loss"],
                                   want[case]["loss"], **LOSS)

    def test_gradient_leaves(self, runs, shape, case):
        want, get = runs
        _close(get(shape, case), want[case], "grad/", GRAD)

    def test_adamw_step(self, runs, shape, case):
        want, get = runs
        got = get(shape, case)
        _check_params(got, want[case])
        for part in ("m/", "v/"):
            _close(got, want[case], part, STATE)
        np.testing.assert_allclose(got["step/grad_norm"],
                                   want[case]["step/grad_norm"], rtol=1e-5)
        np.testing.assert_allclose(got["step/loss"], want[case]["loss"],
                                   **LOSS)

    def test_forward_logits(self, runs, shape, case):
        want, get = runs
        np.testing.assert_allclose(get(shape, case)["forward"],
                                   want[case]["forward"], **LOGITS)

    def test_prefill_and_decode_logits(self, runs, shape, case):
        want, get = runs
        got = get(shape, case)
        np.testing.assert_allclose(got["prefill"], want[case]["prefill"],
                                   **LOGITS)
        np.testing.assert_allclose(got["decode"], want[case]["decode"],
                                   **LOGITS)


@pytest.mark.parametrize("shape", A2A_MESHES, ids=A2A_IDS)
class TestShardedA2A:
    """qwen3-smoke (16 experts) with impl "a2a" at a capacity factor where
    nothing drops, sharded (its expert weights all-gathered over "data",
    the a2a a region over "model"), against the reference's all-to-all
    under the same mesh (tests/jax_tp_a2a_ref.py): the loss, every
    gathered gradient leaf and one AdamW step at the tolerances of
    TestShardedLM."""

    @staticmethod
    def _pair(runs, shape):
        _, get = runs
        got = get(shape, "qwen3")
        key = f"{shape[0]}x{shape[1]}/"
        ref = get.a2a_ref()
        return ({k[len("a2a/"):]: v for k, v in got.items()
                 if k.startswith("a2a/")},
                {k[len(key):]: v for k, v in ref.items()
                 if k.startswith(key)})

    def test_loss(self, runs, shape):
        got, want = self._pair(runs, shape)
        np.testing.assert_allclose(got["loss"], want["loss"], **LOSS)

    def test_gradient_leaves(self, runs, shape):
        got, want = self._pair(runs, shape)
        _close(got, want, "grad/", GRAD)

    def test_adamw_step(self, runs, shape):
        got, want = self._pair(runs, shape)
        _check_params(got, want)
        for part in ("m/", "v/"):
            _close(got, want, part, STATE)
        np.testing.assert_allclose(got["step/grad_norm"],
                                   want["step/grad_norm"], rtol=1e-5)
        np.testing.assert_allclose(got["step/loss"], want["loss"], **LOSS)


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
class TestShardedDLRM:
    def test_logits(self, runs, shape):
        want, get = runs
        np.testing.assert_allclose(get(shape, "dlrm")["logits"],
                                   want["dlrm"]["logits"], **DLRM_LOGITS)

    def test_serve_and_retrieval(self, runs, shape):
        """serve_step's probabilities (rtol 1e-5 / atol 1e-6) and the
        top-8 of a bank of 100 candidates sharded over every axis (scores
        rtol 1e-5, the same indices, a tie broken lower index first)."""
        want, get = runs
        got = get(shape, "dlrm")
        np.testing.assert_allclose(got["serve"], want["dlrm"]["serve"],
                                   **DLRM_LOGITS)
        np.testing.assert_allclose(got["retrieval/scores"],
                                   want["dlrm"]["retrieval/scores"],
                                   rtol=1e-5)
        np.testing.assert_array_equal(got["retrieval/idx"],
                                      want["dlrm"]["retrieval/idx"])

    def test_loss_and_gradient_leaves(self, runs, shape):
        want, get = runs
        got = get(shape, "dlrm")
        np.testing.assert_allclose(got["loss"], want["dlrm"]["loss"],
                                   **LOSS)
        _close(got, want["dlrm"], "grad/", GRAD)

    def test_train_step(self, runs, shape):
        want, get = runs
        got = get(shape, "dlrm")
        _check_params(got, want["dlrm"])
        for part in ("m/", "v/"):
            _close(got, want["dlrm"], part, STATE)
        np.testing.assert_allclose(got["step/grad_norm"],
                                   want["dlrm"]["step/grad_norm"],
                                   rtol=1e-5)


# ------------------------------------------------------ window plain versions --

@pytest.mark.parametrize("row_lo,n_local", [(0, 40), (40, 40), (100, 20),
                                            (0, 120), (110, 30)])
class TestWindowPlainVersions:
    """The window lookup and its backward against `jnp.take` on the row
    slice [row_lo, row_lo + n_local) of a 120-row table (the last window
    runs past it, as the padded shard of an uneven split does)."""

    def _inputs(self):
        rng = np.random.default_rng(3)
        table = rng.standard_normal((120, 8)).astype(np.float32)
        ids = rng.integers(0, 120, (32, 3)).astype(np.int32)
        w = rng.standard_normal((32, 3)).astype(np.float32)
        g = rng.standard_normal((32, 8)).astype(np.float32)
        return table, ids, w, g

    def test_lookup(self, row_lo, n_local):
        table, ids, w, _ = self._inputs()
        local = np.zeros((n_local, 8), np.float32)
        real = table[row_lo:row_lo + n_local]
        local[:len(real)] = real
        inside = (ids >= row_lo) & (ids < row_lo + n_local)
        rows = jnp.take(jnp.asarray(local), jnp.asarray(
            np.where(inside, ids - row_lo, 0)), axis=0)
        want = jnp.sum(jnp.where(inside[..., None], rows, 0.0)
                       * w[..., None], axis=1)
        got = eb_ref.embedding_bag_window_ref(
            torch.from_numpy(ids), torch.from_numpy(local), row_lo,
            torch.from_numpy(w))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)

    def test_backward(self, row_lo, n_local):
        table, ids, w, g = self._inputs()

        def f(tab):
            whole = jnp.concatenate([tab, jnp.zeros((200, 8))])
            return jnp.sum(jnp.sum(jnp.take(whole, ids, axis=0)
                                   * w[..., None], axis=1) * g)
        full = np.asarray(jax.grad(f)(jnp.asarray(table)))
        want = np.zeros((n_local, 8), np.float32)
        real = full[row_lo:row_lo + n_local]
        want[:len(real)] = real
        got = eb_ref.embedding_bag_backward_window_ref(
            torch.from_numpy(ids), torch.from_numpy(g), row_lo, n_local,
            torch.from_numpy(w))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
