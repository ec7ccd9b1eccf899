"""The port's expert-parallel all-to-all MoE (`models.moe.moe_apply_a2a`,
the a2a branch of `models.transformer.ffn`, `distributed.sharding`)
against the JAX package's `moe_apply_a2a` under `shard_map` and its
smoke-granite `loss_fn` under `with mesh:`.

The port is SPMD over the ranks of gloo groups: world size 1 runs in this
process on a (1, 1) ("data", "model") mesh; 2, 4 and 8 run as spawned
groups (tests/torch_moe_a2a_worker.py) on meshes (1, 2), (1, 4), (2, 4)
and (1, 8). The reference runs in a subprocess on 8 fake XLA devices
(tests/jax_moe_a2a_ref.py). The groups and the reference start together,
on the first test that needs one.

The reference's gradient is that of one global loss: the mean over
devices of sum(y^2), or of the data x model mean of the aux estimate
(and the smoke model's mean loss over the whole batch). The port's is
assembled as a data-parallel mean: each rank's gradient with respect to
the full-shape x and weights (zero outside its data shard and expert
slice), averaged over the ranks.

Tolerances: f32 outputs and aux rtol 1e-5 / atol 1e-6; gradients rtol
1e-4 / atol 1e-6. Cases: capacity factor 8 (nothing drops) and a router
pulled towards one expert at capacity factor 0.5, where assignments drop
at both stages on every mesh.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from repro.configs import granite_moe_3b as ref_granite
from repro.models import transformer as RT

import torch_moe_a2a_worker as W
from repro_torch.core import distributed as tdist
from repro_torch.core.distributed import collective_counts, init_mesh, \
    reset_collective_counts
from repro_torch.distributed import current_mesh, use_mesh
from repro_torch.models import moe as PM
from repro_torch.models import transformer as PT

HERE = Path(__file__).resolve().parent
SRC = HERE.parent / "src"
MESHES = [shape for shapes in W.MESHES.values() for shape in shapes]
MESH_IDS = [f"{d}x{m}" for d, m in MESHES]
F32 = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
TIMEOUT = 600.0


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


def _wait(procs, label: str, t0: float) -> None:
    errs = []
    for r, p in enumerate(procs):
        left = max(1.0, TIMEOUT - (time.perf_counter() - t0))
        try:
            out, err = p.communicate(timeout=left)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise AssertionError(f"{label}: process {r} timed out after "
                                 f"{TIMEOUT} s")
        if p.returncode != 0:
            errs.append(f"{label} process {r} rc {p.returncode}\n{out}\n"
                        f"{err[-4000:]}")
    assert not errs, "\n".join(errs)


def make_inputs(path: Path) -> dict:
    """The cases' numpy inputs, written to `path` for the subprocesses:
    each case's x and MoE weights, the smoke-granite parameters of the
    reference's `init_params` and a token batch."""
    out = {}
    for case in W.CASES:
        for k, v in W.moe_inputs(case).items():
            out[f"{case}/{k}"] = v
    cfg = W.lm_config(ref_granite)
    params = RT.init_params(jax.random.PRNGKey(0), cfg)
    for key, v in W._flat(params):
        out[f"lm/params/{key}"] = np.asarray(v)
    out["lm/tokens"] = np.random.default_rng(5).integers(
        0, cfg.vocab, (W.LM_BATCH, W.LM_SEQ + 1)).astype(np.int32)
    np.savez(path, **out)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """get(shape) -> every rank's results on that mesh, rank order;
    ref() -> the reference's npz as a dict."""
    tmp = tmp_path_factory.mktemp("moe_a2a")
    inputs = make_inputs(tmp / "inputs.npz")
    t0 = time.perf_counter()
    ref_proc = subprocess.Popen(
        [sys.executable, str(HERE / "jax_moe_a2a_ref.py"),
         str(tmp / "inputs.npz"), str(tmp / "ref.npz")],
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=8",
                 JAX_PLATFORMS="cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    spawned = [ws for ws in W.MESHES if ws > 1]
    groups = {}
    for ws, port in zip(spawned, _free_ports(len(spawned))):
        out = tmp / f"world{ws}"
        out.mkdir()
        groups[ws] = (out, [subprocess.Popen(
            [sys.executable, str(HERE / "torch_moe_a2a_worker.py"),
             str(tmp / "inputs.npz"), str(out)],
            env=_env(RANK=str(r), WORLD_SIZE=str(ws), LOCAL_RANK=str(r),
                     MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(ws)])
    cache = {}

    def get(shape):
        ws = int(np.prod(shape))
        if ws not in cache:
            if ws == 1:
                tdist.init_process_group("cpu")
                assert tdist.world_size() == 1
                cache[1] = [{s: W.battery(W.mesh_of(s), inputs)
                             for s in W.MESHES[1]}]
            else:
                out, procs = groups[ws]
                _wait(procs, f"world {ws}", t0)
                cache[ws] = []
                for r in range(ws):
                    with open(out / f"rank{r}.pkl", "rb") as f:
                        cache[ws].append(pickle.load(f))
        return [rk[tuple(shape)] for rk in cache[ws]]

    def ref():
        if "ref" not in cache:
            _wait([ref_proc], "the JAX reference", t0)
            cache["ref"] = dict(np.load(tmp / "ref.npz"))
        return cache["ref"]
    get.ref = ref
    yield get
    for p in [ref_proc] + [p for _, procs in groups.values() for p in procs]:
        if p.poll() is None:
            p.kill()
            p.communicate()


def _key(shape, *parts) -> str:
    return "/".join([f"{shape[0]}x{shape[1]}", *parts])


# ------------------------------------------------------------ moe_apply_a2a --

@pytest.mark.parametrize("case", list(W.CASES))
@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
class TestMoeApplyA2A:
    def test_outputs_match_reference(self, runs, shape, case):
        """Every rank's y [T_loc, D], its local aux estimate and the mesh
        mean of the estimates against the reference device of the same
        (data, model) coordinate."""
        res = [r[case] for r in runs(shape)]
        ref = runs.ref()
        np.testing.assert_allclose(np.stack([r["y"] for r in res]),
                                   ref[_key(shape, case, "y")], **F32)
        np.testing.assert_allclose([r["aux"] for r in res],
                                   ref[_key(shape, case, "aux")], **F32)
        np.testing.assert_allclose([r["aux_mean"] for r in res],
                                   ref[_key(shape, case, "aux_mean")], **F32)

    @pytest.mark.parametrize("loss", ["y", "aux"])
    def test_gradients_match_reference(self, runs, shape, case, loss):
        """The data-parallel mean of the ranks' gradients of sum(y^2) (or
        of the averaged aux) equals the gradient of the reference's one
        global loss, for x, the router and each expert weight."""
        res = [r[case] for r in runs(shape)]
        ref = runs.ref()
        for leaf in W.LEAVES:
            got = sum(r[f"grad_{loss}"][leaf] for r in res) / len(res)
            np.testing.assert_allclose(
                got, ref[_key(shape, case, f"grad_{loss}", leaf)], **GRAD,
                err_msg=leaf)

    def test_dropped_assignments_at_each_stage(self, runs, shape, case):
        """Capacity 8 drops nothing; the drop case drops at both stages
        (summed over the ranks), so it exercises both capacities."""
        res = [r[case] for r in runs(shape)]
        s1 = sum(r["dropped_stage1"] for r in res)
        s2 = sum(r["dropped_stage2"] for r in res)
        assert all(r["dropped"] == r["dropped_stage1"] + r["dropped_stage2"]
                   for r in res)
        if case == "nodrop":
            assert s1 == s2 == 0
        else:
            assert s1 > 0 and s2 > 0, (s1, s2)

    def test_four_trips_forward_two_backward(self, runs, shape, case):
        """Forward: tokens, expert ids and valid flags out, rows back, and
        one all-reduce of aux; backward of sum(y^2): the gradients of the
        token and row trips. Bytes are the send buffers, ep * cap_loc
        rows each."""
        dp, ep = shape
        t_loc = W.N_TOKENS // dp
        cap_loc = max(8, int(W.CASES[case]["cf"] * t_loc * W.TOP_K / ep / 8)
                      * 8)
        n_send = ep * cap_loc
        for r in runs(shape):
            fwd, bwd = r[case]["counts_fwd"], r[case]["counts_bwd"]
            assert fwd == {
                "moe/aux/all_reduce/world": {"calls": 1, "bytes": 4},
                "moe/dispatch/all_to_all/model": {
                    "calls": 3, "bytes": n_send * (W.D_MODEL + 2) * 4},
                "moe/return/all_to_all/model": {
                    "calls": 1, "bytes": n_send * W.D_MODEL * 4}}
            assert bwd == {
                "moe/dispatch_grad/all_to_all/model": {
                    "calls": 1, "bytes": n_send * W.D_MODEL * 4},
                "moe/return_grad/all_to_all/model": {
                    "calls": 1, "bytes": n_send * W.D_MODEL * 4}}

    def test_second_call_bitwise_equal(self, runs, shape, case):
        assert all(r[case]["bitwise_again"] for r in runs(shape))


@pytest.mark.parametrize("shape", [s for s in MESHES if s[1] > 1],
                         ids=[i for s, i in zip(MESHES, MESH_IDS) if s[1] > 1])
def test_model_group_returns_differ_where_stage_two_drops(runs, shape):
    """Reference behaviour the port reproduces: the ranks of one "model"
    group route the same tokens, and stage 2 fills each expert in arrival
    order (peer 0 first), so where it drops, the ranks get different rows
    back for the same tokens. Without drops they agree."""
    dp, ep = shape
    ref = runs.ref()
    for case in W.CASES:
        y = ref[_key(shape, case, "y")].reshape(dp, ep, -1)
        gap = float(np.abs(y - y[:, :1]).max())
        assert (gap > 0) == (case == "drop"), (case, gap)


# ----------------------------------------------------------- transformer --

@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
class TestTransformerA2A:
    def test_loss_and_grads_match_reference(self, runs, shape):
        """Smoke granite (impl "a2a", capacity 8): each rank's loss on its
        data shard of the batch; their mean against the reference's loss
        under the mesh, and the mean of their gradients against its
        gradient, every leaf. The reference's jaxpr holds an all_to_all."""
        res = [r["lm"] for r in runs(shape)]
        ref = runs.ref()
        assert bool(ref[_key(shape, "lm", "all_to_all")])
        np.testing.assert_allclose(np.mean([r["loss"] for r in res]),
                                   ref[_key(shape, "lm", "loss")], **F32)
        for leaf in res[0]["grads"]:
            got = sum(r["grads"][leaf] for r in res) / len(res)
            np.testing.assert_allclose(
                got, ref[_key(shape, "lm", "grad", leaf)], **GRAD,
                err_msg=leaf)

    def test_every_moe_layer_ran_the_a2a_path(self, runs, shape):
        """Per layer: 4 trips forward, 4 more where the checkpointed block
        is recomputed in the backward (it stops after the return trip, the
        last input the backward needs), and 2 gradient trips."""
        n_layers = W.lm_config().n_layers
        for r in runs(shape):
            calls = {k: v["calls"] for k, v in r["lm"]["counts"].items()}
            assert calls["moe/dispatch/all_to_all/model"] == 3 * 2 * n_layers
            assert calls["moe/return/all_to_all/model"] == 2 * n_layers
            assert calls["moe/dispatch_grad/all_to_all/model"] == n_layers
            assert calls["moe/return_grad/all_to_all/model"] == n_layers


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
def test_train_step_refuses_a_mesh_of_many_ranks(runs, shape):
    """make_train_step under a mesh of more than one rank raises before any
    trip (nothing takes the mean of the ranks' gradients, so AdamW would
    drive the replicated weights apart); at world size 1 it takes its
    step through the a2a path."""
    for r in runs(shape):
        train = r["train"]
        if int(np.prod(shape)) > 1:
            assert train["refused"] and "data-parallel mean" in \
                train["message"] and train["trips"] == {}
        else:
            assert not train["refused"] and np.isfinite(train["loss"])
            assert train["trips"]["moe/return/all_to_all/model"]["calls"] > 0


@pytest.mark.parametrize("shape", [s for s in MESHES if s[1] > 1],
                         ids=[i for s, i in zip(MESHES, MESH_IDS) if s[1] > 1])
def test_falls_back_when_model_size_does_not_divide_experts(runs, shape):
    """3 experts over a "model" size of 2, 4 or 8: the dense path, bit for
    bit, and no trip."""
    for r in runs(shape):
        assert r["fallback"]["same"] and r["fallback"]["trips"] == {}


class TestSingleRank:
    def test_falls_back_without_a_mesh(self):
        """impl "a2a" with no active mesh is the dense path, bit for bit,
        and makes no collective call."""
        cfg = W.lm_config()
        dense = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, impl="dense"))
        gen = torch.Generator().manual_seed(0)
        params = PT.init_params(gen, cfg)
        tokens = torch.randint(0, cfg.vocab, (2, 9), generator=gen)
        assert current_mesh() is None
        reset_collective_counts()
        a = PT.loss_fn(params, {"tokens": tokens}, cfg)
        assert collective_counts() == {}
        assert torch.equal(a, PT.loss_fn(params, {"tokens": tokens}, dense))

    def test_a2a_matches_dense_at_world_size_1(self, runs):
        """On a (1, 1) mesh at capacity 8, the a2a loss and gradients
        against the dense path's (the card's gate J-a, on the CPU)."""
        runs((1, 1))            # a single-rank gloo group is up
        cfg = W.lm_config()
        dense = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, impl="dense"))
        gen = torch.Generator().manual_seed(1)
        params = PT.init_params(gen, cfg)
        tokens = torch.randint(0, cfg.vocab, (2, 17), generator=gen)
        leaves = [p.requires_grad_(True) for _, p in W._flat(params)]
        mesh = W.mesh_of((1, 1))
        out = {}
        for name, c, m in (("a2a", cfg, mesh), ("dense", dense, None)):
            reset_collective_counts()
            with use_mesh(m):
                loss = PT.loss_fn(params, {"tokens": tokens}, c)
                out[name] = (loss, torch.autograd.grad(loss, leaves))
            assert bool(collective_counts()) == (name == "a2a")
        torch.testing.assert_close(out["a2a"][0], out["dense"][0], **F32)
        for a, b in zip(out["a2a"][1], out["dense"][1]):
            torch.testing.assert_close(a, b, **GRAD)

    def test_stats_count_both_stages(self, runs):
        runs((1, 1))
        mesh = W.mesh_of((1, 1))
        inputs = W.moe_inputs("drop")
        p = {k: torch.from_numpy(inputs[k]) for k in W.LEAVES}
        cfg = W.moe_config("drop")
        stats = {}
        PM.moe_apply_a2a(p, p["x"], cfg, 1, mesh.get_group("model"),
                         stats=stats)
        PM.moe_apply_a2a(p, p["x"], cfg, 1, mesh.get_group("model"),
                         stats=stats)
        assert int(stats["dropped"]) == int(stats["dropped_stage1"]) \
            + int(stats["dropped_stage2"]) > 0
        assert int(stats["dropped_stage1"]) % 2 == 0   # two equal calls

    @pytest.mark.parametrize("cf, t, k, e, ep, want", [
        (1.25, 4096, 8, 40, 1, (40960, 1280)),     # granite, train_4k
        (1.25, 4096, 8, 128, 1, (40960, 400)),     # qwen3, train_4k
        (0.9, 64, 2, 8, 1, (112, 8)),              # 115.2 and 12.6 down
        (0.9, 64, 2, 8, 2, (56, 24)),              # 57.6 and 25.2 down
        (0.9, 64, 2, 8, 4, (24, 40)),              # 28.8 and 43.2 down
        (0.5, 16, 2, 8, 8, (8, 32))])              # cap_loc at least 8
    def test_capacities_round_down(self, cf, t, k, e, ep, want):
        """cap_loc = cf T k / ep and cap2 = cf ep cap_loc / (E / ep), each
        rounded down to a multiple of 8 (the reference's moe.py:137 and
        :179; the granite and qwen3 rows are the values the reference's
        formulas give at train_4k), where the dense capacity rounds up."""
        cfg = PM.MoEConfig(n_experts=e, top_k=k, capacity_factor=cf)
        assert PM.a2a_capacities(cfg, t, ep) == want

    def test_stage_one_keeps_cap_loc_rows(self, runs):
        """At ep = 1 every assignment goes to the one peer: stage 1 keeps
        exactly cap_loc = 112 of 128 (0.9 x 64 x 2 rounded down; 120 if it
        rounded up), and stage 2 drops what each expert gets past cap2 = 8
        among those 112, counted here from the router's own choices."""
        runs((1, 1))
        mesh = W.mesh_of((1, 1))
        rng = np.random.default_rng(9)
        x = torch.from_numpy(rng.standard_normal((64, 16)).astype(np.float32))
        p = {"router": torch.from_numpy(
                 rng.standard_normal((16, 8)).astype(np.float32)),
             "w1": torch.zeros(8, 16, 4), "w3": torch.zeros(8, 16, 4),
             "w2": torch.zeros(8, 4, 16)}
        cfg = PM.MoEConfig(n_experts=8, top_k=2, capacity_factor=0.9)
        stats = {}
        PM.moe_apply_a2a(p, x, cfg, 1, mesh.get_group("model"), stats=stats)
        eidx = torch.topk(torch.softmax(x @ p["router"], -1), 2).indices
        kept = torch.bincount(eidx.reshape(-1)[:112], minlength=8)
        assert int(stats["dropped_stage1"]) == 128 - 112
        assert int(stats["dropped_stage2"]) == int((kept - 8).clamp(min=0)
                                                   .sum())

    def test_positions_in_groups_matches_reference(self):
        from repro.models.moe import _positions_in_groups
        rng = np.random.default_rng(0)
        g = rng.integers(0, 5, 200)
        valid = rng.random(200) > 0.3
        for v in (None, valid):
            want = _positions_in_groups(
                jax.numpy.asarray(g), 5, 17,
                None if v is None else jax.numpy.asarray(v.astype(np.float32)))
            got = PM.positions_in_groups(
                torch.from_numpy(g), 5, 17,
                None if v is None else torch.from_numpy(v))
            np.testing.assert_array_equal(got[0].numpy()[v if v is not None
                                                          else slice(None)],
                                          np.asarray(want[0])[
                                              v if v is not None
                                              else slice(None)])
            np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))

    def test_data_shard_follows_the_token_spec(self, runs):
        """Rows of the rank's data coordinate when the data size divides
        the batch, else the whole batch; no mesh: the batch itself."""
        runs((1, 1))
        x = torch.arange(12).reshape(6, 2)
        assert W.data_shard(x) is x
        mesh = W.mesh_of((1, 1))
        assert torch.equal(W.data_shard(x, mesh), x)
        with use_mesh(mesh):
            assert current_mesh() is mesh and torch.equal(W.data_shard(x), x)
            with use_mesh(None):
                assert current_mesh() is None
            assert current_mesh() is mesh
        assert current_mesh() is None

    def test_cuda_mesh_raises_without_a_gpu(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            init_mesh((1, 1), ("data", "model"))
