"""The port's LM serving engine and launcher against the JAX reference on
the CPU (`repro.serve.engine`, `repro.launch.serve`).

The same requests (numpy-seeded prompts) go through both engines with the
reference's parameters carried across by `interop.lm_params`, in the
smoke configs' float32: the greedy tokens must be identical. Also the
three properties `tests/test_serve.py` holds the reference to, on the
port alone, the KV cache written in place, and the launcher for each LM
arch.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get
from repro.models import transformer as RT
from repro.serve import engine as RE
from repro_torch import interop
from repro_torch.configs import granite_moe_3b, h2o_danube_1_8b
from repro_torch.launch import serve as launch_serve
from repro_torch.models import transformer as PT
from repro_torch.serve.engine import Request, ServeEngine

PORT_CFGS = {"h2o-danube-1.8b": h2o_danube_1_8b,
             "granite-moe-3b-a800m": granite_moe_3b}


@pytest.fixture(scope="module")
def lms():
    """{arch: (ref cfg, port cfg, ref params, port params)}."""
    out = {}
    for arch, mod in PORT_CFGS.items():
        cfg = get(arch).smoke_config()
        params = jax.tree.map(np.asarray,
                              RT.init_params(jax.random.PRNGKey(0), cfg))
        out[arch] = (cfg, mod.smoke_config(), params,
                     interop.lm_params(params, device="cpu"))
    return out


def _ragged(vocab: int, n: int, seed: int, new=lambda i: 4 + i):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, int(rng.integers(3, 12))).astype(
        np.int32), new(i)) for i in range(n)]


def _both(lms, arch, specs, max_batch, max_len):
    """Token lists of the same requests through the reference's engine and
    the port's; the port's engine is returned too."""
    cfg, pcfg, params, pp = lms[arch]
    ref = [RE.Request(rid=i, prompt=p, max_new_tokens=n)
           for i, (p, n) in enumerate(specs)]
    RE.ServeEngine(params, cfg, max_batch, max_len).run_until_drained(ref)
    port = [Request(rid=i, prompt=p, max_new_tokens=n)
            for i, (p, n) in enumerate(specs)]
    eng = ServeEngine(pp, pcfg, max_batch, max_len, device="cpu")
    eng.run_until_drained(port)
    assert all(r.done for r in ref + port)
    return [r.out_tokens for r in ref], [r.out_tokens for r in port], eng


class TestEngineVsReference:
    @pytest.mark.parametrize("arch", list(PORT_CFGS))
    def test_queueing_and_slot_reuse(self, lms, arch):
        """7 ragged requests over 3 slots: queueing, slots reused at stale
        lengths, identical greedy tokens."""
        specs = _ragged(lms[arch][0].vocab, 7, seed=11)
        ref, port, eng = _both(lms, arch, specs, max_batch=3, max_len=40)
        assert port == ref
        assert eng.stats["prefills"] == 7

    def test_requests_stop_at_max_len(self, lms):
        """A budget past max_len ends on the reference's rule."""
        arch = "h2o-danube-1.8b"
        specs = [(np.arange(1, 9, dtype=np.int32), 8),
                 (np.arange(3, 6, dtype=np.int32), 12)]
        ref, port, _ = _both(lms, arch, specs, max_batch=2, max_len=16)
        assert port == ref
        assert len(port[0]) < 9

    def test_granite_empty_slots_change_the_drops(self, lms):
        """24 slots: 21 one-token requests leave empty slots ahead of the 3
        long ones, whose tokens then route after the empties' token 0 and
        lose assignments to the capacity (8 per expert). Decoding every
        slot reproduces the reference; a request decoded alone (no drops
        possible) gives other tokens, so the empty slots matter."""
        arch = "granite-moe-3b-a800m"
        cfg = lms[arch][0]
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, cfg.vocab, int(rng.integers(3, 10))).astype(
            np.int32) for _ in range(24)]
        specs = [(p, 1 if i < 21 else 8) for i, p in enumerate(prompts)]
        ref, port, eng = _both(lms, arch, specs, max_batch=24, max_len=32)
        assert port == ref
        assert int(eng.stats["dropped"]) > 0
        solo = []
        for p, n in specs[21:]:
            r = Request(rid=0, prompt=p, max_new_tokens=n)
            ServeEngine(lms[arch][3], lms[arch][1], 1, 32,
                        device="cpu").run_until_drained([r])
            solo.append(r.out_tokens)
        assert solo != port[21:]


class TestEngineProperties:
    """tests/test_serve.py's properties, on the port."""

    def test_engine_matches_naive_greedy(self, lms):
        _, pcfg, _, pp = lms["h2o-danube-1.8b"]
        prompt = np.array([3, 7, 1, 9, 4], np.int32)
        eng = ServeEngine(pp, pcfg, max_batch=4, max_len=32, device="cpu")
        req = Request(rid=0, prompt=prompt, max_new_tokens=6)
        eng.run_until_drained([req])
        assert req.done and len(req.out_tokens) >= 6
        toks, ref = list(prompt), []
        for _ in range(len(req.out_tokens)):
            logits, _ = PT.forward(pp, torch.tensor([toks]), pcfg)
            ref.append(int(logits[0, -1].argmax()))
            toks.append(ref[-1])
        assert req.out_tokens == ref

    def test_continuous_batching_ragged(self, lms):
        _, pcfg, _, pp = lms["h2o-danube-1.8b"]
        rng = np.random.default_rng(0)
        reqs = [Request(rid=i, prompt=rng.integers(0, pcfg.vocab,
                                                   3 + 2 * i).astype(np.int32),
                        max_new_tokens=4 + i) for i in range(5)]
        ServeEngine(pp, pcfg, max_batch=2, max_len=64,
                    device="cpu").run_until_drained(reqs)
        for r in reqs:
            assert r.done and len(r.out_tokens) >= r.max_new_tokens

    def test_batched_results_match_solo(self, lms):
        _, pcfg, _, pp = lms["h2o-danube-1.8b"]
        p1 = np.array([5, 2, 8], np.int32)
        p2 = np.array([1, 1, 2, 3, 5, 8], np.int32)
        solo = Request(rid=0, prompt=p1, max_new_tokens=5)
        ServeEngine(pp, pcfg, 1, 32, device="cpu").run_until_drained([solo])
        a = Request(rid=1, prompt=p1, max_new_tokens=5)
        b = Request(rid=2, prompt=p2, max_new_tokens=5)
        ServeEngine(pp, pcfg, 2, 32, device="cpu").run_until_drained([a, b])
        assert a.out_tokens == solo.out_tokens

    def test_cache_written_in_place_and_params_cast_once(self, lms):
        _, pcfg, _, pp = lms["granite-moe-3b-a800m"]
        pcfg = dataclasses.replace(pcfg, compute_dtype="bfloat16")
        eng = ServeEngine(pp, pcfg, 2, 24, device="cpu")
        assert eng.params["layers"]["moe"]["router"].dtype == torch.bfloat16
        ptrs = [t.data_ptr() for t in eng.kv]
        weights = eng.params["layers"]["wq"].data_ptr()
        eng.run_until_drained([Request(rid=0, prompt=np.arange(5, dtype=np.int32),
                                       max_new_tokens=4)])
        assert [t.data_ptr() for t in eng.kv] == ptrs
        assert eng.params["layers"]["wq"].data_ptr() == weights
        assert eng.stats["ticks"] == 4
        assert bool(eng.kv[0][:, 0, :8].abs().sum(-1).gt(0).all())

    def test_prompt_too_long_raises(self, lms):
        _, pcfg, _, pp = lms["h2o-danube-1.8b"]
        eng = ServeEngine(pp, pcfg, 1, 8, device="cpu")
        with pytest.raises(ValueError, match="max_len"):
            eng.submit(Request(rid=0, prompt=np.arange(6, dtype=np.int32),
                               max_new_tokens=4))


class TestLauncher:
    @pytest.mark.parametrize("arch", ["h2o-danube-1.8b",
                                      "granite-moe-3b-a800m", "deepseek-7b",
                                      "qwen2.5-32b", "qwen3-moe-235b-a22b"])
    def test_smoke_on_cpu(self, arch, capsys):
        out = launch_serve.main(["--arch", arch, "--smoke", "--requests",
                                 "3", "--max-batch", "2", "--max-len", "32",
                                 "--max-new-tokens", "3", "--device", "cpu"])
        assert out["requests"] == 3 and out["tokens"] == 3 * 4
        assert all(r.done for r in out["requests_done"])
        # serve_lm's prompts: the reference launcher's seeded draws
        rng = np.random.default_rng(0)
        for r in out["requests_done"]:
            n = int(rng.integers(3, 16))
            np.testing.assert_array_equal(
                r.prompt, rng.integers(0, out["engine"].cfg.vocab, n))
        assert "served 3 requests, 12 tokens" in capsys.readouterr().out

    def test_pagerank_arch_still_served(self, capsys):
        out = launch_serve.main(["--arch", "pagerank-serve", "--smoke",
                                 "--requests", "4", "--device", "cpu"])
        assert out["served"] >= 4
