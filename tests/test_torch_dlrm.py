"""Port's DLRM-RM2 serve path vs the reference's, on the CPU.

The reference's parameters (`repro.models.recsys.dlrm.init_params`) are
carried into the port with `repro_torch.interop.dlrm_params`; batches and
candidate banks are made with numpy from a seed and go through both
packages. On the CPU the port's `embedding_bag` takes its plain version.
Three configs: the smoke config, the same with bags of 4, and RM2 at its
full widths (26 features, D = 64, bottom 13-512-256-64, top 415-512-256-1)
over 26 tables of 97 rows.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import dlrm_rm2 as j_cfgs
from repro.models.recsys import dlrm as j_dlrm
from repro.train.data import RecsysPipelineConfig as JRecsysPipelineConfig
from repro.train.data import recsys_batch as j_recsys_batch

from repro_torch import interop
from repro_torch.configs import dlrm_rm2 as cfgs
from repro_torch.models.recsys import dlrm
from repro_torch.train.data import RecsysPipelineConfig, recsys_batch

CONFIGS = {
    "smoke": cfgs.smoke_config(),
    "bag4": dataclasses.replace(cfgs.smoke_config(), bag_size=4),
    "full_width": dlrm.DLRMConfig(name="rm2-97-row-tables",
                                  vocab_sizes=(97,) * 26),
}


def _ref_config(cfg):
    return j_dlrm.DLRMConfig(**dataclasses.asdict(cfg))


def _params(cfg, seed: int = 0):
    """The reference's parameters as numpy, and the port's copy on CPU."""
    ref = jax.tree.map(np.asarray,
                       j_dlrm.init_params(jax.random.PRNGKey(seed),
                                          _ref_config(cfg)))
    return ref, interop.dlrm_params(ref, device="cpu")


def _batch(cfg, bsz: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    ids = np.stack([rng.integers(0, v, (bsz, cfg.bag_size))
                    for v in cfg.vocab_sizes], axis=1)
    return {"dense": rng.standard_normal((bsz, cfg.n_dense)).astype(
                np.float32),
            "sparse_ids": (ids + cfg.offsets[None, :, None]).astype(np.int32)}


def _torch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


class TestForwardParity:
    # rtol 1e-5 / atol 1e-6: both sides run the MLPs, the Gram matrix and
    # the bag sums in f32 on the CPU, with sums taken in different orders.
    @pytest.mark.parametrize("name", sorted(CONFIGS))
    def test_logits(self, name):
        cfg = CONFIGS[name]
        ref_params, params = _params(cfg, seed=1)
        batch = _batch(cfg, 32, seed=2)
        want = np.asarray(j_dlrm.forward(ref_params, batch, _ref_config(cfg)))
        got = dlrm.forward(params, _torch(batch), cfg)
        assert got.shape == (32,) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)

    @pytest.mark.parametrize("name", sorted(CONFIGS))
    def test_serve_step(self, name):
        cfg = CONFIGS[name]
        ref_params, params = _params(cfg, seed=3)
        batch = _batch(cfg, 16, seed=4)
        want = np.asarray(j_dlrm.serve_step(ref_params, batch,
                                            _ref_config(cfg)))
        got = dlrm.serve_step(params, _torch(batch), cfg)
        assert not got.requires_grad and got.is_inference()
        assert bool(((got > 0) & (got < 1)).all())
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)

    def test_interaction_carries_weight(self):
        """With a table scaled up so the pairwise dots dominate, the logits
        still agree: the Gram matrix and its triangle order are tested, not
        only the dense path."""
        cfg = CONFIGS["full_width"]
        ref_params, _ = _params(cfg, seed=5)
        ref_params["table"] = np.random.default_rng(6).standard_normal(
            ref_params["table"].shape).astype(np.float32) * 0.3
        params = interop.dlrm_params(ref_params, device="cpu")
        batch = _batch(cfg, 16, seed=7)
        want = np.asarray(j_dlrm.forward(ref_params, batch, _ref_config(cfg)))
        got = dlrm.forward(params, _torch(batch), cfg).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    @pytest.mark.parametrize("name", sorted(CONFIGS))
    def test_lookup_goes_through_embedding_bag(self, name, monkeypatch):
        cfg = CONFIGS[name]
        _, params = _params(cfg)
        calls = []
        real = dlrm.embedding_bag

        def spy(ids, table, weights=None):
            calls.append((tuple(ids.shape), weights))
            return real(ids, table, weights)
        monkeypatch.setattr(dlrm, "embedding_bag", spy)
        dlrm.serve_step(params, _torch(_batch(cfg, 8, seed=8)), cfg)
        assert calls == [((8 * cfg.n_sparse, cfg.bag_size), None)]


class TestRetrievalParity:
    @pytest.mark.parametrize("name", sorted(CONFIGS))
    def test_top_k(self, name):
        cfg = CONFIGS[name]
        ref_params, params = _params(cfg, seed=9)
        rng = np.random.default_rng(10)
        batch = {"dense": rng.standard_normal((1, cfg.n_dense)).astype(
                     np.float32),
                 "candidates": rng.standard_normal(
                     (4096, cfg.embed_dim)).astype(np.float32)}
        want_s, want_i = j_dlrm.retrieval_step(ref_params, batch,
                                               _ref_config(cfg), top_k=100)
        got_s, got_i = dlrm.retrieval_step(params, _torch(batch), cfg,
                                           top_k=100)
        assert got_i.dtype == torch.int32 and got_i.shape == (100,)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                                   rtol=1e-5, atol=1e-6)

    def test_ties_lower_index_first(self):
        cfg = CONFIGS["smoke"]
        ref_params, params = _params(cfg, seed=11)
        cand = np.tile(np.random.default_rng(12).standard_normal(
            (8, cfg.embed_dim)).astype(np.float32), (4, 1))   # each row x4
        batch = {"dense": np.ones((1, cfg.n_dense), np.float32),
                 "candidates": cand}
        _, want_i = j_dlrm.retrieval_step(ref_params, batch, _ref_config(cfg),
                                          top_k=10)
        _, got_i = dlrm.retrieval_step(params, _torch(batch), cfg, top_k=10)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


class TestConfigCounterparts:
    @pytest.mark.parametrize("name", ["full", "smoke", "bag4", "full_width"])
    def test_config_properties(self, name):
        cfg = cfgs.full_config() if name == "full" else CONFIGS[name]
        ref = _ref_config(cfg)
        for attr in ("total_rows", "padded_rows", "n_interactions", "top_in"):
            assert getattr(cfg, attr) == getattr(ref, attr), attr
        assert cfg.n_params() == ref.n_params()
        np.testing.assert_array_equal(cfg.offsets, ref.offsets)
        assert cfg.offsets.dtype == ref.offsets.dtype

    def test_config_module(self):
        assert (cfgs.NAME, cfgs.FAMILY) == (j_cfgs.NAME, j_cfgs.FAMILY)
        assert cfgs.SHAPES == j_cfgs.SHAPES
        assert dataclasses.asdict(cfgs.full_config()) == \
            dataclasses.asdict(j_cfgs.full_config())
        assert dataclasses.asdict(cfgs.smoke_config()) == \
            dataclasses.asdict(j_cfgs.smoke_config())
        assert dlrm.CRITEO_KAGGLE_VOCABS == j_dlrm.CRITEO_KAGGLE_VOCABS
        for shape, info in cfgs.SHAPES.items():
            assert cfgs.model_flops(cfgs.full_config(), info["batch"],
                                    info["kind"]) == \
                j_cfgs.model_flops(j_cfgs.full_config(), info["batch"],
                                   info["kind"]), shape

    def test_full_table_size(self):
        """RM2's combined table: 33,762,577 rows padded to 33,762,816 rows of
        64 f32 = 8.64 GB, more than 2^31 elements (the kernel's 64-bit row
        offsets exist for this)."""
        cfg = cfgs.full_config()
        assert cfg.total_rows == 33_762_577
        assert cfg.padded_rows == 33_762_816
        assert cfg.padded_rows * cfg.embed_dim * 4 == 8_643_280_896
        assert cfg.padded_rows * cfg.embed_dim > 2 ** 31
        assert int(cfg.offsets[-2]) >= 2 ** 25   # the last two tables lie above

    def test_make_batch(self):
        cfg = CONFIGS["bag4"]
        b = cfgs.make_batch(cfg, 256, seed=3, device="cpu")
        ids = b["sparse_ids"]
        assert ids.dtype == torch.int32 and ids.shape == (256, 4, 4)
        assert b["dense"].shape == (256, 13) and b["dense"].dtype == \
            torch.float32
        lo = torch.from_numpy(cfg.offsets)[None, :, None]
        hi = lo + torch.tensor(cfg.vocab_sizes)[None, :, None]
        assert bool(((ids >= lo) & (ids < hi)).all())
        assert set(torch.unique(b["labels"]).tolist()) <= {0.0, 1.0}
        again = cfgs.make_batch(cfg, 256, seed=3, device="cpu")
        other = cfgs.make_batch(cfg, 256, seed=4, device="cpu")
        for k in b:
            assert torch.equal(b[k], again[k])
        assert not torch.equal(ids, other["sparse_ids"])
        assert "labels" not in cfgs.make_batch(cfg, 2, device="cpu",
                                               with_labels=False)


class TestRecsysPipeline:
    def test_ids_in_range(self):
        """Mirrors tests/test_train_substrate.py's range check."""
        cfg = RecsysPipelineConfig(vocab_sizes=(50, 500, 5000), n_dense=13,
                                   bag_size=2, global_batch=8)
        ids = recsys_batch(cfg, 0, device="cpu")["sparse_ids"].numpy()
        offsets = np.array([0, 50, 550])
        for f in range(3):
            assert (ids[:, f] >= offsets[f]).all()
            assert (ids[:, f] < offsets[f] + (50, 500, 5000)[f]).all()

    def test_deterministic_in_seed_and_step(self):
        cfg = RecsysPipelineConfig(vocab_sizes=(50, 500), n_dense=3,
                                   bag_size=1, global_batch=64, seed=3)
        a = recsys_batch(cfg, 17, device="cpu")
        b = recsys_batch(cfg, 17, device="cpu")      # "resume" at the step
        for k in a:
            assert torch.equal(a[k], b[k])
        c = recsys_batch(cfg, 18, device="cpu")
        d = recsys_batch(dataclasses.replace(cfg, seed=4), 17, device="cpu")
        assert not torch.equal(a["sparse_ids"], c["sparse_ids"])
        assert not torch.equal(a["sparse_ids"], d["sparse_ids"])

    def test_power_law_like_the_reference(self):
        """Same formula, other random streams: shapes, dtypes and ranges
        match the reference's, and the mean id fraction is E[u^2] = 1/3 in
        both (4,096 x 2 draws per table: standard error about 0.005)."""
        vocabs = (10_000, 3)
        cfg = RecsysPipelineConfig(vocab_sizes=vocabs, n_dense=13,
                                   bag_size=2, global_batch=4096)
        got = recsys_batch(cfg, 5, device="cpu")
        want = jax.tree.map(np.asarray, j_recsys_batch(
            JRecsysPipelineConfig(**dataclasses.asdict(cfg)), 5))
        for k in ("dense", "sparse_ids", "labels"):
            assert tuple(got[k].shape) == want[k].shape, k
        assert got["sparse_ids"].dtype == torch.int32
        frac = got["sparse_ids"][:, 0].double().mean().item() / vocabs[0]
        want_frac = want["sparse_ids"][:, 0].mean() / vocabs[0]
        assert abs(frac - 1 / 3) < 0.02 and abs(want_frac - 1 / 3) < 0.02
        small = got["sparse_ids"][:, 1].numpy() - vocabs[0]
        assert small.min() >= 0 and small.max() <= 2
        # u^2 puts 1 - sqrt(2/3) = 18% of the draws on the top id of a
        # 3-row table, against 1/3 for uniform ids
        assert abs((small == 2).mean() - (1 - np.sqrt(2 / 3))) < 0.02
