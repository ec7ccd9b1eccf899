"""The attention kernels' package (`repro_torch.kernels.attention`) on the
CPU: its plain version against the reference's `chunked_attention`, which
version a call takes, the wrapper's checks and its cost reports.

The plain version (`ref.chunked_attention_ref`) is what the kernels are
held to on the card (tests/test_torch_gpu.py `TestAttentionOnCard`), so it
is held here to the JAX function at the head dims and GQA groups of the
LM configs (danube Dh 80 / G 4, granite Dh 64 / G 3 at narrow widths,
deepseek Dh 128 / G 1, qwen2.5 Dh 128 / G 5, the smoke configs' Dh 12 and
8), at narrow sequences: forward rtol 1e-5 / atol 1e-6 (tests/
test_torch_lm.py's), the gradients of q, k and v under a random cotangent
rtol 1e-4 / atol 1e-6 (test_torch_train_lm.py's GRAD: f32 sums in another
order, through the softmax). Inputs come from numpy with fixed seeds; q,
k and v are standard normal, the cotangent normal with std 0.1. That
puts the gradients at the magnitude GRAD was set for in
test_torch_train_lm.py (|g| up to ~1): a unit cotangent at Dh 80-128 and
G up to 5 gives gradients up to ~10, whose f32 rounding (~1e-7 of that,
in both packages against a float64 run) exceeds atol 1e-6 on the few
elements near zero.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as R
from repro_torch.kernels import cost, launch_counts, reset_launch_counts
from repro_torch.kernels.attention import ops
from repro_torch.kernels.attention.ref import chunked_attention_ref
from repro_torch.models import layers as P

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)

# (head dim, groups) of the configs
HEADS = [(80, 4), (64, 3), (128, 1), (128, 5), (12, 2), (8, 2)]
# masks at narrow sequences: chunks of 8 (q) and 8 or 16 (k)
MASKS = {
    "causal": dict(sq=24, sk=24, kw=dict(causal=True, q_chunk=8,
                                         k_chunk=8)),
    "window": dict(sq=24, sk=24, kw=dict(causal=True, window=7, q_chunk=8,
                                         k_chunk=8)),
    "ragged_offset": dict(sq=11, sk=29, kw=dict(causal=True, window=13,
                                                q_offset=18, q_chunk=8,
                                                k_chunk=16)),
    "no_valid_key": dict(sq=14, sk=14, kw=dict(causal=True, q_offset=-5,
                                               q_chunk=8, k_chunk=8)),
}


def _inputs(seed: int, sq: int, sk: int, dh: int, groups: int,
            hkv: int = 1, b: int = 2):
    rng = np.random.default_rng(seed)
    h = hkv * groups
    return (rng.standard_normal((b, sq, h, dh)).astype(np.float32),
            rng.standard_normal((b, sk, hkv, dh)).astype(np.float32),
            rng.standard_normal((b, sk, hkv, dh)).astype(np.float32),
            (0.1 * rng.standard_normal((b, sq, h, dh))).astype(np.float32))


class TestPlainVsReference:
    @pytest.mark.parametrize("mask", sorted(MASKS))
    @pytest.mark.parametrize("dh,groups", HEADS)
    def test_forward_and_gradients(self, dh, groups, mask):
        c = MASKS[mask]
        q, k, v, ct = _inputs(dh * 7 + groups, c["sq"], c["sk"], dh, groups)

        def j_loss(q, k, v):
            return jnp.sum(R.chunked_attention(q, k, v, **c["kw"]) * ct)
        jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
        want = np.asarray(R.chunked_attention(jq, jk, jv, **c["kw"]))
        jgrads = jax.grad(j_loss, argnums=(0, 1, 2))(jq, jk, jv)
        ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
        out = chunked_attention_ref(*ts, **c["kw"])
        np.testing.assert_allclose(out.detach().numpy(), want, **FWD)
        (out * torch.from_numpy(ct)).sum().backward()
        for t, j, name in zip(ts, jgrads, "qkv"):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(j),
                                       err_msg=name, **GRAD)

    def test_no_valid_key_rows_average_the_masked_tiles(self):
        """A row with no valid key: the reference's output is the mean of
        v over n_k k_chunk keys (padding included), its dq and dk 0."""
        q, k, v, _ = _inputs(5, 6, 10, 8, 2)
        kw = dict(causal=True, q_offset=-4, q_chunk=4, k_chunk=4)
        out = chunked_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                                    **kw)
        dead = out[:, :4].numpy()            # positions -4 .. -1
        mean = v.sum(axis=1, keepdims=True) / 12.0        # 3 tiles of 4
        np.testing.assert_allclose(
            dead, np.broadcast_to(np.repeat(mean, 2, axis=2), dead.shape),
            rtol=1e-6, atol=1e-7)


class TestRouting:
    def test_cpu_tensors_take_the_plain_version(self):
        q, k, v, _ = _inputs(1, 20, 20, 16, 2)
        reset_launch_counts()
        ts = [torch.from_numpy(a) for a in (q, k, v)]
        got = P.chunked_attention(*ts, window=5, q_chunk=8, k_chunk=8)
        want = chunked_attention_ref(*ts, window=5, q_chunk=8, k_chunk=8)
        assert torch.equal(got, want)
        counts = launch_counts()
        assert counts["attention_forward"] == 0
        assert counts["attention_backward"] == 0

    def test_float64_takes_the_plain_version_with_gradients(self):
        q, k, v, ct = _inputs(2, 12, 12, 8, 2)
        reset_launch_counts()
        ts = [torch.from_numpy(a).double().requires_grad_(True)
              for a in (q, k, v)]
        out = P.chunked_attention(*ts, q_chunk=4, k_chunk=4)
        assert out.dtype == torch.float64
        (out * torch.from_numpy(ct).double()).sum().backward()
        assert all(t.grad is not None for t in ts)
        assert launch_counts()["attention_forward"] == 0
        assert launch_counts()["attention_backward"] == 0

    def test_float64_meta_takes_the_plain_version(self):
        q = torch.empty((1, 9, 4, 8), dtype=torch.float64, device="meta")
        k = torch.empty((1, 9, 2, 8), dtype=torch.float64, device="meta")
        seen = []
        with cost.collecting(lambda name, fn: seen.append(name)):
            out = ops.attention(q, k, k, q_chunk=4, k_chunk=4)
        assert out.shape == q.shape and seen == []

    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
    def test_meta_reports_the_kernels_costs_and_launches_nothing(self,
                                                                  dtype):
        q = torch.empty((2, 100, 8, 80), dtype=dtype,
                        device="meta").requires_grad_(True)
        k = torch.empty((2, 100, 2, 80), dtype=dtype,
                        device="meta").requires_grad_(True)
        v = torch.empty_like(k).requires_grad_(True)
        seen = {}

        def sink(name, fn):
            seen[name] = fn()
        reset_launch_counts()
        with cost.collecting(sink):
            out = P.chunked_attention(q, k, v, window=40)
            out.sum().backward()
        assert out.shape == q.shape and out.dtype == dtype
        assert q.grad.shape == q.shape and k.grad.shape == k.shape
        assert set(seen) == {"attention_forward", "attention_backward"}
        # (query, key) pairs a head of the tiles each pass computes
        # (ops.tiles): bf16 one 128 x 128 forward tile, two 64-row steps
        # against one block of 128 keys, one 128-row block against two
        # 64-key tiles; f32 64 x 64 tiles, rows 0-63 against one, rows
        # 64-99 (keys 25-99 under the window) against two
        fwd, dkdv, dq = {torch.bfloat16: (128 * 128, 2 * 64 * 128,
                                          2 * 128 * 64),
                         torch.float32: (3 * 64 * 64,) * 3}[dtype]
        spec = ops._Spec(True, 40, 0, 512)
        t = ops.tiles(dtype, 80)
        assert (ops.tile_pairs(100, 100, spec, *t.fwd),
                ops.tile_pairs(100, 100, spec, *t.dkdv),
                ops.tile_pairs(100, 100, spec, *t.dq)) == (fwd, dkdv, dq)
        es = q.element_size()
        assert seen["attention_forward"] == (
            4 * 80 * fwd * 2 * 8,
            (2 * q.numel() + 2 * k.numel()) * es + 4 * 2 * 8 * 100)
        flops, moved = seen["attention_backward"]
        assert flops == 2 * 80 * 2 * 8 * (4 * dkdv + 3 * dq)
        assert moved > seen["attention_forward"][1]
        assert launch_counts()["attention_forward"] == 0
        assert launch_counts()["attention_backward"] == 0


class TestPairs:
    @pytest.mark.parametrize("s", [1, 63, 64, 65, 300])
    def test_causal_pairs(self, s):
        assert ops.valid_pairs(s, s) == s * (s + 1) // 2
        spec = ops._Spec(True, None, 0, 512)
        assert ops.tile_pairs(s, s, spec, 64) >= ops.valid_pairs(s, s)

    def test_window_offset_and_dead_rows(self):
        # window 3, queries at 8..13 over 8 keys: 2, 1, then dead rows
        # (each counted as all 8 keys)
        assert ops.valid_pairs(6, 8, True, 3, 8) == 2 + 1 + 4 * 8
        # full attention: every pair
        assert ops.valid_pairs(9, 13, causal=False) == 9 * 13

    def test_tiles_skip_what_every_row_misses(self):
        """Causal at 4,096: the tiles on and below the diagonal, 64 x 65 /
        2 of them; with dead rows every tile of their query tile."""
        spec = ops._Spec(True, None, 0, 4096)
        assert ops.tile_pairs(4096, 4096, spec, 64) == 64 * 65 // 2 * 64 * 64
        dead = ops._Spec(True, None, -10, 4096)
        assert ops.tile_pairs(64, 4096, dead, 64) == 64 * 4096

    # the wgmma kernels' tiles (ops.tiles(bf16)): (query rows, keys)
    WGMMA = {"fwd": (128, 128), "dkdv": (64, 128), "dq": (128, 64)}

    @pytest.mark.parametrize("s", [1, 127, 128, 129, 300, 4097])
    @pytest.mark.parametrize("part", sorted(WGMMA))
    def test_causal_pairs_at_the_wgmma_tiles(self, part, s):
        """Ragged Sq: every valid pair inside a visited tile, and no more
        than the diagonal's one tile a query tile past it."""
        rows, keys = self.WGMMA[part]
        spec = ops._Spec(True, None, 0, 512)
        got = ops.tile_pairs(s, s, spec, rows, keys)
        assert got >= ops.valid_pairs(s, s)
        assert got % (rows * keys) == 0
        n_rows = -(-s // rows)
        full = sum(-(-min(i0 + rows, s) // keys) for i0 in range(0, s,
                                                                 rows))
        assert got == full * rows * keys and full <= n_rows * (
            -(-s // keys))

    @pytest.mark.parametrize("part", sorted(WGMMA))
    def test_wgmma_tiles_at_4096(self, part):
        """Causal at 4,096: query tile i sees the key tiles up to its last
        row (the forward's 32 x 33 / 2 tiles of 128 x 128); with dead
        rows every key tile of their query tile."""
        rows, keys = self.WGMMA[part]
        spec = ops._Spec(True, None, 0, 4096)
        want = sum(-(-(i + 1) * rows // keys)
                   for i in range(4096 // rows)) * rows * keys
        assert ops.tile_pairs(4096, 4096, spec, rows, keys) == want
        if part == "fwd":
            assert want == 32 * 33 // 2 * 128 * 128
        dead = ops._Spec(True, None, -10, 4096)
        assert ops.tile_pairs(rows, 4096, dead, rows, keys) == rows * 4096

    @pytest.mark.parametrize("part", sorted(WGMMA))
    def test_wgmma_tiles_under_a_window_and_offset(self, part):
        """Danube-like window 100 over 1,000 keys, queries at 700..999:
        only the key tiles each query tile's window reaches; dead rows
        past the window (queries at 1,200..) take every key tile."""
        rows, keys = self.WGMMA[part]
        spec = ops._Spec(True, 100, 700, 1024)
        want = 0
        for i0 in range(0, 300, rows):
            i1 = min(i0 + rows, 300) - 1
            k0, k1 = max(0, 700 + i0 - 99), min(1000, 700 + i1 + 1)
            want += (-(-k1 // keys) - k0 // keys) * rows * keys
        assert ops.tile_pairs(300, 1000, spec, rows, keys) == want
        assert want >= ops.valid_pairs(300, 1000, True, 100, 700)
        dead = ops._Spec(True, 100, 1200, 1024)
        assert ops.tile_pairs(50, 1000, dead, rows, keys) == \
            -(-50 // rows) * rows * -(-1000 // keys) * keys

    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
    @pytest.mark.parametrize("dh", [16, 64, 80, 128])
    def test_tiles_match_the_sources(self, dtype, dh):
        """ops.tiles states the constants of the kernels that run: the
        wgmma structs (FwdTc, DkDvTc, DqTc) for bf16, the FFMA tiles
        (kBM, kBN, DkDv::BQ) for f32."""
        import re
        from pathlib import Path
        csrc = Path(ops.__file__).parent / "csrc"
        fwd = (csrc / "attention_fwd.cu").read_text()
        bwd = (csrc / "attention_bwd.cu").read_text()

        def const(text, struct, name):
            body = text[text.index(f"struct {struct} {{"):]
            return int(re.search(rf"int {name} = (\d+);", body).group(1))
        t = ops.tiles(dtype, dh)
        if dtype == torch.bfloat16:
            assert t.fwd == (const(fwd, "FwdTc", "BM"),
                             const(fwd, "FwdTc", "BN"))
            assert t.dkdv == (const(bwd, "DkDvTc", "BQ"),
                              const(bwd, "DkDvTc", "BK"))
            assert t.dq == (const(bwd, "DqTc", "BM"), const(bwd, "DqTc", "BN"))
        else:
            common = (csrc / "attention_common.cuh").read_text()
            bm = int(re.search(r"int kBM = (\d+);", common).group(1))
            bn = int(re.search(r"int kBN = (\d+);", common).group(1))
            bq = re.search(r"int BQ = DP > 80 \? (\d+) : (\d+);",
                           bwd).groups()
            assert t.fwd == t.dq == (bm, bn)
            assert t.dkdv == (int(bq[0] if dh > 80 else bq[1]), bn)


class TestChecks:
    """The wrapper's argument checks (on meta tensors, which take the
    kernels' path without a card), each with its reason."""

    @staticmethod
    def _t(shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device="meta")

    def test_other_dtypes_raise(self):
        q = self._t((1, 8, 2, 16), torch.float16)
        with pytest.raises(TypeError, match="bfloat16 or all float32"):
            ops.attention(q, q, q)
        with pytest.raises(TypeError, match="bfloat16 or all float32"):
            ops.attention(self._t((1, 8, 2, 16)),
                          self._t((1, 8, 2, 16), torch.float32),
                          self._t((1, 8, 2, 16)))

    def test_head_dim_past_the_limit_raises(self):
        q = self._t((1, 8, 2, 144))
        with pytest.raises(ValueError, match="limit of 128"):
            ops.attention(q, q, q)

    def test_a_last_dimension_not_contiguous_is_copied_and_counted(self):
        """(the layout the fake world's gathers hand back on meta)"""
        k = self._t((1, 8, 16, 2)).transpose(2, 3)       # [1, 8, 2, 16]
        reset_launch_counts()
        out = ops.attention(self._t((1, 8, 2, 16)), k, k)
        assert out.shape == (1, 8, 2, 16)
        assert ops.contiguous_copies() == 2

    def test_shapes_must_agree(self):
        with pytest.raises(ValueError, match="multiple of Hkv"):
            ops.attention(self._t((1, 8, 3, 16)), self._t((1, 8, 2, 16)),
                          self._t((1, 8, 2, 16)))
        with pytest.raises(ValueError, match=r"k, v \[B, Sk"):
            ops.attention(self._t((1, 8, 2, 16)), self._t((1, 8, 2, 16)),
                          self._t((1, 9, 2, 16)))

    def test_empty_sequences_raise(self):
        with pytest.raises(ValueError, match="empty"):
            ops.attention(self._t((1, 8, 2, 16)), self._t((1, 0, 2, 16)),
                          self._t((1, 0, 2, 16)))

    def test_mixed_devices_raise(self):
        q = torch.zeros((1, 8, 2, 16))
        with pytest.raises(ValueError, match="tensors on"):
            ops.attention(q, self._t((1, 8, 2, 16), torch.float32),
                          self._t((1, 8, 2, 16), torch.float32))
