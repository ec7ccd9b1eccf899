"""The window backward's index preparation and its plain versions on the
CPU.

`ref.window_sort_ref` (the compaction and stable sort that
`embedding_bag_window_sort` in `csrc/embedding_bag_backward.cu` computes
on the card) against a count in numpy: `np.argsort(kind="stable")` of the
local rows of the ids inside the window, for an empty window, an
all-inside window, the padded last shard that runs past the table, and
heavy duplicates. The plain window backward, which goes through that
preparation, against `jax.grad` of `jnp.take` on the row slice (rtol
1e-5 / atol 1e-6, as tests/test_torch_tensor_parallel.py holds the
window plain versions), and bitwise against the masked `index_add_` it
replaced (each row's terms in position order either way).
The chunk plan the card's window passes compute from n_in fits the
scratch and grid the wrapper sizes from the call's n (a hypothesis
property), and the sort's constants are those of its source.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro_torch.kernels import _build
from repro_torch.kernels.embedding_bag import ops as eb_ops
from repro_torch.kernels.embedding_bag import ref as eb_ref

V = 120          # table rows; windows past it are the padded last shard


def _ids(shape, hi: int, seed: int, power: float = 1.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (hi * rng.random(shape) ** power).astype(np.int32)


def _numpy_sort(ids: np.ndarray, row_lo: int, n_local: int):
    flat = ids.reshape(-1).astype(np.int64)
    pos = np.flatnonzero((flat >= row_lo) & (flat < row_lo + n_local))
    order = np.argsort(flat[pos] - row_lo, kind="stable")
    return (flat[pos][order] - row_lo).astype(np.int32), \
        pos[order].astype(np.int32)


WINDOWS = [(0, 40), (40, 40), (100, 20), (0, V), (110, 30), (200, 50),
           (0, 1 << 26)]


class TestWindowSortPlain:
    @pytest.mark.parametrize("row_lo,n_local", WINDOWS)
    @pytest.mark.parametrize("shape,power", [((32, 3), 1.0), ((500, 1), 3.0),
                                             ((64, 26), 2.0)])
    def test_against_numpy(self, row_lo, n_local, shape, power):
        """Windows from empty ([200, 250): no id reaches it) to all-inside
        ([0, V), [0, 2^26)), the last past V; power-law ids repeat rows
        hundreds of times."""
        ids = _ids(shape, V, sum(shape) + row_lo, power)
        keys, vals, n_in = eb_ref.window_sort_ref(torch.from_numpy(ids),
                                                  row_lo, n_local)
        want_keys, want_vals = _numpy_sort(ids, row_lo, n_local)
        assert keys.dtype == vals.dtype == n_in.dtype == torch.int32
        assert n_in.tolist() == [len(want_keys)]
        np.testing.assert_array_equal(keys.numpy(), want_keys)
        np.testing.assert_array_equal(vals.numpy(), want_vals)

    def test_empty_and_full_windows(self):
        ids = torch.from_numpy(_ids((50, 2), V, 1))
        keys, vals, n_in = eb_ref.window_sort_ref(ids, V, 64)
        assert n_in.item() == 0 and keys.numel() == vals.numel() == 0
        keys, vals, n_in = eb_ref.window_sort_ref(ids, 0, V)
        assert n_in.item() == ids.numel()
        assert torch.equal(keys, ids.reshape(-1).sort(stable=True).values)

    def test_duplicates_keep_position_order(self):
        """One row read by every entry: the values are the positions in
        order, the keys all 0."""
        ids = torch.full((7, 3), 55, dtype=torch.int32)
        keys, vals, _ = eb_ref.window_sort_ref(ids, 55, 1)
        assert keys.tolist() == [0] * 21 and vals.tolist() == list(range(21))

    @pytest.mark.parametrize("row_lo,n_local", WINDOWS[:4])
    def test_wrapper_takes_the_plain_version_on_the_cpu(self, row_lo,
                                                        n_local):
        ids = torch.from_numpy(_ids((40, 2), V, 9, 2.0))
        before = eb_ops.window_sort_launches()
        got = eb_ops.window_sort(ids.long(), row_lo, n_local)
        want = eb_ref.window_sort_ref(ids, row_lo, n_local)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert eb_ops.window_sort_launches() == before

    def test_wrapper_refuses_other_devices(self):
        with pytest.raises(ValueError, match="meta"):
            eb_ops.window_sort(torch.zeros((2, 2), dtype=torch.int32,
                                           device="meta"), 0, 4)


class TestWindowBackwardPlain:
    """`embedding_bag_backward_window_ref`, through the preparation."""

    @pytest.mark.parametrize("row_lo,n_local", WINDOWS[:6])
    @pytest.mark.parametrize("bag,weighted", [(1, False), (3, True),
                                              (26, False)])
    def test_against_jax_grad(self, row_lo, n_local, bag, weighted):
        rng = np.random.default_rng(bag + row_lo)
        table = rng.standard_normal((V, 8)).astype(np.float32)
        ids = _ids((48, bag), V, bag + 7, 2.0)
        w = rng.standard_normal(ids.shape).astype(np.float32)
        g = rng.standard_normal((48, 8)).astype(np.float32)
        wj = w if weighted else np.ones_like(w)

        def f(tab):
            whole = jnp.concatenate([tab, jnp.zeros((200, 8))])
            return jnp.sum(jnp.sum(jnp.take(whole, ids, axis=0)
                                   * wj[..., None], axis=1) * g)
        full = np.asarray(jax.grad(f)(jnp.asarray(table)))
        want = np.zeros((n_local, 8), np.float32)
        real = full[row_lo:row_lo + n_local]
        want[:len(real)] = real
        got = eb_ref.embedding_bag_backward_window_ref(
            torch.from_numpy(ids), torch.from_numpy(g), row_lo, n_local,
            torch.from_numpy(w) if weighted else None)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)

    @pytest.mark.parametrize("row_lo,n_local", WINDOWS[:6])
    @pytest.mark.parametrize("weighted", [False, True])
    def test_bitwise_the_masked_index_add(self, row_lo, n_local, weighted):
        """The same bits as one `index_add_` of the masked entries in
        position order: the preparation moves no row's terms."""
        rng = np.random.default_rng(row_lo + weighted)
        ids = torch.from_numpy(_ids((300, 4), V, 3, 3.0))
        g = torch.from_numpy(rng.standard_normal((300, 16)).astype(
            np.float32))
        w = torch.from_numpy(rng.standard_normal((300, 4)).astype(
            np.float32)) if weighted else None
        flat = ids.reshape(-1).long()
        keep = (flat >= row_lo) & (flat < row_lo + n_local)
        terms = g.repeat_interleave(4, 0)
        if w is not None:
            terms = terms * w.reshape(-1, 1)
        want = torch.zeros((n_local, 16)).index_add_(
            0, flat[keep] - row_lo, terms[keep])
        got = eb_ref.embedding_bag_backward_window_ref(ids, g, row_lo,
                                                       n_local, w)
        assert torch.equal(got, want)

    def test_wrapper_on_the_cpu_is_the_plain_version(self):
        ids = torch.from_numpy(_ids((64, 2), V, 5, 2.0))
        g = torch.randn(64, 8, generator=torch.Generator().manual_seed(0))
        got = eb_ops.embedding_bag_backward_window(ids, g, 40, 40)
        want = eb_ref.embedding_bag_backward_window_ref(ids, g, 40, 40)
        assert torch.equal(got, want)


class TestWindowPlan:
    """The window passes' chunk plan, computed on the card from n_in, and
    the scratch and grid the wrapper sizes from the call's n."""

    @staticmethod
    def _bound(n: int) -> int:
        return min(eb_ops.CHUNKS, -(-n // eb_ops.TILE))

    @settings(max_examples=300, deadline=None)
    @given(st.integers(1, 3_000_000).flatmap(
        lambda n: st.tuples(st.just(n), st.integers(0, n))))
    def test_plan_of_n_in_fits_the_bound_of_n(self, n_and_n_in):
        n, n_in = n_and_n_in
        chunk, n_chunks = eb_ops.backward_plan(n_in)
        assert n_chunks <= self._bound(n)
        assert chunk * n_chunks >= n_in and chunk >= eb_ops.TILE

    @pytest.mark.parametrize("n,n_in", [(106_496, 9_029), (65_536 * 26,
                                                            65_536 * 26)])
    def test_train_batch_plans(self, n, n_in):
        """M-b's rank 0 (9,029 of 106,496 ids inside: 36 chunks of 256,
        the grid sized for 416) and the window [0, V) at train_batch (the
        whole-table plan, 4,218 chunks of 404)."""
        chunk, n_chunks = eb_ops.backward_plan(n_in)
        assert (chunk, n_chunks) == ((256, 36) if n_in < n else (404, 4218))
        assert self._bound(n) == (416 if n_in < n else eb_ops.CHUNKS)

    @pytest.mark.parametrize("n_local,passes", [
        (1, 1), (2, 1), (256, 1), (257, 2), (1 << 16, 2), ((1 << 16) + 1, 3),
        (2_110_176, 3), (33_762_816, 4), ((1 << 31) - 1, 4)])
    def test_sort_passes_cover_the_local_rows(self, n_local, passes):
        assert eb_ops.sort_passes(n_local) == passes
        assert (n_local - 1) >> (eb_ops.SORT_DIGIT_BITS * passes) == 0

    def test_sort_constants_match_the_source(self):
        """SORT_TILE, SORT_DIGIT_BITS and SORT_HEAD are the sort kernel's
        kTileKeys, kDigitBits and kStatus; the window passes' plan bound
        is the whole-table plan's (kChunks of kMinBlocks x kWarps)."""
        src = _build.sources()["embedding_bag_backward"].read_text()

        def const(pattern, text=src):
            return int(re.search(pattern, text)[1])
        threads = const(r"constexpr int kThreads = (\d+);")
        items = const(r"constexpr int kItems = (\d+);")
        assert eb_ops.SORT_TILE == threads * items
        assert eb_ops.SORT_DIGIT_BITS == const(
            r"constexpr int kDigitBits = (\d+);")
        assert 1 << eb_ops.SORT_DIGIT_BITS == threads
        hist = const(r"constexpr int kHist = (\d+);")
        passes = const(r"constexpr int kMaxPasses = (\d+);")
        assert eb_ops.SORT_HEAD == hist + passes * threads
        assert passes * eb_ops.SORT_DIGIT_BITS == 32
        assert re.search(r"constexpr int64_t kChunks = 132LL \* kMinBlocks "
                         r"\* kWarps;", src)
