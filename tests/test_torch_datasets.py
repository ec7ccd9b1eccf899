"""The port's dataset layer (`repro_torch.graph.datasets`) against the
reference's (`repro.graph.datasets`).

The SNAP loader must give equal arrays on every case of the reference's
suite (comments, gzip, duplicates, self loops, explicit n, bad input);
the cache format is shared, so a file written by either package loads in
the other with equal arrays (the files are byte-identical). A mapped
graph's arrays are read-only views of the file: registering one must copy
first, leave the file untouched, and serve what the fresh graph serves.
"""
import gzip
import hashlib
import os
import warnings

import numpy as np
import pytest
import torch

from repro.graph import datasets as jds

from repro_torch.graph import datasets as tds
from repro_torch.graph.datasets import (CACHE_FORMAT_VERSION, cached_graph,
                                        chung_lu, load_graph_cache,
                                        load_snap_edgelist, save_graph_cache,
                                        scale_dataset)
from repro_torch.graph.ops import EdgeSlots, device_graph, upload
from repro_torch.serve import GraphRegistry, PageRankService, PPRQuery

SNAP_TEXT = """\
# Directed graph (each unordered pair of nodes is saved once)
# Nodes: 5 Edges: 6
% a percent comment, some mirrors use these
0\t1
1\t0
1 2
2 3
3 3
3 4
"""


def _assert_same_graph(a, b):
    assert a.n == b.n and a.m == b.m
    np.testing.assert_array_equal(np.asarray(a.src), np.asarray(b.src))
    np.testing.assert_array_equal(np.asarray(a.dst), np.asarray(b.dst))


def _digest(path) -> str:
    return hashlib.sha256(open(path, "rb").read()).hexdigest()


class TestSnapLoaderParity:
    @pytest.mark.parametrize("gz", [False, True])
    def test_comments_dups_self_loops(self, tmp_path, gz):
        path = tmp_path / ("toy.txt.gz" if gz else "toy.txt")
        if gz:
            with gzip.open(path, "wt") as f:
                f.write(SNAP_TEXT)
        else:
            path.write_text(SNAP_TEXT)
        g = load_snap_edgelist(str(path))
        _assert_same_graph(g, jds.load_snap_edgelist(str(path)))
        assert g.n == 5 and g.validate_symmetric()
        np.testing.assert_array_equal(g.deg, [1, 2, 2, 2, 1])

    def test_explicit_n_pads_isolated_vertices(self, tmp_path):
        path = tmp_path / "toy.txt"
        path.write_text("0 1\n")
        g = load_snap_edgelist(str(path), n=4)
        _assert_same_graph(g, jds.load_snap_edgelist(str(path), n=4))
        assert g.deg[2] == 1 and g.deg[3] == 1

    @pytest.mark.parametrize("block_lines", [1, 3, 1 << 20])
    def test_random_edge_list_in_blocks(self, tmp_path, block_lines):
        rng = np.random.default_rng(block_lines)
        edges = rng.integers(0, 300, size=(2000, 2))
        lines = ["# header"] + [f"{u} {v} {w}" for (u, v), w in
                                zip(edges, rng.integers(0, 9, 2000))]
        path = tmp_path / "edges.txt"
        path.write_text("\n".join(lines) + "\n")
        g = load_snap_edgelist(str(path), block_lines=block_lines)
        _assert_same_graph(g, jds.load_snap_edgelist(
            str(path), block_lines=block_lines))
        blocks = list(tds.iter_snap_edge_blocks(str(path), block_lines))
        ref = list(jds.iter_snap_edge_blocks(str(path), block_lines))
        assert len(blocks) == len(ref)
        for (u, v), (ru, rv) in zip(blocks, ref):
            np.testing.assert_array_equal(u, ru)
            np.testing.assert_array_equal(v, rv)

    @pytest.mark.parametrize("text,kw,match", [
        ("# nothing\n", {}, "no edges"),
        ("0 5\n", {"n": 3}, "vertex id"),
        ("-1 2\n", {}, "negative"),
    ])
    def test_bad_input_raises_as_the_reference(self, tmp_path, text, kw,
                                               match):
        path = tmp_path / "bad.txt"
        path.write_text(text)
        with pytest.raises(ValueError, match=match):
            load_snap_edgelist(str(path), **kw)
        with pytest.raises(ValueError, match=match):
            jds.load_snap_edgelist(str(path), **kw)


class TestCacheCrossPackage:
    @pytest.mark.parametrize("writer", ["port", "reference"])
    @pytest.mark.parametrize("mmap", [True, False])
    def test_either_writes_both_read(self, tmp_path, writer, mmap):
        g = chung_lu(2_000, avg_deg=8.0, seed=3)
        path = str(tmp_path / "g.npz")
        (save_graph_cache if writer == "port"
         else jds.save_graph_cache)(path, g)
        gt = load_graph_cache(path, mmap=mmap)
        gj = jds.load_graph_cache(path, mmap=mmap)
        _assert_same_graph(gt, g)
        _assert_same_graph(gj, g)

    def test_files_are_byte_identical(self, tmp_path):
        g = chung_lu(1_500, avg_deg=6.0, seed=2)
        save_graph_cache(tmp_path / "a.npz", g)
        jds.save_graph_cache(tmp_path / "b.npz", g)
        assert _digest(tmp_path / "a.npz") == _digest(tmp_path / "b.npz")
        assert CACHE_FORMAT_VERSION == jds.CACHE_FORMAT_VERSION

    def test_cached_graph_hits_a_reference_file(self, tmp_path):
        calls = []

        def build():
            calls.append(1)
            return chung_lu(500, avg_deg=6.0, seed=0)

        jds.cached_graph("toy", build, cache_dir=str(tmp_path))
        g = cached_graph("toy", build, cache_dir=str(tmp_path))
        assert len(calls) == 1     # the port read the reference's file
        _assert_same_graph(g, chung_lu(500, avg_deg=6.0, seed=0))

    def test_version_mismatch_regenerates(self, tmp_path, monkeypatch):
        calls = []

        def build():
            calls.append(1)
            return chung_lu(500, avg_deg=6.0, seed=0)

        cached_graph("toy", build, cache_dir=str(tmp_path))
        cached_graph("toy", build, cache_dir=str(tmp_path))
        assert len(calls) == 1
        monkeypatch.setattr(tds, "CACHE_FORMAT_VERSION",
                            CACHE_FORMAT_VERSION + 1)
        cached_graph("toy", build, cache_dir=str(tmp_path))
        assert len(calls) == 2

    def test_corrupt_file_returns_none(self, tmp_path):
        path = tmp_path / "bad.npz"
        path.write_bytes(b"this is not an npz archive")
        assert load_graph_cache(str(path)) is None
        assert load_graph_cache(str(tmp_path / "absent.npz")) is None

    def test_default_cache_dir_env(self, tmp_path, monkeypatch):
        monkeypatch.setenv("REPRO_DATASET_CACHE", str(tmp_path))
        assert tds.default_cache_dir() == jds.default_cache_dir() == tmp_path

    def test_scale_dataset_cached_and_equal(self, tmp_path):
        g = scale_dataset("chunglu-100k", cache_dir=str(tmp_path))
        fresh = chung_lu(100_000, avg_deg=16.0, exponent=2.0)
        _assert_same_graph(g, fresh)
        assert any(f.endswith(".npz") for f in os.listdir(tmp_path))
        mapped = scale_dataset("chunglu-100k", cache_dir=str(tmp_path))
        _assert_same_graph(mapped, fresh)
        assert not mapped.src.flags.writeable
        _assert_same_graph(jds.scale_dataset("chunglu-100k",
                                             cache_dir=str(tmp_path)), fresh)
        with pytest.raises(KeyError):
            scale_dataset("no-such-family")


class TestMappedGraphRegistration:
    def _mapped(self, tmp_path, n=3_000):
        g = chung_lu(n, avg_deg=8.0, seed=5)
        path = tmp_path / "g.npz"
        save_graph_cache(path, g)
        mapped = load_graph_cache(path)
        assert not mapped.src.flags.writeable
        assert not mapped.dst.flags.writeable
        return g, mapped, path

    @pytest.mark.parametrize("engine", ["auto", "coo", "hub_tail", "fused"])
    def test_register_copies_and_never_touches_the_file(self, tmp_path,
                                                        engine):
        g, mapped, path = self._mapped(tmp_path)
        digest, mtime = _digest(path), os.stat(path).st_mtime_ns
        reg = GraphRegistry(device="cpu", engine=engine)
        with warnings.catch_warnings():
            # torch warns when it would alias a non-writable array
            warnings.simplefilter("error", UserWarning)
            rg = reg.register("mapped", mapped)
            reg.register("fresh", g)
        assert rg.host.src.flags.writeable
        assert not np.shares_memory(rg.host.src, mapped.src)
        # updates mutate the registry's copies, never the file
        for k in range(3):
            reg.apply_updates("mapped", insert=[(k, g.n - 1 - k)])
            reg.apply_updates("fresh", insert=[(k, g.n - 1 - k)])
        assert _digest(path) == digest
        assert os.stat(path).st_mtime_ns == mtime
        _assert_same_graph(load_graph_cache(path), g)
        a, b = reg.get("mapped"), reg.get("fresh")
        for name in ("src", "dst", "w", "inv_deg"):
            assert torch.equal(getattr(a.dg, name), getattr(b.dg, name))

    def test_mapped_graph_serves_what_the_fresh_graph_serves(self,
                                                             tmp_path):
        g, mapped, _ = self._mapped(tmp_path)
        answers = []
        for graph in (mapped, g):
            reg = GraphRegistry(device="cpu")
            reg.register("g", graph)
            svc = PageRankService(reg, max_batch=8, max_top_k=8,
                                  adaptive=True)
            for i in range(8):
                svc.submit(PPRQuery(qid=i, graph="g", seeds=(i * 37,)))
            answers.append(svc.run_until_drained())
        for qid, r in answers[0].items():
            np.testing.assert_array_equal(r.indices, answers[1][qid].indices)
            np.testing.assert_array_equal(r.scores, answers[1][qid].scores)

    def test_upload_copies_read_only_arrays(self, tmp_path):
        _, mapped, _ = self._mapped(tmp_path)
        with warnings.catch_warnings():
            warnings.simplefilter("error", UserWarning)
            t = upload(mapped.src, torch.int32, "cpu")
        assert t.numpy().flags.writeable
        assert not np.shares_memory(t.numpy(), mapped.src)
        with warnings.catch_warnings():
            warnings.simplefilter("error", UserWarning)
            dg = device_graph(mapped, device="cpu")
        np.testing.assert_array_equal(dg.src.numpy(), mapped.src)


class TestChunkedIngest:
    @pytest.mark.parametrize("chunk", [1, 1000, 7777, 1 << 30])
    def test_chunked_upload_equals_one_shot(self, chunk):
        g = chung_lu(4_000, avg_deg=8.0, seed=1)
        one = device_graph(g, pad_edges_to=1 << 16, device="cpu")
        part = device_graph(g, pad_edges_to=1 << 16, device="cpu",
                            chunk_edges=chunk)
        for name in ("src", "dst", "w", "inv_deg"):
            assert torch.equal(getattr(one, name), getattr(part, name))
        es = EdgeSlots.from_graph(g, cap=1 << 16)
        a, b = es.to_device(device="cpu"), \
            es.to_device(device="cpu", chunk_edges=chunk)
        for name in ("src", "dst", "w", "inv_deg"):
            assert torch.equal(getattr(a, name), getattr(b, name))
        # neither aliases the mutable mirror
        assert not np.shares_memory(b.src.numpy(), es.src)
        assert not np.shares_memory(b.w.numpy(), es.w64)

    def test_registry_ingest_chunk_edges(self):
        g = chung_lu(4_000, avg_deg=8.0, seed=1)
        ra = GraphRegistry(device="cpu")
        rb = GraphRegistry(device="cpu", ingest_chunk_edges=4096)
        a, b = ra.register("g", g), rb.register("g", g)
        for name in ("src", "dst", "w", "inv_deg"):
            assert torch.equal(getattr(a.dg, name), getattr(b.dg, name))
        rb.apply_updates("g", insert=[(0, 3999)])
        ra.apply_updates("g", insert=[(0, 3999)])
        for name in ("src", "dst", "w", "inv_deg"):
            assert torch.equal(getattr(a.dg, name), getattr(b.dg, name))


class TestChungLuParity:
    @pytest.mark.parametrize("n,seed", [(500, 0), (3_000, 7), (20_000, 3)])
    def test_byte_identical(self, n, seed):
        _assert_same_graph(chung_lu(n, avg_deg=8.0, seed=seed),
                           jds.chung_lu(n, avg_deg=8.0, seed=seed))
