"""Paper-scale dataset layer: SNAP loaders, cached binaries, scale-free
generator (host numpy; a copy of `repro.graph.datasets`).

Three layers, as in the reference:

  * `load_snap_edgelist` — SNAP-style text edge lists ("# comment" headers,
    whitespace-separated endpoint pairs, optional .gz), parsed in bounded
    line blocks so peak host memory during ingestion is O(block), not
    O(file). Produces a canonical `Graph` via `from_undirected_edges`.
  * `save_graph_cache` / `load_graph_cache` — the preprocessed binary: an
    UNCOMPRESSED npz holding a versioned int64 header [version, n, m] plus
    the canonical src/dst/deg arrays, np.memmap'd member by member on load
    (`_mmap_npz`). The layout and `CACHE_FORMAT_VERSION` are the
    reference's, so a file either package writes loads in the other; the
    default directory (`$REPRO_DATASET_CACHE`) is shared too. Mapped arrays
    are READ-ONLY views of the file: the serving registry copies a mapped
    graph before anything mutates or uploads from it.
  * `chung_lu` — Chung-Lu-style scale-free generator with the reference's
    parameters and seeds (byte-identical graphs). `SCALE_FAMILIES` +
    `scale_dataset` name the operating points; `scale_dataset` goes
    through the cache.
"""
from __future__ import annotations

import gzip
import io
import itertools
import os
import zipfile
from pathlib import Path
from typing import Callable, Iterator

import numpy as np

from repro_torch.graph.structure import Graph

__all__ = [
    "CACHE_FORMAT_VERSION",
    "load_snap_edgelist",
    "iter_snap_edge_blocks",
    "save_graph_cache",
    "load_graph_cache",
    "cached_graph",
    "default_cache_dir",
    "chung_lu",
    "SCALE_FAMILIES",
    "scale_dataset",
]

# Bump when the npz layout changes: readers treat any other version as a
# cache miss. It is the reference's number: the two packages share files.
CACHE_FORMAT_VERSION = 1


# ---------------------------------------------------------------------------
# SNAP edge-list ingestion
# ---------------------------------------------------------------------------

def _open_text(path):
    path = str(path)
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "r")


def iter_snap_edge_blocks(path, block_lines: int = 1 << 20
                          ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Yield (u, v) int64 endpoint blocks from a SNAP-style edge list.

    Lines starting with '#' or '%' are headers/comments; data lines are
    whitespace-separated with the two endpoints in the first two columns
    (extra columns — weights, timestamps — are ignored). Reading in blocks
    bounds peak host memory during ingestion to O(block_lines) regardless
    of file size; `.gz` paths stream through gzip.
    """
    with _open_text(path) as f:
        while True:
            lines = list(itertools.islice(f, block_lines))
            if not lines:
                return
            kept = [ln for ln in lines
                    if ln.strip() and not ln.lstrip().startswith(("#", "%"))]
            if not kept:
                continue
            arr = np.loadtxt(io.StringIO("".join(kept)), dtype=np.int64,
                             usecols=(0, 1), ndmin=2)
            yield arr[:, 0], arr[:, 1]


def load_snap_edgelist(path, n: int | None = None,
                       block_lines: int = 1 << 20) -> Graph:
    """Parse a SNAP edge list into a canonical undirected `Graph`.

    n defaults to max(vertex id) + 1. Duplicate edges, self loops and
    direction are all normalized by `Graph.from_undirected_edges` (the
    same canonical form every engine builds from).
    """
    us, vs = [], []
    for u, v in iter_snap_edge_blocks(path, block_lines=block_lines):
        us.append(u)
        vs.append(v)
    if not us:
        raise ValueError(f"no edges found in {path}")
    u = np.concatenate(us)
    v = np.concatenate(vs)
    if u.size and u.min() < 0 or v.size and v.min() < 0:
        raise ValueError(f"negative vertex id in {path}")
    n_seen = int(max(u.max(), v.max())) + 1
    if n is None:
        n = n_seen
    elif n < n_seen:
        raise ValueError(f"n={n} but {path} has vertex id {n_seen - 1}")
    return Graph.from_undirected_edges(n, u, v)


# ---------------------------------------------------------------------------
# Preprocessed binary cache (versioned, mmap-friendly npz)
# ---------------------------------------------------------------------------

def save_graph_cache(path, g: Graph) -> None:
    """Write the canonical arrays as an UNCOMPRESSED npz with a versioned
    header. Uncompressed members are what makes `load_graph_cache` able to
    memmap the arrays in place instead of decompress-copying them."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    header = np.asarray([CACHE_FORMAT_VERSION, g.n, g.m], np.int64)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, header=header, src=g.src, dst=g.dst,
                 deg=g.deg.astype(np.int64))
    os.replace(tmp, path)   # atomic: a crashed writer never leaves a torn cache


def _mmap_npz(path) -> dict[str, np.ndarray] | None:
    """Map every member of an uncompressed npz as a read-only np.memmap.

    np.load only mmaps bare .npy files; for npz it decompress-copies each
    member. Stored (uncompressed) zip members are contiguous on disk, so we
    parse each member's local header for its data offset, then the npy
    header for dtype/shape, and memmap the raw buffer directly. Returns
    None whenever the file deviates from that layout (compressed members,
    fortran order, exotic npy versions) — callers fall back to np.load.
    """
    try:
        out: dict[str, np.ndarray] = {}
        with zipfile.ZipFile(path) as zf, open(path, "rb") as f:
            for info in zf.infolist():
                if info.compress_type != zipfile.ZIP_STORED:
                    return None
                f.seek(info.header_offset)
                local = f.read(30)
                if local[:4] != b"PK\x03\x04":
                    return None
                fn_len = int.from_bytes(local[26:28], "little")
                extra_len = int.from_bytes(local[28:30], "little")
                f.seek(info.header_offset + 30 + fn_len + extra_len)
                version = np.lib.format.read_magic(f)
                if version == (1, 0):
                    shape, fortran, dtype = \
                        np.lib.format.read_array_header_1_0(f)
                elif version == (2, 0):
                    shape, fortran, dtype = \
                        np.lib.format.read_array_header_2_0(f)
                else:
                    return None
                if fortran or dtype.hasobject:
                    return None
                name = info.filename
                if name.endswith(".npy"):
                    name = name[:-4]
                out[name] = np.memmap(path, dtype=dtype, mode="r",
                                      offset=f.tell(), shape=shape)
        return out
    except (OSError, ValueError, zipfile.BadZipFile):
        return None


def load_graph_cache(path, mmap: bool = True) -> Graph | None:
    """Load a cached graph; None on any miss (absent, stale version, torn
    file) so the caller regenerates. With mmap=True (default) the edge
    arrays are memory-mapped out of the npz — the open is O(1) and pages
    fault in lazily as engines consume them."""
    path = Path(path)
    if not path.exists():
        return None
    arrays = _mmap_npz(path) if mmap else None
    if arrays is None:
        try:
            with np.load(path) as z:
                arrays = {k: z[k] for k in z.files}
        except (OSError, ValueError, zipfile.BadZipFile):
            return None
    header = arrays.get("header")
    if header is None or header.shape != (3,) or \
            int(header[0]) != CACHE_FORMAT_VERSION:
        return None
    n, m = int(header[1]), int(header[2])
    src, dst = arrays.get("src"), arrays.get("dst")
    if src is None or dst is None or src.shape != (m,) or dst.shape != (m,):
        return None
    return Graph(n=n, src=src, dst=dst)


def default_cache_dir() -> Path:
    """$REPRO_DATASET_CACHE, or ~/.cache/repro_pagerank/datasets."""
    env = os.environ.get("REPRO_DATASET_CACHE")
    if env:
        return Path(env)
    return Path.home() / ".cache" / "repro_pagerank" / "datasets"


def cached_graph(name: str, builder: Callable[[], Graph],
                 cache_dir=None, mmap: bool = True) -> Graph:
    """builder() through the preprocessed-binary cache: hit -> mmap load,
    miss (absent or stale CACHE_FORMAT_VERSION) -> build, save, return."""
    cache_dir = default_cache_dir() if cache_dir is None else Path(cache_dir)
    path = cache_dir / f"{name}.v{CACHE_FORMAT_VERSION}.npz"
    g = load_graph_cache(path, mmap=mmap)
    if g is not None:
        return g
    g = builder()
    save_graph_cache(path, g)
    return g



# ---------------------------------------------------------------------------
# Chung-Lu scale-free generator
# ---------------------------------------------------------------------------

def chung_lu(n: int, avg_deg: float = 16.0, exponent: float = 2.0,
             seed: int = 0, i0: int = 10) -> Graph:
    """Chung-Lu-style scale-free graph: expected degree of vertex i is
    proportional to (i + i0)^(-1/(exponent-1)), giving a degree power law
    with tail exponent ~`exponent`. i0 caps the top hub's share (smaller i0
    -> heavier hubs). Both endpoints of each of the n*avg_deg/2 undirected
    samples are drawn by inverse-CDF searchsorted — O(m log n), no python
    loop — then canonicalized (dedup, self-loop drop, symmetrize), so the
    realized average degree lands slightly under `avg_deg`.
    """
    rng = np.random.default_rng(seed)
    w = (np.arange(n, dtype=float) + i0) ** (-1.0 / (exponent - 1.0))
    cdf = np.cumsum(w)
    cdf /= cdf[-1]
    m = int(n * avg_deg / 2)
    u = np.searchsorted(cdf, rng.random(m)).astype(np.int64)
    v = np.searchsorted(cdf, rng.random(m)).astype(np.int64)
    return Graph.from_undirected_edges(n, u, v)


# Named operating points of the reference's scale benchmarks, with the
# same parameters (and so the same graphs).
SCALE_FAMILIES: dict[str, Callable[[], Graph]] = {
    "chunglu-100k": lambda: chung_lu(100_000, avg_deg=16.0, exponent=2.0),
    "chunglu-200k": lambda: chung_lu(200_000, avg_deg=16.0, exponent=2.0),
    "chunglu-1m": lambda: chung_lu(1_000_000, avg_deg=16.0, exponent=2.0),
}



def scale_dataset(name: str, cache_dir=None) -> Graph:
    """A named SCALE_FAMILIES graph through the preprocessed-binary cache
    (hit: the arrays are memory-mapped, read-only)."""
    if name not in SCALE_FAMILIES:
        raise KeyError(f"unknown scale dataset {name!r}; "
                       f"known: {sorted(SCALE_FAMILIES)}")
    return cached_graph(name, SCALE_FAMILIES[name], cache_dir=cache_dir)
