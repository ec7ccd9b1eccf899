"""Message-passing primitives for the PageRank solve, in PyTorch.

Counterpart of `repro.graph.ops`: the COO transition product y = P x with
P = A D^{-1} is one gather + one multiply + one `index_add_` over the edge
list. The reference leaves this to XLA (`jax.ops.segment_sum`), not to a
Pallas kernel, so the port uses torch ops here.

Edge updates go through `EdgeSlots`, a host mirror of a padded
DeviceGraph's slots: `apply_delta` turns an `EdgeDelta` into a
`SlotPatch`, and `patch_device_graph` writes it into the SAME device
tensors in place, so every engine holding them sees the update.
`chunk_edges` bounds the host memory of a registration: the edge arrays
go to the device in chunks, each converted on the host and copied into
its slice of one preallocated device tensor. The GNN aggregations
(`aggregate`, `edge_softmax`, `degree_normalize`) sit on the segment
reductions `segment_sum` / `segment_max` / `segment_min`, the port's
counterparts of `jax.ops.segment_*`: empty segments hold 0, -inf and +inf,
and ties split the gradient evenly, as in JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.graph.structure import Graph

__all__ = ["DeviceGraph", "device_graph", "check_int32_range",
           "CapacityError", "edge_matmul", "spmv",
           "spmm", "as_torch_dtype", "upload", "SlotPatch", "EdgeSlots",
           "patch_device_graph", "segment_sum", "segment_max",
           "segment_min", "aggregate", "edge_softmax", "degree_normalize"]


class DeviceGraph:
    """Device-resident COO graph + precomputed 1/deg (the paper's P).

    `w` is the [m] per-edge weight of P: 1/deg[src] for real edges, 0 for
    the zero-weight padding edges the serving registry appends to keep
    shapes stable across updates. Hand-built graphs may pass w=None and
    fall back to gathering inv_deg[src] per call. `src`/`dst` are int32,
    as in the reference.
    """

    def __init__(self, n: int, src: torch.Tensor, dst: torch.Tensor,
                 inv_deg: torch.Tensor, w: torch.Tensor | None = None):
        self.n = n
        self.src = src
        self.dst = dst
        self.inv_deg = inv_deg
        self.w = w
        self._csr = None

    @property
    def device(self) -> torch.device:
        return self.src.device

    def csr(self):
        """Sorted-src CSR view (deg, row_start, dst_sorted), int32 tensors
        on the graph's device, built on the host once and cached on the
        instance (`patch_device_graph` drops it). Zero-weight padding edges
        are excluded so sampling never walks them."""
        if self._csr is None:
            src = self.src.cpu().numpy()
            dst = self.dst.cpu().numpy()
            if self.w is not None:
                keep = self.w.cpu().numpy() > 0
                src, dst = src[keep], dst[keep]
            deg = np.bincount(src, minlength=self.n).astype(np.int32)
            row_start = np.concatenate(
                [np.zeros(1, np.int32), np.cumsum(deg, dtype=np.int32)[:-1]])
            order = np.argsort(src, kind="stable")
            dev = self.device
            self._csr = (upload(deg, torch.int32, dev),
                         upload(row_start, torch.int32, dev),
                         upload(dst[order], torch.int32, dev))
        return self._csr


_INT32_MAX = np.iinfo(np.int32).max


class CapacityError(ValueError):
    """A graph does not fit the device arrays' int32 indices. A ValueError,
    as the reference raises; its own class lets the autotuner tell an
    infeasible candidate from a failure."""


def check_int32_range(n: int, nnz: int, what: str = "graph") -> None:
    """Fail loudly where an index would silently wrap in the int32 edge
    arrays (vertex ids and edge slot ids are stored as int32).

    Raises:
        CapacityError: n or nnz exceeds the int32 range.
    """
    if n > _INT32_MAX:
        raise CapacityError(
            f"{what}: n={n} exceeds int32 range ({_INT32_MAX}); "
            "vertex ids are stored as int32 device arrays")
    if nnz > _INT32_MAX:
        raise CapacityError(
            f"{what}: nnz={nnz} exceeds int32 range ({_INT32_MAX}); "
            "edge slot ids are stored as int32 device arrays")


def as_torch_dtype(dtype) -> torch.dtype:
    """torch.dtype from a torch dtype or its name ("float32", "bfloat16")."""
    if isinstance(dtype, torch.dtype):
        return dtype
    out = getattr(torch, str(dtype), None)
    if not isinstance(out, torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return out


def upload(arr: np.ndarray, dtype: torch.dtype, device,
           chunk: int | None = None) -> torch.Tensor:
    """Host->device transfer, converted to `dtype` on the host first.

    On the CPU with a matching dtype the result SHARES `arr`'s buffer
    (`torch.from_numpy` is zero-copy): callers whose array is mutated later
    (the `EdgeSlots` mirror) pass a copy. A read-only array (a memory-mapped
    dataset cache) is copied first: torch would alias the file.

    chunk: convert and copy at most this many elements at a time into one
    preallocated tensor, so the extra host memory of the conversion is
    O(chunk) instead of O(len(arr)) (None or 0 = one shot).
    """
    if chunk and arr.ndim == 1 and arr.shape[0] > chunk:
        out = torch.empty(arr.shape[0], dtype=dtype, device=device)
        for s in range(0, arr.shape[0], chunk):
            out[s:s + chunk].copy_(upload(arr[s:s + chunk], dtype, "cpu"))
        return out
    if not arr.flags.writeable:
        arr = np.array(arr)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(dtype).to(device)


def device_graph(g: Graph, dtype=torch.float32,
                 pad_edges_to: int | None = None, weight_dtype=None,
                 device=None, chunk_edges: int | None = None) -> DeviceGraph:
    """Build the device-resident COO graph.

    w = 1/deg[src] is computed exactly in float64 on the host, then cast
    to `weight_dtype` (default `dtype`; bfloat16 halves the weight array
    and the product upcasts before the multiply). `pad_edges_to` appends
    zero-weight (0 -> 0) padding edges. `device` None means CUDA (raises
    without a GPU). `chunk_edges` transfers the edge arrays in chunks of
    that many edges (see `upload`; None = one shot).
    """
    dev = resolve_device(device)
    dtype = as_torch_dtype(dtype)
    wdtype = dtype if weight_dtype is None else as_torch_dtype(weight_dtype)
    check_int32_range(g.n, g.m if pad_edges_to is None else pad_edges_to,
                      what="device_graph")
    inv_deg = 1.0 / np.maximum(g.deg, 1).astype(float)   # exact host 1/deg
    src, dst, w = g.src, g.dst, inv_deg[g.src]
    if pad_edges_to is not None and pad_edges_to > g.m:
        pad = pad_edges_to - g.m
        zeros = np.zeros(pad, np.int32)
        src = np.concatenate([src, zeros])
        dst = np.concatenate([dst, zeros])
        w = np.concatenate([w, np.zeros(pad)])
    return DeviceGraph(n=g.n, src=upload(src, torch.int32, dev, chunk_edges),
                       dst=upload(dst, torch.int32, dev, chunk_edges),
                       inv_deg=upload(inv_deg, dtype, dev),
                       w=upload(w, wdtype, dev, chunk_edges))


class SlotPatch:
    """The slots an edge-update batch rewrites, with their new values.

    Produced host-side by `EdgeSlots.apply_delta`, consumed by
    `patch_device_graph`. `slots`/`src`/`dst`/`w` cover every edge-array slot
    that changes (freed slots zeroed back to padding, allocated slots
    carrying the new edges, and every surviving slot whose source vertex
    changed degree — its folded 1/deg weight moved); `rows`/`inv_deg` are the
    touched rows of the per-vertex inverse-degree vector.
    """

    __slots__ = ("slots", "src", "dst", "w", "rows", "inv_deg", "mirror")

    def __init__(self, slots, src, dst, w, rows, inv_deg, mirror=None):
        self.slots = slots        # [s] int64
        self.src = src            # [s] int32
        self.dst = dst            # [s] int32
        self.w = w                # [s] float64 (cast to device dtype at set)
        self.rows = rows          # [t] int64
        self.inv_deg = inv_deg    # [t] float64
        self.mirror = mirror      # the EdgeSlots this patch came from


def _sorted_delete(arr: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """arr without the rows at (sorted, unique) positions `pos` — a chain of
    contiguous block copies instead of np.delete's generic masking (hot:
    every update batch rewrites the sorted edge-key table, and the batch is
    tiny next to the table)."""
    if pos.size == 0:
        return arr
    pieces = [arr[s:e] for s, e in
              zip(np.concatenate([[0], pos + 1]),
                  np.concatenate([pos, [arr.shape[0]]]))]
    return np.concatenate(pieces)


def _sorted_insert(arr: np.ndarray, pos: np.ndarray,
                   vals: np.ndarray) -> np.ndarray:
    """arr with vals[i] inserted before original position pos[i] (pos sorted
    ascending, ties keep vals order — np.insert semantics), as a chain of
    contiguous block copies."""
    if pos.size == 0:
        return arr
    bounds = np.concatenate([[0], pos, [arr.shape[0]]])
    pieces = []
    for i in range(pos.size):
        pieces.append(arr[bounds[i]:bounds[i + 1]])
        pieces.append(vals[i:i + 1])
    pieces.append(arr[bounds[pos.size]:])
    return np.concatenate(pieces)


class EdgeSlots:
    """Host-side mirror of a padded DeviceGraph's edge slots.

    The serving registry keeps one per registered graph so an edge-update
    batch can be applied as a *patch* — rewrite only the affected slots of
    the padded device arrays — instead of the full O(m log m) host rebuild +
    device re-upload. Invariants mirrored from `Graph.from_undirected_edges`
    + `device_graph`:

      * every undirected edge occupies exactly two directed slots (lo->hi
        and hi->lo); self loops (the isolated-vertex patch that keeps P
        column-stochastic) occupy one;
      * padding slots are (src=0, dst=0, w=0) — zero weight keeps them out
        of every `index_add_` sum and out of the CSR;
      * w[slot] = 1/max(deg, 1) of the slot's source vertex, computed in
        float64 and cast at device transfer, so a patched array is
        bit-identical to a freshly built one.

    The undirected edge table (`ekeys` sorted, `eslots` aligned) is kept
    sorted *incrementally* (searchsorted + block-memcpy insert/delete), so
    a batch costs O(batch log m + cap) — no sort over the edge set. The
    free list stays sorted the same way, allocation takes its TAIL (highest
    slots first — O(1) slicing) and freed slots are zeroed and merged back
    in place, which keeps the whole state machine deterministic:
    insert-then-delete of the same batch restores every array bit-for-bit.
    """

    def __init__(self, n: int, cap: int, src, dst, w64, live, deg, iso_slot,
                 ekeys, eslots, free):
        self.n = n
        self.cap = cap
        self.src = src            # [cap] int32
        self.dst = dst            # [cap] int32
        self.w64 = w64            # [cap] float64 exact weights (0 = padding)
        self.live = live          # [cap] bool
        self.deg = deg            # [n] int64 undirected degree, loops excluded
        self.iso_slot = iso_slot  # [n] int64 self-loop slot, -1 if none
        self.ekeys = ekeys        # [m_u] int64 sorted canonical keys
        self.eslots = eslots      # [m_u, 2] int64 (lo->hi, hi->lo) slots
        self.free = free          # sorted int64 array of dead slots

    @classmethod
    def from_graph(cls, g: Graph, cap: int | None = None) -> "EdgeSlots":
        """Build the mirror for a graph laid out like `device_graph(g,
        pad_edges_to=cap)`. Raises ValueError if the graph does not follow
        the `from_undirected_edges` contract (paired directions, self loops
        only on otherwise-isolated vertices) — callers then fall back to
        full rebuilds for that graph."""
        n, m = g.n, g.m
        cap = m if cap is None else cap
        if cap < m:
            raise ValueError(f"cap {cap} < edge count {m}")
        check_int32_range(n, cap, what="EdgeSlots")
        src = np.zeros(cap, np.int32)
        dst = np.zeros(cap, np.int32)
        src[:m] = g.src
        dst[:m] = g.dst
        live = np.zeros(cap, bool)
        live[:m] = True
        loop = src[:m] == dst[:m]
        deg = np.bincount(g.src[~loop], minlength=n).astype(np.int64)
        loop_v = src[:m][loop]
        if np.unique(loop_v).size != loop_v.size or np.any(deg[loop_v] > 0):
            raise ValueError("self loops must be unique and only on "
                             "otherwise-isolated vertices")
        iso_slot = np.full(n, -1, np.int64)
        iso_slot[loop_v] = np.flatnonzero(loop)
        fwd = np.flatnonzero(src[:m] < dst[:m])
        rev = np.flatnonzero(src[:m] > dst[:m])
        kf = src[fwd].astype(np.int64) * n + dst[fwd]
        kr = dst[rev].astype(np.int64) * n + src[rev]
        of, orr = np.argsort(kf), np.argsort(kr)
        kf, kr = kf[of], kr[orr]
        if kf.size != kr.size or not np.array_equal(kf, kr) or \
                np.any(kf[1:] == kf[:-1]):
            raise ValueError("edges must be symmetrized and deduplicated")
        inv = 1.0 / np.maximum(deg, 1)
        # jaxlint: disable=JL003 -- EdgeSlots exact-weight contract, cast at transfer
        w64 = np.zeros(cap, np.float64)
        w64[:m] = inv[src[:m]]
        return cls(n=n, cap=cap, src=src, dst=dst, w64=w64, live=live,
                   deg=deg, iso_slot=iso_slot, ekeys=kf,
                   eslots=np.stack([fwd[of], rev[orr]], axis=1),
                   free=np.arange(m, cap, dtype=np.int64))

    def to_device(self, dtype=torch.float32, weight_dtype=None,
                  device=None, chunk_edges: int | None = None) -> DeviceGraph:
        """DeviceGraph over the mirror: identical tensors to
        `device_graph(g, pad_edges_to=cap)` on the same graph, the weights
        cast the same way.

        src/dst go over as private COPIES: on the CPU `torch.from_numpy`
        shares the numpy buffer, and the mirror mutates its arrays in place
        on every `apply_delta`, so an aliased device graph would drift
        silently. With `chunk_edges` the chunked transfer copies chunk by
        chunk instead (see `upload`)."""
        dev = resolve_device(device)
        dtype = as_torch_dtype(dtype)
        wdtype = dtype if weight_dtype is None \
            else as_torch_dtype(weight_dtype)
        inv = 1.0 / np.maximum(self.deg, 1)
        if chunk_edges and self.cap > chunk_edges:
            # every chunk is converted into a fresh tensor: nothing aliases
            src, dst, w64 = self.src, self.dst, self.w64
        else:
            src, dst, w64 = self.src.copy(), self.dst.copy(), self.w64.copy()
        return DeviceGraph(n=self.n,
                           src=upload(src, torch.int32, dev, chunk_edges),
                           dst=upload(dst, torch.int32, dev, chunk_edges),
                           inv_deg=upload(inv, dtype, dev),
                           w=upload(w64, wdtype, dev, chunk_edges))

    def to_graph(self) -> Graph:
        """Host Graph of the live slots (slot order, which is NOT the
        dst-sorted order of a fresh `from_undirected_edges` build — fine for
        every consumer: segment ops are order-free and CSR views sort)."""
        idx = np.flatnonzero(self.live)
        return Graph(n=self.n, src=self.src[idx], dst=self.dst[idx])

    def apply_delta(self, delta) -> SlotPatch | None:
        """Mutate the mirror by an EdgeDelta; return the device patch.

        Returns None — with the mirror UNTOUCHED — when the batch does not
        fit the current slot capacity (the caller takes the full-rebuild
        fallback, which picks a bigger bucket).
        """
        n = self.n
        ins, dele, touched = delta.inserted, delta.deleted, delta.touched
        # pure degree bookkeeping first: abort cleanly if it doesn't fit
        deg_new = self.deg.copy()
        if dele.size:
            ends = np.concatenate([dele // n, dele % n])
            deg_new -= np.bincount(ends, minlength=n).astype(np.int64)
        if ins.size:
            ends = np.concatenate([ins // n, ins % n])
            deg_new += np.bincount(ends, minlength=n).astype(np.int64)
        loops_drop = touched[(self.deg[touched] == 0) & (deg_new[touched] > 0)
                             & (self.iso_slot[touched] >= 0)]
        loops_add = touched[(deg_new[touched] == 0)
                            & (self.iso_slot[touched] < 0)]
        need = 2 * ins.size + loops_add.size
        freed_count = 2 * dele.size + loops_drop.size
        if need > freed_count + self.free.size:
            return None

        # free the deleted edges' slots + obsolete self loops, zeroed back
        # to padding (also what makes insert-then-delete restore the arrays
        # bit-for-bit)
        pos = np.searchsorted(self.ekeys, dele)
        freed = np.concatenate([self.eslots[pos].ravel(),
                                self.iso_slot[loops_drop]])
        self.ekeys = _sorted_delete(self.ekeys, pos)
        self.eslots = _sorted_delete(self.eslots, pos)
        self.iso_slot[loops_drop] = -1
        self.src[freed] = 0
        self.dst[freed] = 0
        self.w64[freed] = 0.0
        self.live[freed] = False

        # merge the (small, sorted) freed batch into the sorted free list —
        # block memcpy, never a sort over the O(cap - m) list — and allocate
        # from the tail: deterministic placement at O(1) slicing cost
        freed_sorted = np.sort(freed)
        free_all = _sorted_insert(self.free,
                                  np.searchsorted(self.free, freed_sorted),
                                  freed_sorted)
        alloc = free_all[free_all.size - need:] if need else \
            free_all[:0]
        self.free = free_all[:free_all.size - need]
        lo, hi = ins // n, ins % n
        ea, eb = alloc[: ins.size], alloc[ins.size: 2 * ins.size]
        self.src[ea] = lo
        self.dst[ea] = hi
        self.src[eb] = hi
        self.dst[eb] = lo
        ls = alloc[2 * ins.size:]
        self.src[ls] = loops_add
        self.dst[ls] = loops_add
        self.live[alloc] = True
        self.iso_slot[loops_add] = ls
        posi = np.searchsorted(self.ekeys, ins)
        self.ekeys = _sorted_insert(self.ekeys, posi, ins)
        self.eslots = _sorted_insert(self.eslots, posi,
                                     np.stack([ea, eb], axis=1))

        # a touched vertex's degree moved -> the folded 1/deg weight of
        # EVERY live slot it sources changes, inserted slots included
        self.deg = deg_new
        inv = 1.0 / np.maximum(deg_new, 1)
        tmask = np.zeros(n, bool)
        tmask[touched] = True
        sweep = np.flatnonzero(tmask[self.src] & self.live)
        self.w64[sweep] = inv[self.src[sweep]]

        # no sort/dedup needed: a slot freed then re-allocated in the same
        # batch can appear in both halves, but both positions carry the
        # slot's FINAL values (gathered below), so the duplicate scatter
        # writes are idempotent
        slots = np.concatenate([freed, sweep])
        return SlotPatch(slots=slots, src=self.src[slots],
                         dst=self.dst[slots], w=self.w64[slots],
                         rows=touched, inv_deg=inv[touched], mirror=self)


def patch_device_graph(dg: DeviceGraph, patch: SlotPatch) -> DeviceGraph:
    """Apply a SlotPatch to a padded DeviceGraph in place.

    Rewrites only the affected slots of src/dst/w and the touched rows of
    inv_deg (`index_copy_` into the same tensors, so engines holding them
    see the update and shapes never change). Weights are float64-exact on
    the host and cast the way `device_graph` casts them, so a patched
    array is bitwise equal to a rebuilt one. The reference donates the
    arrays to one jitted scatter and pads the scatter indices to powers of
    two to keep XLA's compiled shapes few; eager torch needs neither.

    Past `slots * 64 >= cap` touched slots the patch is no longer a sliver
    and the whole (already patched) mirror is copied over instead, still
    into the same tensors and never aliasing the mirror's buffers.
    """
    if dg.w is None:
        raise ValueError("patch_device_graph needs a DeviceGraph with "
                         "folded weights (device_graph builds one)")
    if patch.slots.size == 0 and patch.rows.size == 0:
        return dg
    dg._csr = None      # the edges move under the cached CSR view
    dev = dg.device
    m = patch.mirror
    if m is not None and patch.slots.size * 64 >= m.cap:
        inv = 1.0 / np.maximum(m.deg, 1)
        # copy_ copies the data, so the host views need no private copy
        dg.src.copy_(upload(m.src, dg.src.dtype, dev))
        dg.dst.copy_(upload(m.dst, dg.dst.dtype, dev))
        dg.w.copy_(upload(m.w64, dg.w.dtype, dev))
        dg.inv_deg.copy_(upload(inv, dg.inv_deg.dtype, dev))
        return dg
    # a slot freed and re-allocated in one batch appears twice with the
    # same final values, so duplicate indices write identical data
    slots = upload(patch.slots, torch.int64, dev)
    rows = upload(patch.rows, torch.int64, dev)
    dg.src.index_copy_(0, slots, upload(patch.src, dg.src.dtype, dev))
    dg.dst.index_copy_(0, slots, upload(patch.dst, dg.dst.dtype, dev))
    dg.w.index_copy_(0, slots, upload(patch.w, dg.w.dtype, dev))
    dg.inv_deg.index_copy_(0, rows,
                           upload(patch.inv_deg, dg.inv_deg.dtype, dev))
    return dg


def edge_matmul(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
                x: torch.Tensor, n_out: int) -> torch.Tensor:
    """y[dst[e]] += w[e] * x[src[e]] into `n_out` rows: the gather +
    `index_add_` shared by the COO engine and the sharded engines' shard
    bodies. x: [n] or [n, B]. Packed (bf16) weights upcast to the solve
    dtype before the multiply, so the accumulation runs at full precision.
    On CUDA `index_add_` adds with atomics, so the order of the sums is not
    fixed."""
    if w.dtype != x.dtype:
        w = w.to(x.dtype)
    contrib = x.index_select(0, src) * (w if x.ndim == 1 else w[:, None])
    out = torch.zeros((n_out,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return out.index_add_(0, dst, contrib)


def _transition_matmul(dg: DeviceGraph, x: torch.Tensor) -> torch.Tensor:
    """Shared spmv/spmm body over the DeviceGraph's edge list."""
    w = dg.w if dg.w is not None else dg.inv_deg.index_select(0, dg.src)
    return edge_matmul(dg.src, dg.dst, w, x, dg.n)


def spmv(dg: DeviceGraph, x: torch.Tensor) -> torch.Tensor:
    """y = P x with P = A D^{-1}: y[dst] += x[src] / deg[src]. x: [n]."""
    return _transition_matmul(dg, x)


def spmm(dg: DeviceGraph, x: torch.Tensor) -> torch.Tensor:
    """Batched transition: x [n, B] -> P x [n, B] (multi-source PageRank)."""
    return _transition_matmul(dg, x)


def segment_sum(x: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """out[s] = sum of x[e] over seg[e] == s, for s < n (0 where empty).
    x: [E] or [E, ...]. On CUDA the adds are atomics in no fixed order."""
    out = x.new_zeros((n,) + tuple(x.shape[1:]))
    return out.index_add_(0, seg, x)


def _segment_extreme(x: torch.Tensor, seg: torch.Tensor, n: int,
                     reduce: str, fill: float) -> torch.Tensor:
    idx = seg.long().reshape((-1,) + (1,) * (x.ndim - 1)).expand_as(x)
    out = x.new_full((n,) + tuple(x.shape[1:]), fill)
    return out.scatter_reduce(0, idx, x, reduce, include_self=False)


def segment_max(x: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """Per-segment max (-inf where a segment is empty, JAX's identity)."""
    return _segment_extreme(x, seg, n, "amax", float("-inf"))


def segment_min(x: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """Per-segment min (+inf where a segment is empty)."""
    return _segment_extreme(x, seg, n, "amin", float("inf"))


def aggregate(dg: DeviceGraph, x: torch.Tensor, kind: str = "sum",
              edge_vals: torch.Tensor | None = None) -> torch.Tensor:
    """Generic neighbour aggregation for GNN layers. x: [n, d]."""
    msgs = x.index_select(0, dg.src)
    if edge_vals is not None:
        msgs = msgs * edge_vals[:, None]
    if kind == "sum":
        return segment_sum(msgs, dg.dst, dg.n)
    if kind == "mean":
        s = segment_sum(msgs, dg.dst, dg.n)
        cnt = segment_sum(msgs.new_ones(dg.dst.shape), dg.dst, dg.n)
        return s / torch.clamp(cnt, min=1.0)[:, None]
    if kind == "max":
        return segment_max(msgs, dg.dst, dg.n)
    if kind == "min":
        return segment_min(msgs, dg.dst, dg.n)
    raise ValueError(kind)


def edge_softmax(dg: DeviceGraph, scores: torch.Tensor) -> torch.Tensor:
    """Softmax over incoming edges per destination vertex. scores: [m]."""
    mx = segment_max(scores, dg.dst, dg.n)
    ex = torch.exp(scores - mx.index_select(0, dg.dst))
    z = segment_sum(ex, dg.dst, dg.n)
    return ex / z.index_select(0, dg.dst)


def degree_normalize(dg: DeviceGraph, x: torch.Tensor,
                     power: float = -0.5) -> torch.Tensor:
    """D^power x (GCN-style normalization helper); deg = 1 / inv_deg.
    x: [n] or [n, d], like spmv/spmm."""
    scale = dg.inv_deg ** (-power)
    return x * (scale if x.ndim == 1 else scale[:, None])
