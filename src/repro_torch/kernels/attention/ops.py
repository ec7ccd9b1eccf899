"""Wrapper for the attention kernels: the forward (`csrc/attention_fwd.cu`)
and FlashAttention-2's backward (`csrc/attention_bwd.cu`) behind one
`torch.autograd.Function`, which `models.layers.chunked_attention` calls on
every path without a KV cache (training, the remat recompute, prefill, and
the tensor-parallel heads of `_attn_sharded`).

Neither replaces a Pallas kernel: the reference's attention is
`chunked_attention` (src/repro/models/layers.py:87), a `lax.scan` of a
`jax.checkpoint`ed tile step (:132-163) that XLA fuses on the TPU. The
plain version (`ref.py`) is the port's eager loop of that tile step.

Which version runs:
  * CPU tensors: the plain version, any dtype;
  * float64, on every device: the plain version, by rule. float64 is the
    dtype of the gates' oracles (chip_smoke's I-a, J-b and H's logit
    gate), which stay independent of the kernels that they judge;
  * CUDA tensors of bfloat16 or float32: the kernels, or an error (no
    fallback). Any other dtype raises TypeError, a head dim past
    MAX_HEAD_DIM raises ValueError. bfloat16 takes the wgmma kernels, fed
    by TMA; float32 the FFMA kernels, fed by cp.async (its 1e-5 gates are
    past TF32's reach). q, k, v and the cotangent are read in place from
    their strides; one whose last dimension is not contiguous, or whose
    rows the route cannot read (TMA: a 16-byte aligned base and strides
    of 16-byte multiples; cp.async: pieces of 4 bytes), is copied first
    (`contiguous_copies` counts them);
  * meta tensors (the dry-run): outputs of the right shape and the
    kernels' costs reported to `kernels.cost`, nothing launched or
    counted.

The forward saves q, k, v, its output (v's dtype) and one f32
log-sum-exp a row: no permuted or padded copy. Each kernel's results are
the same bits on every call (no atomics). Launches are counted per call:
`forward_launches()` one a forward, `backward_launches()` one a backward
(its three passes), and `launches_by_route()` splits both by the route
taken ("wgmma" for bfloat16, "ffma" for float32)."""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels import _build, cost
# the module, not its names: ref imports models.layers, which imports this
from repro_torch.kernels.attention import ref

__all__ = ["attention", "MAX_HEAD_DIM", "forward_launches",
           "backward_launches", "launches_by_route", "contiguous_copies",
           "reset_launches", "tiles", "tile_pairs", "valid_pairs",
           "descriptor_check"]

MAX_HEAD_DIM = 128      # the widest head the kernels are built for
TILE = 64               # f32: query rows and keys of a tile (attention_common.cuh)
_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}
# each dtype's route: the counters of its forward and backward launches
_ROUTES = {torch.bfloat16: ("forward_wgmma", "backward_wgmma"),
           torch.float32: ("forward_ffma", "backward_ffma")}
_COUNTS = {"forward": 0, "backward": 0, "copies": 0, "forward_wgmma": 0,
           "forward_ffma": 0, "backward_wgmma": 0, "backward_ffma": 0}
_FNS: dict = {}


def forward_launches() -> int:
    """Forward kernel launches since the last `reset_launches()`."""
    return _COUNTS["forward"]


def backward_launches() -> int:
    """Backward launches (the three passes of one backward count once)."""
    return _COUNTS["backward"]


def launches_by_route() -> dict:
    """{"forward_wgmma", "forward_ffma", "backward_wgmma",
    "backward_ffma": launches since the last `reset_launches()`}."""
    return {k: v for k, v in _COUNTS.items() if k.endswith(("_wgmma",
                                                            "_ffma"))}


def contiguous_copies() -> int:
    """Copies of a q, k, v or cotangent whose rows the kernels cannot read
    in place (`_rows`)."""
    return _COUNTS["copies"]


def reset_launches() -> None:
    """Set every counter to 0."""
    for k in _COUNTS:
        _COUNTS[k] = 0


@dataclass(frozen=True)
class _Spec:
    """The masking of one call: causal, the window (None: none), the
    position of q[0], and n_k * k_chunk, the weight a row with no valid
    key divides by (the reference's average of its masked tiles)."""
    causal: bool
    window: int | None
    q_offset: int
    dead_norm: int


def _row_keys(qp: int, sk: int, spec: _Spec) -> tuple[int, int, bool]:
    """(lo, hi, dead): the keys [lo, hi) position qp sees (all of [0, sk)
    for a row with none, dead)."""
    lo = max(0, qp - spec.window + 1) if spec.window is not None else 0
    hi = min(sk, qp + 1) if spec.causal else sk
    return (0, sk, True) if lo >= hi else (lo, hi, False)


@dataclass(frozen=True)
class Tiles:
    """(query rows, keys) of the tiles of each pass a route runs: the
    forward's blocks against its KV tiles, attention_dkdv's query steps
    against its blocks of keys, attention_dq's blocks against its KV
    tiles."""
    fwd: tuple[int, int]
    dkdv: tuple[int, int]
    dq: tuple[int, int]


def tiles(dtype: torch.dtype, dh: int) -> Tiles:
    """The tiles of the kernels that run for q's dtype and head dim: the
    wgmma kernels (bfloat16: FwdTc, DkDvTc, DqTc in csrc/) or the FFMA
    kernels (float32: Fwd, DkDv, Dq)."""
    if dtype == torch.bfloat16:
        return Tiles((128, 128), (64, 128), (128, 64))
    return Tiles((TILE, TILE), (_bwd_rows(dh), TILE), (TILE, TILE))


def tile_pairs(sq: int, sk: int, spec: _Spec, rows: int,
               keys: int = TILE) -> int:
    """(query, key) pairs of the tiles a kernel computes for one head:
    query tiles of `rows` rows against the KV tiles of `keys` keys they
    see (the kernels' `key_range`)."""
    total = 0
    for i0 in range(0, sq, rows):
        i1 = min(i0 + rows, sq) - 1
        a = _row_keys(spec.q_offset + i0, sk, spec)
        b = _row_keys(spec.q_offset + i1, sk, spec)
        k0, k1 = (0, sk) if a[2] or b[2] else (a[0], b[1])
        total += (-(-k1 // keys) - k0 // keys) * rows * keys
    return total


def valid_pairs(sq: int, sk: int, causal: bool = True,
                window: int | None = None, q_offset: int = 0) -> int:
    """(query, key) pairs that take part in one head's attention: the
    unmasked ones, and all sk of a row with no valid key."""
    qp = q_offset + np.arange(sq, dtype=np.int64)
    lo = np.maximum(0, qp - window + 1) if window is not None else 0
    hi = np.minimum(sk, qp + 1) if causal else np.full(sq, sk)
    return int(np.where(lo >= hi, sk, hi - lo).sum())


def _bwd_rows(dh: int) -> int:
    """Query rows a step of the f32 attention_dkdv (DkDv::BQ)."""
    return 32 if dh > 80 else 64


def _forward_cost(q, k, v, spec) -> tuple[int, int]:
    """(flops, bytes) of one forward: the two products of the tiles it
    computes; q, k, v read, the output and the log-sum-exp written."""
    b, sq, h, dh = q.shape
    pairs = tile_pairs(sq, k.shape[1], spec, *tiles(q.dtype, dh).fwd)
    moved = sum(t.numel() for t in (q, k, v)) + q.numel()     # o too
    return 4 * dh * pairs * b * h, moved * q.element_size() + 4 * b * h * sq


def _backward_cost(q, k, v, spec) -> tuple[int, int]:
    """(flops, bytes) of one backward: the 4 products of attention_dkdv's
    tiles and the 3 of attention_dq's; q, k, v, o, dO and the
    log-sum-exp read, dq, dk, dv written, D written and read."""
    b, sq, h, dh = q.shape
    sk = k.shape[1]
    t = tiles(q.dtype, dh)
    pairs = 4 * tile_pairs(sq, sk, spec, *t.dkdv) + \
        3 * tile_pairs(sq, sk, spec, *t.dq)
    moved = 2 * sum(t.numel() for t in (q, k, v)) + 2 * q.numel()
    return 2 * dh * pairs * b * h, \
        moved * q.element_size() + 3 * 4 * b * h * sq


def _c_function(lib: str, name: str, n_ptr: int):
    """The C entry `name` of library `lib`: n_ptr pointers, the shape
    array, scale, dead_norm and the stream."""
    if name not in _FNS:
        fn = getattr(_build.library(lib), name)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [
            ctypes.POINTER(ctypes.c_int64), ctypes.c_double,
            ctypes.c_double, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return _FNS[name]


def _piece(ts, dh: int) -> int:
    """The largest cp.async piece (16, 8 or 4 bytes) that divides a row of
    every tensor in `ts`, its start and its batch, sequence and head
    strides; 0 when none does."""
    es = ts[0].element_size()
    for vec in (16, 8, 4):
        if (dh * es) % vec == 0 and all(
                t.data_ptr() % vec == 0
                and all((t.stride(i) * es) % vec == 0 for i in range(3))
                for t in ts):
            return vec
    return 0


def _shape_array(q, k, v, o, g, spec: _Spec, vec: int):
    b, sq, h, dh = q.shape
    vals = [b, h, k.shape[2], sq, k.shape[1], dh, int(spec.causal),
            int(spec.window is not None),
            spec.window if spec.window is not None else 0, spec.q_offset,
            vec]
    # the stride of a dimension of size 1 is never stepped; TMA still
    # wants a 16-byte multiple there
    free = -(-dh // 8) * 8
    for t in (q, k, v, o, g):
        vals += [t.stride(i) if t.shape[i] > 1 else free for i in range(3)]
    return (ctypes.c_int64 * len(vals))(*vals)


def _check(q, k, v) -> None:
    """Raise on what the kernels do not take (CUDA or meta tensors)."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"attention: q [B, Sq, H, Dh] and k, v [B, Sk, "
                         f"Hkv, Dh], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, dh = q.shape
    if k.shape[0] != b or k.shape[3] != dh or k.shape[2] == 0 \
            or h % k.shape[2]:
        raise ValueError(f"attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree (batch, head dim, or "
                         f"H not a multiple of Hkv)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"attention: the kernels take q, k, v all bfloat16 "
                        f"or all float32 (float64 takes the plain version), "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if dh > MAX_HEAD_DIM:
        raise ValueError(f"attention: head dim {dh} is past the kernels' "
                         f"limit of {MAX_HEAD_DIM}")
    if min(b, sq, h, k.shape[1]) == 0:
        raise ValueError(f"attention: empty q {tuple(q.shape)} or k "
                         f"{tuple(k.shape)}")
    if max(sq, k.shape[1]) > (2 ** 16 - 1) * TILE or b > 2 ** 16 - 1:
        raise ValueError(f"attention: batch {b}, {sq} queries or "
                         f"{k.shape[1]} keys are past the grid's limits")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"attention: {name} on {t.device}, q on "
                             f"{q.device}")


def _copy(t: torch.Tensor) -> torch.Tensor:
    """t in new contiguous storage (`contiguous()` keeps a tensor that is
    contiguous but starts off the 16-byte boundary). A bfloat16 row whose
    bytes are no 16-byte multiple goes into a row padded to one, and the
    view of its first Dh columns is returned: TMA reads rows 16-byte
    aligned and never past Dh."""
    dh = t.shape[3]
    if t.dtype != torch.bfloat16 or dh % 8 == 0:
        return t.clone(memory_format=torch.contiguous_format)
    out = torch.empty((*t.shape[:3], -(-dh // 8) * 8), dtype=t.dtype,
                      device=t.device)[..., :dh]
    out.copy_(t)
    return out


def _tma_ok(t: torch.Tensor) -> bool:
    """TMA can read t's rows in place: a 16-byte aligned base and batch,
    sequence and head strides of 16-byte multiples (where the dimension
    is stepped)."""
    es = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        t.shape[i] == 1 or (t.stride(i) * es) % 16 == 0 for i in range(3))


def _readable(t: torch.Tensor) -> bool:
    """The kernels read t's rows in place: a contiguous last dimension
    and, on the card, rows its route can copy (TMA for bfloat16, pieces
    of cp.async for float32)."""
    if t.stride(3) != 1:
        return False
    if t.device.type != "cuda":
        return True
    return _tma_ok(t) if t.dtype == torch.bfloat16 else \
        bool(_piece((t,), t.shape[3]))


def _rows(*ts) -> tuple:
    """ts with every row laid out as the kernels read it: a tensor whose
    last dimension is not contiguous (the layouts some collectives hand
    back), or whose rows its route cannot read in place (`_readable`), is
    copied (counted in `contiguous_copies`). Raises where even that does
    not do (a head dim of an odd number of bf16 elements)."""
    dh = ts[0].shape[3]
    if (dh * ts[0].element_size()) % 4:
        raise ValueError(f"attention: rows of {dh} {ts[0].dtype} elements "
                         f"are no multiple of 4 bytes, the kernels' "
                         f"smallest piece")
    out = []
    for t in ts:
        if not _readable(t):
            _COUNTS["copies"] += 1
            t = _copy(t)
        out.append(t)
    if out[0].device.type == "cuda" and out[0].dtype == torch.float32 \
            and not _piece(out, dh):
        raise ValueError(f"attention: rows of {dh} {out[0].dtype} elements "
                         f"are no multiple of 4 bytes, the kernels' "
                         f"smallest piece")
    return tuple(out)


def _forward(q, k, v, spec: _Spec):
    """(o [B, Sq, H, Dh] in v's dtype, lse [B, H, Sq] f32 base 2)."""
    b, sq, h, dh = q.shape
    o = torch.empty(q.shape, dtype=v.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if q.device.type == "cuda":
        vec = _piece((q, k, v), dh)
        fn = _c_function("attention_fwd", f"attention_fwd_{_DTYPES[q.dtype]}",
                         5)
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     lse.data_ptr(), _shape_array(q, k, v, o, o, spec, vec),
                     1.0 / math.sqrt(dh), float(spec.dead_norm), stream)
        if err != 0:
            raise RuntimeError(f"attention forward: kernel launch failed "
                               f"with CUDA error {err}")
        _COUNTS["forward"] += 1
        _COUNTS[_ROUTES[q.dtype][0]] += 1
    if cost.active():
        cost.report("attention_forward",
                    lambda: _forward_cost(q, k, v, spec))
    return o, lse


def _backward(q, k, v, o, lse, g, spec: _Spec):
    """(dq, dk, dv), contiguous, in q's dtype."""
    b, sq, h, dh = q.shape
    g = g.to(v.dtype)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    if q.device.type == "cuda":
        if not _readable(g) or (g.dtype == torch.float32
                                and not _piece((q, k, v, g), dh)):
            _COUNTS["copies"] += 1
            g = _copy(g)            # a cotangent as autograd hands it
        vec = _piece((q, k, v, g), dh)
        dsum = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
        fn = _c_function("attention_bwd", f"attention_bwd_{_DTYPES[q.dtype]}",
                         10)
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     g.data_ptr(), lse.data_ptr(), dsum.data_ptr(),
                     dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                     _shape_array(q, k, v, o, g, spec, vec),
                     1.0 / math.sqrt(dh), float(spec.dead_norm), stream)
        if err != 0:
            raise RuntimeError(f"attention backward: kernel launch failed "
                               f"with CUDA error {err}")
        _COUNTS["backward"] += 1
        _COUNTS[_ROUTES[q.dtype][1]] += 1
    if cost.active():
        cost.report("attention_backward",
                    lambda: _backward_cost(q, k, v, spec))
    return dq, dk, dv


def descriptor_check(a: torch.Tensor, b: torch.Tensor, v: torch.Tensor):
    """The wgmma kernels' shared-memory views on one tile each
    (`attention_check_bf16` in csrc/attention_fwd.cu), for a card test:
    a, b, v contiguous bf16 [128, Dh] (Dh a multiple of 8, at most 128).
    Returns (s [64, 192], o [64, 2 DP]) f32: s[:, :128] = a[64:] b^T,
    s[:, 128:] = a[64:] b[:64]^T, o[:, :Dh] = bf16(s[:, :128]) v and
    o[:, DP:DP + Dh] = bf16(s[:, 128:]) v[:64], DP the kernels' width
    for Dh (columns past Dh are the zero columns' products)."""
    dh = a.shape[1]
    if any(t.shape != (128, dh) or t.dtype != torch.bfloat16
           or not t.is_contiguous() or t.device.type != "cuda"
           for t in (a, b, v)) or dh % 8 or dh > MAX_HEAD_DIM:
        raise ValueError("descriptor_check: a, b, v contiguous bf16 "
                         "[128, Dh] on the card, Dh a multiple of 8 up to "
                         f"{MAX_HEAD_DIM}")
    dp = next(w for w in (16, 64, 80, 128) if dh <= w)
    s = torch.zeros((64, 192), dtype=torch.float32, device=a.device)
    o = torch.zeros((64, 2 * dp), dtype=torch.float32, device=a.device)
    if "attention_check_bf16" not in _FNS:
        fn = _build.library("attention_fwd").attention_check_bf16
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS["attention_check_bf16"] = fn
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _FNS["attention_check_bf16"](
            a.data_ptr(), b.data_ptr(), v.data_ptr(), s.data_ptr(),
            o.data_ptr(), dh, stream)
    if err != 0:
        raise RuntimeError(f"descriptor_check: launch failed with CUDA "
                           f"error {err}")
    return s, o


class _AttentionFn(torch.autograd.Function):
    """The forward kernel, and the backward kernels from its saved output
    and log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, spec):
        o, lse = _forward(q, k, v, spec)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.spec = spec
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        return (*_backward(q, k, v, o, lse, g, ctx.spec), None)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, window: int | None = None,
              q_chunk: int = 512, k_chunk: int = 512,
              q_offset: int = 0) -> torch.Tensor:
    """`chunked_attention`'s function (models/layers.py states it) on the
    version the module docstring names. q [B, Sq, H, Dh]; k, v [B, Sk,
    Hkv, Dh]; returns [B, Sq, H, Dh] in v's dtype. The kernels tile as
    `tiles` says whatever q_chunk is; k_chunk sets the weight of a row
    with no valid key, 1 / (ceil(Sk / k_chunk) k_chunk), as in the
    reference."""
    devs = {q.device.type, k.device.type, v.device.type}
    # torchlint: disable=TL003 -- names the oracle dtype that stays plain
    f64 = torch.float64
    if devs == {"cpu"} or f64 in (q.dtype, k.dtype, v.dtype):
        return ref.chunked_attention_ref(q, k, v, causal, window, q_chunk,
                                         k_chunk, q_offset)
    if devs not in ({"cuda"}, {"meta"}):
        raise ValueError(f"attention: tensors on {q.device}, {k.device}, "
                         f"{v.device}")
    _check(q, k, v)
    q, k, v = _rows(q, k, v)
    sk = k.shape[1]
    spec = _Spec(bool(causal), window, int(q_offset),
                 -(-sk // k_chunk) * k_chunk)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _AttentionFn.apply(q, k, v, spec)
    return _forward(q, k, v, spec)[0]
