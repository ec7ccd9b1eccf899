"""Wrappers for the AdamW kernels: the update of one leaf
(`csrc/adamw_step.cu`) and a leaf's sum of squares (`csrc/sum_squares.cu`),
which `train.optimizer` runs on every leaf of every training step.

Neither replaces a Pallas kernel: the reference's update is `upd` in
src/repro/train/optimizer.py (`adamw_update`), and its norm
`global_norm`, each of which XLA fuses into one loop per leaf inside the
jitted step. A CPU tensor goes to the plain versions (`ref.py`); a CUDA
tensor launches the kernel or raises -- there is no fallback on the card.
Both kernels are bound by memory: the update reads p, g, m, v once and
writes p, m, v once (7 passes over the leaf), the norm reads the leaf
once. The update is bitwise the plain version; the norm accumulates in
float64 and is deterministic (no atomics), within 1e-6 of a float64 sum.

Dtypes on the card and on meta tensors (any other combination raises
TypeError): p float32 or float64; g float32, or float64 beside a float64
p; m and v both float32 or both bfloat16; the math in float32, or float64
for a float64 p. The norm takes float32 or float64 leaves. CPU tensors of
any dtype go to the plain versions, as before the kernels.

Each kernel has its own launch counter; a non-contiguous g (or norm
input) is copied to a contiguous one first, and those copies are counted
too (`contiguous_copies`). On meta tensors (the dry-run) nothing is
launched or counted: the wrappers return meta results and report the
cost the kernel would have to `kernels.cost`, as a launch on the card
does while a collector is open.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, cost
from repro_torch.kernels.adamw.ref import (adamw_step_ref, math_dtype,
                                           sum_squares_ref)

__all__ = ["adamw_step", "sum_squares", "step_launches", "norm_launches",
           "contiguous_copies", "reset_launches"]

# FLOPs per element of the update: one product for g'; 5 products and 2
# sums for m' and v' (with g'^2); 2 quotients by the bias corrections, the
# root, + eps, the quotient, wd p, the sum, lr x and the difference
STEP_FLOPS = 17

# the dtypes the kernels take; float64 is the f64 parameters of the
# float64 gates, whose update and norm stay in f64
_P_G = {torch.float32: (torch.float32,),
        # torchlint: disable=TL003 -- the kernels' f64 parameter entry point
        torch.float64: (torch.float32, torch.float64)}
_MOMENTS = (torch.float32, torch.bfloat16)
_NORM = (torch.float32, torch.float64)  # torchlint: disable=TL003 -- f64 leaf

# the entry points' flags (csrc/adamw_step.cu)
_MOMENTS_BF16, _SCALE_F64, _GRAD_F64 = 1, 2, 4

_COUNTS = {"step": 0, "norm": 0, "copies": 0}
_FNS: dict = {}


def step_launches() -> int:
    """`adamw_step` kernel launches since the last `reset_launches()`."""
    return _COUNTS["step"]


def norm_launches() -> int:
    """`sum_squares` kernel launches (both passes count once)."""
    return _COUNTS["norm"]


def contiguous_copies() -> int:
    """Copies of a non-contiguous g or norm input before a launch."""
    return _COUNTS["copies"]


def reset_launches() -> None:
    """Set every counter to 0."""
    for k in _COUNTS:
        _COUNTS[k] = 0


def _c_function(lib: str, name: str, argtypes: list,
                restype=ctypes.c_int):
    """The C function `name` of kernel library `lib`, bound once."""
    if name not in _FNS:
        fn = getattr(_build.library(lib), name)
        fn.argtypes = argtypes
        fn.restype = restype
        _FNS[name] = fn
    return _FNS[name]


def _check_step(p, g, m, v, scale, bc1, bc2) -> None:
    """Raise on a dtype combination the kernel does not take, or on
    mismatched shapes."""
    if p.dtype not in _P_G or g.dtype not in _P_G[p.dtype] or \
            m.dtype not in _MOMENTS or v.dtype != m.dtype:
        raise TypeError(f"adamw_step: p {p.dtype}, g {g.dtype}, m {m.dtype},"
                        f" v {v.dtype} is not a combination the kernel takes"
                        " (p f32 with g f32, or p f64 with g f32 or f64; m"
                        " and v both f32 or both bf16)")
    if scale.dtype not in _NORM or bc1.dtype != torch.float32 or \
            bc2.dtype != torch.float32:
        raise TypeError(f"adamw_step: scale {scale.dtype} (f32 or f64), bc1 "
                        f"{bc1.dtype}, bc2 {bc2.dtype} (f32)")
    for name, t in (("g", g), ("m", m), ("v", v)):
        if t.shape != p.shape:
            raise ValueError(f"adamw_step: {name} {tuple(t.shape)} != p "
                             f"{tuple(p.shape)}")
    for name, t in (("scale", scale), ("bc1", bc1), ("bc2", bc2)):
        if t.numel() != 1:
            raise ValueError(f"adamw_step: {name} must hold one value")


def _contiguous(t: torch.Tensor) -> torch.Tensor:
    if t.is_contiguous():
        return t
    _COUNTS["copies"] += 1
    return t.contiguous()


def _step_cost(n: int, p, g, m, v, scale) -> tuple[int, int]:
    """(flops, bytes) of one update: p, g, m, v read once, p, m, v written
    once, and the three scalars."""
    per = 2 * p.element_size() + g.element_size() + 2 * m.element_size() \
        + 2 * v.element_size()
    return STEP_FLOPS * n, n * per + scale.element_size() + 8


def _norm_cost(x) -> tuple[int, int]:
    """(flops, bytes) of one sum of squares: the leaf read once, one
    value written."""
    n = x.numel()
    return 2 * n, (n + 1) * x.element_size()    # f32 -> f32, f64 -> f64


def _launch_step(p, g, m, v, scale, bc1, bc2, outs, hyper) -> None:
    dev = p.device
    for name, t in (("g", g), ("m", m), ("v", v), ("scale", scale),
                    ("bc1", bc1), ("bc2", bc2)):
        if t.device != dev:
            raise ValueError(f"adamw_step: {name} on {t.device}, p on {dev}")
    for name, t in (("p", p), ("m", m), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"adamw_step: {name} must be contiguous")
    n = p.numel()
    if n == 0:
        return
    g = _contiguous(g)
    f64 = torch.float64     # torchlint: disable=TL003 -- names the f64 entry
    flags = (_MOMENTS_BF16 if m.dtype == torch.bfloat16 else 0) | \
        (_SCALE_F64 if scale.dtype == f64 else 0) | \
        (_GRAD_F64 if g.dtype == f64 else 0)
    name = "adamw_step_f64" if p.dtype == f64 else "adamw_step_f32"
    fn = _c_function("adamw_step", name, [ctypes.c_void_p] * 10
                     + [ctypes.c_double] * 7 + [ctypes.c_int64] * 2
                     + [ctypes.c_void_p])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
                 *(o.data_ptr() for o in outs), scale.data_ptr(),
                 bc1.data_ptr(), bc2.data_ptr(), *hyper, n, flags, stream)
    if err != 0:
        raise RuntimeError(f"adamw_step: kernel launch failed with CUDA "
                           f"error {err}")
    _COUNTS["step"] += 1
    if cost.active():
        cost.report("adamw_step", lambda: _step_cost(n, p, g, m, v, scale))


def adamw_step(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
               v: torch.Tensor, scale: torch.Tensor, bc1: torch.Tensor,
               bc2: torch.Tensor, *, lr: float, b1: float, b2: float,
               eps: float, weight_decay: float,
               in_place: bool = False) -> tuple:
    """One leaf's AdamW update -> (p', m', v'):

        g' = g scale;  m' = b1 m + (1 - b1) g';  v' = b2 v + (1 - b2) g'^2
        p' = p - lr (m' / bc1 / (sqrt(v' / bc2) + eps) + weight_decay p)

    in p's math dtype, the moments stored in their own. scale (the clip
    factor), bc1 and bc2 (the bias corrections) are one-element tensors on
    p's device, read there. With `in_place`, p, m and v are overwritten
    and returned; otherwise new tensors are."""
    on = {t.device.type for t in (p, g, m, v)}
    if on == {"cpu"}:
        return adamw_step_ref(p, g, m, v, scale, bc1, bc2, lr=lr, b1=b1,
                              b2=b2, eps=eps, weight_decay=weight_decay,
                              in_place=in_place)
    if on not in ({"cuda"}, {"meta"}):
        raise ValueError(f"adamw_step: tensors on {p.device}, {g.device}, "
                         f"{m.device}, {v.device}")
    _check_step(p, g, m, v, scale, bc1, bc2)
    outs = (p, m, v) if in_place else tuple(torch.empty_like(t)
                                            for t in (p, m, v))
    if on == {"cuda"}:
        _launch_step(p, g, m, v, scale, bc1, bc2, outs,
                     (lr, b1, 1 - b1, b2, 1 - b2, eps, weight_decay))
    elif cost.active():
        n = p.numel()
        cost.report("adamw_step", lambda: _step_cost(n, p, g, m, v, scale))
    return outs


def _launch_norm(x: torch.Tensor) -> torch.Tensor:
    n = x.numel()
    if n == 0:
        return torch.zeros((), dtype=math_dtype(x), device=x.device)
    x = _contiguous(x)
    out = torch.empty((), dtype=math_dtype(x), device=x.device)
    blocks = _c_function("sum_squares", "sum_squares_blocks",
                         [ctypes.c_int64], ctypes.c_int64)(n)
    # torchlint: disable=TL003 -- f64 partials: an f32 square is exact there
    f64 = torch.float64
    partials = torch.empty(blocks, dtype=f64, device=x.device)
    fn = _c_function("sum_squares", "sum_squares_f64"
                     if x.dtype == f64 else "sum_squares_f32",
                     [ctypes.c_void_p, ctypes.c_int64]
                     + [ctypes.c_void_p] * 3)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), n, partials.data_ptr(), out.data_ptr(),
                 stream)
    if err != 0:
        raise RuntimeError(f"sum_squares: kernel launch failed with CUDA "
                           f"error {err}")
    _COUNTS["norm"] += 1
    if cost.active():
        cost.report("sum_squares", lambda: _norm_cost(x))
    return out


def sum_squares(x: torch.Tensor) -> torch.Tensor:
    """sum x^2 over the leaf, a 0-dim tensor of its math dtype. On the card
    the sum is taken in float64 in a fixed order (the same bits on every
    call) and rounded once."""
    if x.device.type == "cpu":
        return sum_squares_ref(x)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"sum_squares: tensor on {x.device}")
    if x.dtype not in _NORM:
        raise TypeError(f"sum_squares: takes f32 or f64, got {x.dtype}")
    if x.device.type == "meta":
        if cost.active():
            cost.report("sum_squares", lambda: _norm_cost(x))
        return torch.empty((), dtype=math_dtype(x), device="meta")
    return _launch_norm(x)
