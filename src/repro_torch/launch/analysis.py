"""Counted-run analysis (port of `repro.launch.analysis`): FLOPs, bytes,
collective bytes and the roofline of one step.

The reference reads XLA's `cost_analysis()` and the compiled HLO of a
step it never runs. Eager PyTorch compiles nothing, so the port runs the
step once under counters (`count_step`):

  FLOPs       `torch.utils.flop_counter`'s formulas for the matmul, conv
              and attention families (2 per multiply-add for the
              matrix-vector and dot products it has none for); one FLOP
              per output element for
              elementwise arithmetic (ops tagged pointwise) and one per
              input element for reductions and scatter-adds, as XLA's
              HloCostAnalysis counts them;
  bytes       each data-moving aten op's input and output bytes (a
              broadcast input counted once, a gather's source as the rows
              it reads, a scatter's target as the rows it writes); views,
              metadata ops, allocations and collectives count 0;
  kernels     the hand-written kernels run through ctypes, which neither
              counter sees: each reports its own FLOPs and bytes
              (`kernels.cost`), from the byte count of its bound;
  collectives `core.distributed.collective_counts()`, mapped onto the
              reference's five kinds and their `n_*` counts, and by
              mesh axis (`collective_bytes_by_axis`);
  memory      with `track_memory`, the peak of the bytes the step's own
              allocations hold at once (`OpCounter.peak_bytes`): each
              storage an op creates counts from that op until the last
              tensor on it is freed (a weakref finalizer per tensor), so
              a step on meta tensors, which allocates nothing, still has
              the temp_bytes the reference reads from XLA.

The roofline divides by the card's rates (`launch/mesh.py`): FLOPs over
the peak of the plan's compute dtype (bf16 tensor cores, or FP32 CUDA
cores for f32), bytes over HBM bandwidth, collective bytes over NVLink
bandwidth. Every term is per device, as the reference's are.
"""
from __future__ import annotations

import contextlib
import weakref
from dataclasses import asdict, dataclass

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.core.distributed import collective_counts, \
    reset_collective_counts
from repro_torch.kernels import cost as kernel_cost
from repro_torch.launch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16, \
    PEAK_FLOPS_F32

__all__ = ["COLLECTIVES", "collective_bytes", "collective_bytes_by_axis",
           "OpCounter", "count_step", "Roofline", "roofline_terms"]

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
_KIND = {"all_gather": "all-gather", "all_reduce": "all-reduce",
         "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all"}


def collective_bytes(counts: dict) -> dict:
    """`core.distributed.collective_counts()` ({"tag/site/op/dim": {"calls",
    "bytes"}}) as the reference's record: bytes per kind and n_<kind>
    calls, per device."""
    out = {k: 0 for k in COLLECTIVES}
    n = {k: 0 for k in COLLECTIVES}
    for key, v in counts.items():
        kind = _KIND[key.split("/")[2]]
        out[kind] += int(v["bytes"])
        n[kind] += int(v["calls"])
    return {**out, **{f"n_{k}": v for k, v in n.items()}}


def collective_bytes_by_axis(counts: dict) -> dict:
    """{axis: {kind: bytes}} per device from `collective_counts()` (the
    key's last field is the mesh axis or group the trip ran over)."""
    out: dict = {}
    for key, v in counts.items():
        _, _, op, axis = key.split("/")
        per = out.setdefault(axis, {})
        per[_KIND[op]] = per.get(_KIND[op], 0) + int(v["bytes"])
    return out


# ---------------------------------------------------------------- counters --

# names as `_base_name` gives them (no in-place underscore)
_NO_BYTES = frozenset({
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "detach", "lift_fresh", "alias", "set", "resize",
    "_local_scalar_dense", "sym_size", "sym_stride", "sym_numel",
    "sym_storage_offset", "record_stream", "is_same_size", "is_nonzero",
    "_has_compatible_shallow_copy_type"})
_GATHERS = frozenset({"index_select", "embedding", "gather", "index",
                      "take"})
_SCATTER_ADDS = frozenset({"index_add", "scatter_add", "scatter_reduce",
                           "index_put", "_index_put_impl"})
_SCATTERS = _SCATTER_ADDS | frozenset({"scatter", "index_copy",
                                       "index_fill", "masked_scatter"})
_WRITE_ONLY = frozenset({"copy", "fill", "zero", "normal", "uniform",
                         "random", "exponential", "bernoulli", "full",
                         "zeros", "ones", "zeros_like", "ones_like",
                         "full_like", "randn", "rand", "randint",
                         "scalar_tensor", "arange"})
# products torch.utils.flop_counter has no formula for
_VECTOR_PRODUCTS = frozenset({"mv", "addmv", "dot", "vdot"})
_REDUCTIONS = frozenset({
    "sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin", "prod",
    "logsumexp", "norm", "linalg_vector_norm", "var", "std", "var_mean",
    "std_mean", "cumsum", "cumprod", "_softmax", "_log_softmax",
    "_softmax_backward_data", "_log_softmax_backward_data", "any", "all",
    "count_nonzero", "nansum", "topk", "sort", "median"})


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _touched(t: torch.Tensor) -> int:
    """Bytes of the distinct elements a tensor view covers (a broadcast
    dimension, stride 0, counts once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _base_name(func) -> str:
    """The op's name without its in-place underscore."""
    name = func.overloadpacket.__name__
    return name[:-1] if name.endswith("_") else name


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


class OpCounter(TorchDispatchMode):
    """FLOPs and bytes of every aten op run inside the block (see the
    module docstring). `paused` stops the count (for the accounting's own
    ops)."""

    def __init__(self, track_memory: bool = False):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.paused = False
        self.track_memory = track_memory
        self.live_bytes = 0         # storages made inside, still held
        self.peak_bytes = 0
        self._storages: dict = {}   # storage key -> [bytes, tensors on it]
        self._before: set = set()   # storage keys of the arguments

    @contextlib.contextmanager
    def pause(self):
        was, self.paused = self.paused, True
        try:
            yield
        finally:
            self.paused = was

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), "CompositeImplicitAutograd"):
            # under inference_mode a composite op (matmul, linear, to)
            # arrives whole: run its decomposition so the counter sees
            # the ops that do the work
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if not self.paused and func.namespace == "aten":
            self._count(func, args, kwargs, out)
        if self.track_memory:
            self._hold(_tensors(out))
        return out

    def _hold(self, outs) -> None:
        """Count each output's storage from its first tensor until its
        last tensor is freed (views and in-place results join the storage
        they share; storages made before the block are not counted)."""
        for t in outs:
            try:
                st = t.untyped_storage()
            except (NotImplementedError, RuntimeError):
                continue
            key = st._cdata
            if key in self._before:
                continue
            rec = self._storages.get(key)
            if rec is None:
                rec = self._storages[key] = [st.nbytes(), 0]
                self.live_bytes += rec[0]
                self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            rec[1] += 1
            weakref.finalize(t, self._release, key)

    def _release(self, key) -> None:
        rec = self._storages.get(key)
        if rec is None:
            return
        rec[1] -= 1
        if rec[1] == 0:
            self.live_bytes -= rec[0]
            del self._storages[key]

    def exclude(self, tree) -> None:
        """Leave the storages of `tree`'s tensors (the step's arguments)
        out of the count: an in-place op on them allocates nothing."""
        from torch.utils import _pytree as pytree
        self._before |= {t.untyped_storage()._cdata
                         for t in pytree.tree_leaves(tree)
                         if isinstance(t, torch.Tensor)}

    def _count(self, func, args, kwargs, out) -> None:
        name = _base_name(func)
        ins = _tensors(list(args) + list(kwargs.values()))
        outs = _tensors(out)
        packet = func.overloadpacket
        if packet in flop_registry:
            self.flops += _formula_flops(packet, args, kwargs, out)
        elif name in _VECTOR_PRODUCTS and outs:
            # a matrix-vector or dot product: 2 per multiply-add
            self.flops += 2 * ins[-1].numel() * outs[0].numel() \
                if name != "addmv" else 2 * ins[1].numel()
        elif torch.Tag.pointwise in func.tags and outs:
            self.flops += outs[0].numel()
        elif name in _REDUCTIONS and ins:
            self.flops += ins[0].numel()
        elif name == "embedding_dense_backward":
            self.flops += ins[0].numel()
        elif name in _SCATTER_ADDS and len(ins) > 1 and (
                name != "index_put" or _accumulates(args, kwargs)):
            self.flops += max(t.numel() for t in ins[1:])
        if name in _NO_BYTES or _is_view(func):
            return
        if name in _GATHERS:
            # the source's rows read are the output's; indices read once
            self.bytes += sum(_touched(t) for t in ins[1:]) + \
                2 * sum(_touched(t) for t in outs)
        elif name in _SCATTERS and len(ins) > 1:
            # indices and values read once, the rows they land on read and
            # written; out of place, the whole target is also copied
            self.bytes += sum(_touched(t) for t in ins[1:]) + \
                2 * max(_touched(t) for t in ins[1:])
            if not func._schema.name.endswith("_"):
                self.bytes += _touched(ins[0]) + sum(_touched(t)
                                                     for t in outs)
        elif name in _WRITE_ONLY:
            # the target's old contents are not read
            src = ins[1:] if name == "copy" else []
            self.bytes += sum(_touched(t) for t in src) + \
                sum(_touched(t) for t in outs)
        else:
            self.bytes += sum(_touched(t) for t in ins) + \
                sum(_touched(t) for t in outs)


def _formula_flops(packet, args, kwargs, out) -> int:
    """torch.utils.flop_counter's formula for the op; an overload with
    extra arguments its formula does not name (bmm's out_dtype) is
    counted from its tensors alone."""
    try:
        return int(flop_registry[packet](*args, **kwargs, out_val=out))
    except TypeError:
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        return int(flop_registry[packet](*tensors, out_val=out))


def _accumulates(args, kwargs) -> bool:
    """index_put's accumulate flag (its fourth argument)."""
    return bool(kwargs.get("accumulate", args[3] if len(args) > 3
                           else False))


def count_step(fn, *args, memory: dict | None = None) -> tuple:
    """Run fn(*args) once under the counters. Returns (fn's output,
    {"flops", "bytes accessed"} per device with the kernels' reports
    added, the collectives as `collective_bytes` gives them, {kernel:
    {"launches", "flops", "bytes"}}). With `memory` (a dict), the step's
    allocations are tracked too: memory["peak_bytes"] is the most they
    held at once, memory["by_axis"] the collective bytes per mesh axis."""
    counter = OpCounter(track_memory=memory is not None)
    if memory is not None:
        counter.exclude(args)
    kernels: dict = {}

    def sink(name, cost_fn):
        with counter.pause():
            flops, nbytes = cost_fn()
        k = kernels.setdefault(name, {"launches": 0, "flops": 0,
                                      "bytes": 0})
        k["launches"] += 1
        k["flops"] += int(flops)
        k["bytes"] += int(nbytes)

    reset_collective_counts()
    with kernel_cost.collecting(sink), counter:
        out = fn(*args)
    coll = collective_bytes(collective_counts())
    if memory is not None:
        memory["peak_bytes"] = counter.peak_bytes
        memory["by_axis"] = collective_bytes_by_axis(collective_counts())
    cost = {"flops": float(counter.flops + sum(k["flops"]
                                               for k in kernels.values())),
            "bytes accessed": float(counter.bytes + sum(
                k["bytes"] for k in kernels.values()))}
    return out, cost, coll, kernels


# ---------------------------------------------------------------- roofline --

@dataclass
class Roofline:
    chips: int
    hlo_flops: float            # per device (the counted run's)
    hlo_bytes: float            # per device
    coll_bytes: float           # per device
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    useful_flops_ratio: float   # MODEL_FLOPS / (FLOPs * chips)

    def to_dict(self):
        return asdict(self)


def peak_flops(compute_dtype: str) -> float:
    """The card's peak for a plan's compute dtype: bf16 / fp16 on the
    tensor cores, anything else on the FP32 CUDA cores."""
    return PEAK_FLOPS_BF16 if compute_dtype in ("bfloat16", "float16") \
        else PEAK_FLOPS_F32


def roofline_terms(cost: dict, coll: dict, chips: int, model_flops: float,
                   compute_dtype: str = "bfloat16") -> Roofline:
    """The three terms of one step in seconds, per device: FLOPs over the
    peak of `compute_dtype`, bytes over HBM, collective bytes over
    NVLink."""
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    cbytes = float(sum(coll[k] for k in COLLECTIVES))
    compute_s = flops / peak_flops(compute_dtype)
    memory_s = byts / HBM_BW
    collective_s = cbytes / NVLINK_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    total = flops * chips
    ratio = model_flops / total if total else 0.0
    return Roofline(chips=chips, hlo_flops=flops, hlo_bytes=byts,
                    coll_bytes=cbytes, compute_s=compute_s, memory_s=memory_s,
                    collective_s=collective_s, dominant=dominant,
                    model_flops=model_flops, useful_flops_ratio=ratio)
