"""The six PyTorch-specific lint rules (TL001..TL006), one for each of the
reference's JL rules.

Each rule guards one invariant the port's performance story depends on:
one device fence per tick, f32 accumulation over packed weights, no CUDA
graph capture or compile in steady state, copies that keep every field,
and no read of a tensor a call updated in place behind the reader's back.
Rules are AST-only — heuristic by construction — and tuned to the port's
conventions through `LintConfig`; inline `# torchlint: disable=`
suppressions and the baseline file absorb the deliberate exceptions, so a
clean run means "no NEW violations", not "no judgment calls were made".
"""
from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.core import (Finding, ModuleContext, Rule,
                                       register)
from repro_torch.analysis.torchctx import (call_name, is_compile_call,
                                           is_compile_ref)

__all__ = ["ImplicitTransferRule", "RecaptureHazardRule",
           "DtypeContractRule", "CopyDriftRule", "InPlaceAliasRule",
           "BlockingCallRule"]


# --------------------------------------------------------------------------
# shared walking helpers

def _walk_with_function(tree: ast.AST):
    """Yield (node, enclosing_function_name_stack) over the whole tree."""
    stack: list[str] = []

    def rec(node):
        is_func = isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
        if is_func:
            stack.append(node.name)
        yield node, tuple(stack)
        for child in ast.iter_child_nodes(node):
            yield from rec(child)
        if is_func:
            stack.pop()

    yield from rec(tree)


def _receiver_name(node: ast.Call) -> str | None:
    """For m.f(...), the name `m` (None for deeper chains / plain calls)."""
    if isinstance(node.func, ast.Attribute) and \
            isinstance(node.func.value, ast.Name):
        return node.func.value.id
    return None


def _contains_static_marker(node: ast.AST) -> bool:
    """Expression is shape/metadata arithmetic, not a tensor value: touches
    .shape/.ndim/.size/.dtype or len()/range() anywhere inside."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and \
                sub.attr in ("shape", "ndim", "size", "dtype"):
            return True
        if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Name) and \
                sub.func.id in ("len", "range", "ord", "min", "max"):
            return True
    return False


def _norm_target(node: ast.AST):
    """Hashable identity of a Name / self-style Attribute chain (ctx-free),
    None for anything more complex."""
    if isinstance(node, ast.Name):
        return ("name", node.id)
    if isinstance(node, ast.Attribute):
        base = _norm_target(node.value)
        if base is None:
            return None
        return ("attr", base, node.attr)
    return None


def _device_attr(cfg, node: ast.AST) -> ast.Attribute | None:
    """`node` if it is `<device receiver>.<device attr>` (self.src, dg.w)."""
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and \
            node.value.id in cfg.device_receivers and \
            node.attr in cfg.device_attrs:
        return node
    return None


# --------------------------------------------------------------------------
# TL001 — implicit device->host transfer

@register
class ImplicitTransferRule(Rule):
    """Host reads of (possibly) device values.

    In hot code `.item()`, `.tolist()`, `.cpu()`, `.numpy()`, a
    `float()`/`int()`/`bool()` coercion of a tensor expression, or any
    `np.*` call that would take a tensor, waits for the card and copies to
    the host: one more fence per round or per tick. The other direction
    waits too: `torch.tensor(..., device=)` / `torch.as_tensor(...,
    device=)` copies from pageable host memory, and a Python number
    assigned through tensor indices (`p[rows, cols] = 1.0`, an
    `index_put_`) is copied to the card as a host tensor; each
    synchronizes the stream (under async dispatch, with the batch in
    flight). `torch.full`, a device-tensor value and a number assigned to
    a basic slice (a fill) do not. Anywhere,
    `np.asarray` / `.cpu()` / `.numpy()` of the device graph's arrays
    (`self.src`, `dg.w`, ...) is a blocking device->host copy and must be
    a deliberate, commented choice.
    """

    rule_id = "TL001"
    title = "implicit device->host transfer"

    def run(self, ctx: ModuleContext) -> Iterator[Finding]:
        cfg = ctx.config
        flagged: set[int] = set()
        for root in ctx.hot.hot_roots():
            for node in ast.walk(root):
                if not isinstance(node, ast.Call):
                    continue
                name = call_name(node)
                recv = _receiver_name(node)
                if recv in cfg.numpy_aliases and \
                        name not in cfg.numpy_meta_calls:
                    flagged.add(id(node))
                    yield ctx.finding(
                        self.rule_id, node,
                        f"numpy call `{recv}.{name}` in hot code reads a "
                        "tensor on the host (a device fence per call); use "
                        "torch ops or hoist it to the host-side build")
                elif isinstance(node.func, ast.Name) and \
                        name in cfg.transfer_calls and node.args and \
                        not isinstance(node.args[0], ast.Constant) and \
                        not _contains_static_marker(node.args[0]):
                    yield ctx.finding(
                        self.rule_id, node,
                        f"`{name}()` of a tensor in hot code waits for the "
                        "card and copies to the host; keep it a tensor or "
                        "move the read to the harvest")
                elif isinstance(node.func, ast.Attribute) and \
                        name in cfg.host_methods:
                    flagged.add(id(node))
                    yield ctx.finding(
                        self.rule_id, node,
                        f"`.{name}()` in hot code blocks on the card and "
                        "copies to the host")
                elif recv == "torch" and name in ("tensor", "as_tensor") \
                        and any(kw.arg == "device" for kw in node.keywords):
                    yield ctx.finding(
                        self.rule_id, node,
                        f"`torch.{name}(..., device=)` in hot code copies "
                        "from pageable host memory and waits for the "
                        "stream; build device scalars with `torch.full`")
            for node in ast.walk(root):
                if isinstance(node, ast.Assign) and \
                        isinstance(node.value, ast.Constant) and \
                        isinstance(node.value.value, (int, float)) and \
                        any(self._tensor_indexed(t) for t in node.targets):
                    yield ctx.finding(
                        self.rule_id, node,
                        "a Python number assigned through tensor indices "
                        "in hot code is copied to the card as a host "
                        "tensor (a stream sync); assign a device tensor "
                        "(`torch.ones((), device=...)`)")
        # anywhere: host reads of the device graph's arrays
        for node in ast.walk(ctx.tree):
            if id(node) in flagged or not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            a = None
            if _receiver_name(node) in cfg.numpy_aliases and \
                    name in ("asarray", "array") and node.args:
                a = _device_attr(cfg, node.args[0])
            elif isinstance(node.func, ast.Attribute) and \
                    name in ("cpu", "numpy"):
                a = _device_attr(cfg, node.func.value)
            if a is not None:
                yield ctx.finding(
                    self.rule_id, node,
                    f"host read of {a.value.id}.{a.attr} copies a "
                    "device-resident array to the host (blocking); if this "
                    "is deliberate host-side preprocessing, suppress with a "
                    "justification")

    @staticmethod
    def _tensor_indexed(target: ast.AST) -> bool:
        """`x[rows, cols]`: a subscript with an index that is neither a
        slice nor a constant (a tensor: advanced indexing, `index_put_`).
        A basic slice (`x[:, k:]`) takes a fill, with no copy."""
        if not isinstance(target, ast.Subscript):
            return False
        idx = target.slice
        parts = idx.elts if isinstance(idx, ast.Tuple) else [idx]
        return any(not isinstance(p, (ast.Slice, ast.Constant))
                   for p in parts)


# --------------------------------------------------------------------------
# TL002 — recapture / rebuild hazards

def _is_graph_ctor(node: ast.AST) -> bool:
    """`torch.cuda.CUDAGraph()` / `CUDAGraph()`."""
    return isinstance(node, ast.Call) and call_name(node) == "CUDAGraph"


def _is_rebuild(node: ast.AST) -> bool:
    return _is_graph_ctor(node) or (
        isinstance(node, ast.Call) and is_compile_call(node) is not None)


@register
class RecaptureHazardRule(Rule):
    """Per-call CUDA graph / torch.compile construction and shape-string
    cache keys.

    A `torch.cuda.CUDAGraph()` or `torch.compile(...)` evaluated in a
    function body builds a fresh graph (to capture) or a fresh compile
    cache per call: every invocation captures or compiles again. The
    steady-state invariant (the RetraceGate) holds only when they are built
    once, so the two cached-once idioms are exempt: `return ...` (the
    caller keeps the result) and `self.x = ...` (built once per instance).
    Shape-derived f-strings used as dict keys are the string-typed version
    of the same bug.
    """

    rule_id = "TL002"
    title = "recapture / rebuild hazard"

    def run(self, ctx: ModuleContext) -> Iterator[Finding]:
        cached = self._cached_calls(ctx.tree)
        decorators = {id(d) for n in ast.walk(ctx.tree)
                      if isinstance(n, (ast.FunctionDef,
                                        ast.AsyncFunctionDef))
                      for d in n.decorator_list}
        for node, fstack in _walk_with_function(ctx.tree):
            # a FunctionDef carries its OWN name on the stack: "nested" is
            # len(fstack) > 1 for defs, len(fstack) >= 1 for calls
            if fstack and _is_rebuild(node) and id(node) not in cached and \
                    id(node) not in decorators:
                what = "torch.cuda.CUDAGraph()" if _is_graph_ctor(node) \
                    else "torch.compile(...)"
                yield ctx.finding(
                    self.rule_id, node,
                    f"{what} built inside a function body captures or "
                    "compiles again on every call; build it once at module "
                    "scope, `return` it from a factory, or cache it on "
                    "`self`")
            if len(fstack) > 1 and isinstance(
                    node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for dec in node.decorator_list:
                    if is_compile_ref(dec) or is_compile_call(dec) is not None:
                        yield ctx.finding(
                            self.rule_id, dec,
                            f"nested function `{node.name}` is compiled "
                            "again on every enclosing call (fresh compile "
                            "cache); hoist the compiled def to module scope")
        for node in ast.walk(ctx.tree):
            key_exprs: list[ast.AST] = []
            if isinstance(node, ast.Dict):
                key_exprs = [k for k in node.keys if k is not None]
            elif isinstance(node, ast.Subscript):
                key_exprs = [node.slice]
            for k in key_exprs:
                if isinstance(k, ast.JoinedStr) and self._has_shape_ref(k):
                    yield ctx.finding(
                        self.rule_id, k,
                        "f-string cache key derived from a tensor shape — "
                        "shape-keyed string caches paper over recaptures; "
                        "key on the static ints themselves")

    @staticmethod
    def _has_shape_ref(node: ast.AST) -> bool:
        return any(isinstance(s, ast.Attribute) and
                   s.attr in ("shape", "dtype")
                   for s in ast.walk(node))

    @staticmethod
    def _cached_calls(tree: ast.AST) -> set[int]:
        """ids of rebuild Calls in cached-once positions: the value of a
        `return` or an assignment to a `self.` attribute."""
        out: set[int] = set()

        def _mark(value: ast.AST | None):
            if value is None:
                return
            vals = value.elts if isinstance(value, ast.Tuple) else [value]
            for v in vals:
                if _is_rebuild(v):
                    out.add(id(v))

        for node in ast.walk(tree):
            if isinstance(node, ast.Return):
                _mark(node.value)
            elif isinstance(node, ast.Assign) and all(
                    isinstance(t, ast.Attribute) and
                    isinstance(t.value, ast.Name) and t.value.id == "self"
                    for t in node.targets):
                _mark(node.value)
        return out


# --------------------------------------------------------------------------
# TL003 — dtype contract

def _multiplied(node: ast.AST) -> tuple[ast.AST, ...]:
    """The operands of a multiply: `a * b`, `a @ b`, `torch.mul(a, b)`,
    `torch.matmul(a, b)`; () for anything else."""
    if isinstance(node, ast.BinOp) and \
            isinstance(node.op, (ast.Mult, ast.MatMult)):
        return (node.left, node.right)
    if isinstance(node, ast.Call) and call_name(node) in ("mul", "matmul") \
            and _receiver_name(node) == "torch":
        return tuple(node.args[:2])
    return ()


@register
class DtypeContractRule(Rule):
    """bf16-storage / f32-accumulation contract + stray float64.

    Packed attributes (`w`, `inv_deg`) may be stored bf16; multiplying them
    DIRECTLY in hot code skips the documented upcast-before-multiply and
    silently accumulates at half precision. And float64 in non-test code
    doubles the bandwidth of whatever it touches (and runs at 1/64 of the
    card's FP32 rate on its tensor-free path) — host-side exact-arithmetic
    sites carry explicit suppressions instead.
    """

    rule_id = "TL003"
    title = "dtype contract violation"

    # jaxlint: disable=JL003 -- the rule must name the literal it hunts
    _F64_NAMES = ("float64", "double")  # torchlint: disable=TL003 -- needle

    def run(self, ctx: ModuleContext) -> Iterator[Finding]:
        cfg = ctx.config
        # (a) packed-attribute multiply without upcast, hot code only
        for root in ctx.hot.hot_roots():
            for node in ast.walk(root):
                for side in _multiplied(node):
                    if isinstance(side, ast.Attribute) and \
                            side.attr in cfg.packed_attrs:
                        yield ctx.finding(
                            self.rule_id, node,
                            f"`.{side.attr}` may be stored packed (bf16); "
                            "multiplying it directly skips the f32 upcast — "
                            "rebind via `.to(x.dtype)` or `.float()` first")
        # (b) stray float64
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Attribute) and \
                    node.attr in self._F64_NAMES and \
                    isinstance(node.value, ast.Name) and \
                    node.value.id in cfg.numpy_aliases + ("torch",):
                yield ctx.finding(
                    self.rule_id, node,
                    f"float64 dtype `{node.value.id}.{node.attr}` outside "
                    "tests: it doubles the bytes of every tensor it reaches "
                    "— if this is deliberate exact host arithmetic, "
                    "suppress with a justification")
            elif isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "double" and not node.args:
                yield ctx.finding(
                    self.rule_id, node,
                    "`.double()` outside tests (see the TL003 float64 "
                    "policy)")
            elif isinstance(node, ast.Constant) and \
                    node.value == "float64":  # jaxlint: disable=JL003 -- rule's own needle  # torchlint: disable=TL003 -- rule's own needle
                yield ctx.finding(
                    self.rule_id, node,
                    "string dtype \"float64\" outside tests (see the TL003 "
                    "float64 policy)")


# --------------------------------------------------------------------------
# TL004 — copy drift

def _is_self_class(node: ast.AST) -> bool:
    """`type(self)` or `self.__class__`."""
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) and \
            node.func.id == "type" and len(node.args) == 1 and \
            isinstance(node.args[0], ast.Name) and node.args[0].id == "self":
        return True
    return isinstance(node, ast.Attribute) and node.attr == "__class__" and \
        isinstance(node.value, ast.Name) and node.value.id == "self"


@register
class CopyDriftRule(Rule):
    """Fields set in `__init__` that a copy method silently drops.

    The port has no pytree classes; its counterpart of `tree_flatten` is
    the method that rebuilds an instance of its own class (`type(self)(...)`,
    `self.__class__(...)`, or `cls(...)` with `cls = type(self)`), as
    `BlockEllEngine.with_kernels` does. A public field that method neither
    reads from `self` nor sets on the new object resets to whatever
    `__init__` gives it. Deliberate exclusions (caches, informational
    fields) are underscore-prefixed or suppressed.
    """

    rule_id = "TL004"
    title = "copy drift"

    def run(self, ctx: ModuleContext) -> Iterator[Finding]:
        cfg = ctx.config
        for cls in [n for n in ast.walk(ctx.tree)
                    if isinstance(n, ast.ClassDef)]:
            init = self._method(cls, "__init__")
            if init is None:
                continue
            assigned = self._self_assigns(init)
            for copy in self._copy_methods(cls):
                kept = self._self_reads(copy) | self._sets_on_new(copy)
                missing = [a for a in sorted(assigned - kept)
                           if not a.startswith(tuple(cfg.exempt_prefixes))]
                for name in missing:
                    yield ctx.finding(
                        self.rule_id, init,
                        f"class `{cls.name}`: field `{name}` is set in "
                        f"__init__ but `{copy.name}` neither reads it nor "
                        "sets it on the copy — the copy silently resets "
                        "it; carry it over or prefix it `_`")

    @staticmethod
    def _method(cls: ast.ClassDef, name: str):
        for stmt in cls.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)) and \
                    stmt.name == name:
                return stmt
        return None

    @staticmethod
    def _ctor_calls(fn) -> list[ast.Call]:
        """Calls in `fn` that build an instance of self's class."""
        aliases = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and _is_self_class(node.value):
                aliases.update(t.id for t in node.targets
                               if isinstance(t, ast.Name))
        return [node for node in ast.walk(fn)
                if isinstance(node, ast.Call) and
                (_is_self_class(node.func) or
                 (isinstance(node.func, ast.Name) and
                  node.func.id in aliases))]

    @classmethod
    def _copy_methods(cls_, cls: ast.ClassDef):
        for stmt in cls.body:
            if not isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    or stmt.name == "__init__":
                continue
            if any(isinstance(d, ast.Name) and
                   d.id in ("classmethod", "staticmethod")
                   for d in stmt.decorator_list):
                continue
            if cls_._ctor_calls(stmt):
                yield stmt

    @classmethod
    def _sets_on_new(cls_, fn) -> set[str]:
        """Attributes set on the object the copy method builds."""
        ctors = {id(c) for c in cls_._ctor_calls(fn)}
        new = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and id(node.value) in ctors:
                new.update(t.id for t in node.targets
                           if isinstance(t, ast.Name))
        out: set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Attribute) and \
                    isinstance(node.ctx, ast.Store) and \
                    isinstance(node.value, ast.Name) and node.value.id in new:
                out.add(node.attr)
        return out

    @staticmethod
    def _self_assigns(fn) -> set[str]:
        out: set[str] = set()
        for node in ast.walk(fn):
            targets = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
                targets = [node.target]
            for t in targets:
                els = t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t]
                for el in els:
                    if isinstance(el, ast.Attribute) and \
                            isinstance(el.value, ast.Name) and \
                            el.value.id == "self":
                        out.add(el.attr)
        return out

    @staticmethod
    def _self_reads(fn) -> set[str]:
        return {node.attr for node in ast.walk(fn)
                if isinstance(node, ast.Attribute) and
                isinstance(node.value, ast.Name) and node.value.id == "self"}


# --------------------------------------------------------------------------
# TL005 — in-place aliasing

@register
class InPlaceAliasRule(Rule):
    """Reading a tensor after passing it to a position a call updates in
    place.

    A donated train step (`make_train_step(...)`, donate=True by default)
    and `adamw_update(..., in_place=True)` overwrite their parameter and
    state arguments and return the same tensors. A name read after the
    call holds the UPDATED values — code that meant the old ones (a loss
    against the pre-step weights, a replay from a saved state) silently
    reads the new. Safe pattern: rebind the name from the call's result,
    which says what it holds.
    """

    rule_id = "TL005"
    title = "in-place update aliased"

    def run(self, ctx: ModuleContext) -> Iterator[Finding]:
        for fi in ctx.hot.functions:
            yield from self._check_function(ctx, fi.node)

    def _check_function(self, ctx, fn) -> Iterator[Finding]:
        stmts = list(fn.body)
        scopes = ctx.hot.scopes(fn)
        for i, stmt in enumerate(stmts):
            for call in ast.walk(stmt):
                if not isinstance(call, ast.Call):
                    continue
                positions = ctx.hot.positions(call, scopes)
                if not positions:
                    continue
                name = call_name(call)
                watch = []
                for pos in positions:
                    if pos < len(call.args):
                        key = _norm_target(call.args[pos])
                        if key is not None:
                            watch.append((key, call.args[pos]))
                if not watch:
                    continue
                rebound = self._rebound_targets(stmt, call)
                watch = [(k, a) for (k, a) in watch if k not in rebound]
                for later in stmts[i + 1:]:
                    for sub in ast.walk(later):
                        key = _norm_target(sub)
                        if key is None:
                            continue
                        if isinstance(getattr(sub, "ctx", None), ast.Store):
                            watch = [(k, a) for (k, a) in watch if k != key]
                            continue
                        for k, _ in list(watch):
                            if k == key:
                                yield ctx.finding(
                                    self.rule_id, sub,
                                    f"`{ast.unparse(sub)}` was updated in "
                                    f"place by `{name}` above; it now holds "
                                    "the new values — rebind it from the "
                                    "call's result before reading")
                                watch = [(w, a2) for (w, a2) in watch
                                         if w != k]

    @staticmethod
    def _rebound_targets(stmt: ast.stmt, call: ast.Call) -> set:
        """Targets of the assignment in `stmt` whose value holds `call`
        (`params, opt, m = step(params, opt, b)`, also inside a loop)."""
        out = set()
        for node in ast.walk(stmt):
            if not isinstance(node, ast.Assign) or \
                    not any(sub is call for sub in ast.walk(node.value)):
                continue
            for t in node.targets:
                els = t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t]
                for el in els:
                    k = _norm_target(el)
                    if k is not None:
                        out.add(k)
        return out


# --------------------------------------------------------------------------
# TL006 — blocking call outside sanctioned fence points

@register
class BlockingCallRule(Rule):
    """`synchronize` anywhere but the fences.

    The serve path's latency story depends on EXACTLY ONE device fence per
    tick (the harvest's event; see obs/trace.py's host/device span split).
    A `torch.cuda.synchronize()` or `Event`/`Stream.synchronize()` anywhere
    else serializes host and device and silently destroys the overlap of
    async dispatch. New fence points must be added to the LintConfig
    allowlist, which is the documentation.
    """

    rule_id = "TL006"
    title = "blocking call outside fence"

    def run(self, ctx: ModuleContext) -> Iterator[Finding]:
        cfg = ctx.config
        for node, fstack in _walk_with_function(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            if name not in cfg.blocking_calls:
                continue
            if self._allowed(cfg, ctx.path, fstack):
                continue
            where = fstack[-1] if fstack else "<module>"
            yield ctx.finding(
                self.rule_id, node,
                f"blocking `{name}` in `{where}` — the only sanctioned "
                "fences are " +
                ", ".join(f"{p}:{f}" for p, f in cfg.blocking_allowed) +
                "; fence at harvest or add this site to the allowlist")

    @staticmethod
    def _allowed(cfg, path: str, fstack: tuple[str, ...]) -> bool:
        for suffix, fn in cfg.blocking_allowed:
            if path.endswith(suffix) and (fn == "*" or fn in fstack):
                return True
        return False
