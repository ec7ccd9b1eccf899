"""Shared hot-code analysis over one module's AST.

Answers the one question every rule needs: *which code is hot?* Hot code
runs once per solver round, per serving tick or per decode step, so a
host read there (`.item()`, `.cpu()`, `float(t)`, `np.asarray(t)`) is a
device fence per call, and a bf16 multiply there silently fixes the
accumulation dtype. Hot code is:

  * contract methods: names listed in `hot_methods` (the engine protocol)
    defined directly in a class body;
  * capture bodies: every function or method called by name inside a
    ``with torch.cuda.graph(...)`` block (``self._decode_core(...)`` marks
    the module's ``_decode_core``) — the capture records it once and every
    tick replays it;
  * compile targets: ``@torch.compile``, ``@torch.compile(...)``,
    ``@partial(torch.compile, ...)`` and ``g = torch.compile(f)`` (marks
    ``f``) — the counterpart of the reference's jit forms;
  * named functions: the `hot_functions` names of this module (the
    functions the reference jits, and the PPR tick path);
  * nesting: every function lexically inside a hot function.

Detection is static and name-based (no imports are resolved).

`in_place` maps (scope, name) to the positional arguments a call of that
name updates in place: a name bound from a factory listed in
`in_place_factories` (``step = make_train_step(...)``, unless the call
passes ``donate=False``), in the function that binds it (scope: the
function's node id; None at module level). `positions(call, scopes)` adds
the per-call form: a callee of `in_place_calls` called with
``in_place=True``. Both feed TL005.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field

__all__ = ["TorchContext", "FuncInfo", "analyze", "is_compile_call",
           "is_compile_ref", "call_name"]

def call_name(node: ast.Call) -> str | None:
    """Trailing name of the callee: f() -> "f", a.b.c() -> "c"."""
    if isinstance(node.func, ast.Name):
        return node.func.id
    if isinstance(node.func, ast.Attribute):
        return node.func.attr
    return None


def is_compile_ref(node: ast.AST) -> bool:
    """`torch.compile`."""
    return isinstance(node, ast.Attribute) and node.attr == "compile" and \
        isinstance(node.value, ast.Name) and node.value.id == "torch"


def _is_partial_ref(node: ast.AST) -> bool:
    if isinstance(node, ast.Name):
        return node.id == "partial"
    return isinstance(node, ast.Attribute) and node.attr == "partial"


def is_compile_call(node: ast.AST) -> ast.Call | None:
    """The Call node if `node` is `torch.compile(...)` or
    `partial(torch.compile, ...)`."""
    if not isinstance(node, ast.Call):
        return None
    if is_compile_ref(node.func):
        return node
    if _is_partial_ref(node.func) and node.args and \
            is_compile_ref(node.args[0]):
        return node
    return None


def _is_graph_capture(node: ast.AST) -> bool:
    """`torch.cuda.graph(...)` / `cuda.graph(...)` as a with-item."""
    if not isinstance(node, ast.Call) or \
            not isinstance(node.func, ast.Attribute) or \
            node.func.attr != "graph":
        return False
    recv = node.func.value
    return (isinstance(recv, ast.Attribute) and recv.attr == "cuda") or \
        (isinstance(recv, ast.Name) and recv.id == "cuda")


def _keyword(call: ast.Call, name: str):
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _is_const(node, value) -> bool:
    return isinstance(node, ast.Constant) and node.value is value


@dataclass
class FuncInfo:
    node: ast.FunctionDef | ast.AsyncFunctionDef
    parent: "FuncInfo | None"        # enclosing function, if any
    in_class: bool                   # defined directly in a class body
    hot: bool = False


@dataclass
class TorchContext:
    functions: list[FuncInfo] = field(default_factory=list)
    # (scope, callable name) -> positions its calls update in place; a
    # binding with donate=False records () and shadows outer scopes
    in_place: dict[tuple, tuple[int, ...]] = field(default_factory=dict)
    in_place_calls: dict[str, tuple[int, ...]] = field(default_factory=dict)
    captured_names: set[str] = field(default_factory=set)
    _by_node: dict[int, FuncInfo] = field(default_factory=dict)

    def info(self, node: ast.AST) -> FuncInfo | None:
        return self._by_node.get(id(node))

    def hot_roots(self):
        """Hot functions with no hot ancestor: walking each yields every
        hot statement exactly once."""
        for fi in self.functions:
            if not fi.hot:
                continue
            p = fi.parent
            while p is not None and not p.hot:
                p = p.parent
            if p is None:
                yield fi.node

    def scopes(self, node: ast.AST) -> list:
        """Scope keys from function `node` outward, module last."""
        out, fi = [], self.info(node)
        while fi is not None:
            out.append(id(fi.node))
            fi = fi.parent
        return out + [None]

    def positions(self, call: ast.Call, scopes=(None,)) -> tuple[int, ...]:
        """Positional arguments `call` updates in place, () if none;
        `scopes` are the enclosing scopes, innermost first."""
        name = call_name(call)
        for scope in scopes:
            if (scope, name) in self.in_place:
                return self.in_place[(scope, name)]
        if name in self.in_place_calls and \
                _is_const(_keyword(call, "in_place"), True):
            return self.in_place_calls[name]
        return ()


class _Collector(ast.NodeVisitor):
    def __init__(self, ctx: TorchContext, hot_methods: tuple[str, ...],
                 factories: dict[str, tuple[int, ...]]):
        self.ctx = ctx
        self.hot_methods = hot_methods
        self.factories = factories
        self.func_stack: list[FuncInfo] = []
        self.class_depth = 0
        self.compile_args: set[str] = set()

    # -- structure ---------------------------------------------------------
    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.class_depth += 1
        self.generic_visit(node)
        self.class_depth -= 1

    def _visit_func(self, node) -> None:
        fi = FuncInfo(node=node,
                      parent=self.func_stack[-1] if self.func_stack else None,
                      in_class=self.class_depth > 0 and not self.func_stack)
        self.ctx.functions.append(fi)
        self.ctx._by_node[id(node)] = fi
        for dec in node.decorator_list:
            if is_compile_ref(dec) or is_compile_call(dec) is not None:
                fi.hot = True
        if fi.in_class and node.name in self.hot_methods:
            fi.hot = True
        self.func_stack.append(fi)
        self.generic_visit(node)
        self.func_stack.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    # -- capture blocks ----------------------------------------------------
    def _visit_with(self, node) -> None:
        if any(_is_graph_capture(item.context_expr) for item in node.items):
            for stmt in node.body:
                for sub in ast.walk(stmt):
                    if isinstance(sub, ast.Call):
                        name = call_name(sub)
                        if name is not None:
                            self.ctx.captured_names.add(name)
        self.generic_visit(node)

    visit_With = _visit_with
    visit_AsyncWith = _visit_with

    # -- wrapping / factory calls -------------------------------------------
    def visit_Assign(self, node: ast.Assign) -> None:
        names = [t.id if isinstance(t, ast.Name) else t.attr
                 for t in node.targets
                 if isinstance(t, (ast.Name, ast.Attribute))]
        cc = is_compile_call(node.value)
        if cc is not None and not _is_partial_ref(cc.func):
            for a in cc.args[:1]:
                if isinstance(a, ast.Name):
                    self.compile_args.add(a.id)
        if isinstance(node.value, ast.Call):
            fac = call_name(node.value)
            if fac in self.factories:
                pos = () if _is_const(_keyword(node.value, "donate"),
                                      False) else self.factories[fac]
                scope = id(self.func_stack[-1].node) if self.func_stack \
                    else None
                for n in names:
                    self.ctx.in_place[(scope, n)] = pos
        self.generic_visit(node)


def analyze(tree: ast.Module, hot_methods: tuple[str, ...] = (),
            hot_functions: tuple[str, ...] = (),
            in_place_calls: dict[str, tuple[int, ...]] | None = None,
            in_place_factories: dict[str, tuple[int, ...]] | None = None
            ) -> TorchContext:
    """Compute the TorchContext for one parsed module."""
    ctx = TorchContext(in_place_calls=dict(in_place_calls or {}))
    col = _Collector(ctx, hot_methods, dict(in_place_factories or {}))
    col.visit(tree)
    marked = col.compile_args | ctx.captured_names | set(hot_functions)
    for fi in ctx.functions:
        if fi.node.name in marked:
            fi.hot = True
    # nesting: anything inside a hot function is hot
    changed = True
    while changed:
        changed = False
        for fi in ctx.functions:
            if not fi.hot and fi.parent is not None and fi.parent.hot:
                fi.hot = True
                changed = True
    return ctx
