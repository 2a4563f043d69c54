"""Trace-hygiene rules (TH2xx), recast for PyTorch and CUDA graphs.

The port replaces the JAX package's compiled scans with CUDA graphs of one
step (:class:`repro_torch.graphs.StepGraph`): the step's Python body runs
once eagerly, once under capture, and never again; a replay launches what
the capture recorded. So a host sync in the steady state stalls the
device, a Python branch on a tensor's value is decided once at capture
and replayed forever, and a print runs at capture only.

TH201  host sync in serve-plane hot code: ``.item()``, ``.tolist()``,
       ``.cpu()``, ``.numpy()``, ``.to("cpu")``,
       ``torch.cuda.synchronize()`` inside for/while loops of the hot
       modules (``HOT_MODULES``), and — in ``@tags.hot_loop`` bodies —
       anywhere, plus ``float()/int()/bool()`` coercions (in a hot
       module's loop only of an expression that is visibly a tensor: a
       ``torch.*`` call or a reduction method's result).
TH202  Python branch (``if``/``while``/ternary/``assert``) on a value
       derived from the arguments of a function that a ``StepGraph``
       captures (directly, through a lambda, or through a helper that
       passes its argument on to ``StepGraph``) or that is marked
       ``@tags.hot_loop``. Shape/dtype/None checks are static and stay
       legal.
TH203  literal-dtype cast (``.to(torch.float32)``, ``.float()``,
       ``.half()``, ``.bfloat16()``, ``.double()``) in the value written
       into a captured step's carried buffer (an argument the step
       updates in place with ``copy_``/``index_put_``/an indexed store,
       or rebinds): anchor to the buffer's dtype (``.to(buf.dtype)``) so
       a model run in another precision keeps the buffer's dtype stable.
TH204  leftover debug instrumentation: ``breakpoint()`` /
       ``pdb.set_trace()`` anywhere, ``print`` inside captured or hot
       code.
"""

from __future__ import annotations

import ast
import typing

from repro_torch.analysis import tags
from repro_torch.analysis.astutil import (
    FuncInfo,
    attr_of_call,
    call_name,
    dotted,
    index_functions,
)
from repro_torch.analysis.findings import Finding

# Modules whose every function is serve-plane hot code: host syncs inside
# for/while loops are flagged without @tags.hot_loop. (The wire plane's
# worker and backends serialize frames on the host by design.)
HOT_MODULES: tuple[str, ...] = (
    "federation/scheduler.py",
    "federation/serving.py",
    "launch/serve.py",
    "graphs.py",
)
HOST_SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
HOST_SYNC_FUNCS = frozenset({"torch.cuda.synchronize"})
# methods whose result is a tensor (a coercion of it syncs the host)
_TENSOR_REDUCTIONS = frozenset(
    {"sum", "max", "min", "mean", "any", "all", "argmax", "argmin", "norm",
     "prod", "count_nonzero"}
)
_CAPTURE = "StepGraph"
_LITERAL_CASTS = frozenset({"float", "half", "bfloat16", "double"})
_INPLACE_WRITES = frozenset({"copy_", "index_put_", "index_copy_"})
_STATIC_ATTRS = frozenset(
    {"shape", "ndim", "dtype", "device", "is_cuda", "layout",
     "requires_grad"}
)
_STATIC_CALLS = frozenset(
    {"isinstance", "len", "hasattr", "callable", "getattr", "type", "dim",
     "size", "numel", "is_floating_point"}
)


# ---------------------------------------------------------------------------
# what a StepGraph captures
# ---------------------------------------------------------------------------


def _capture_wrappers(funcs: list[FuncInfo]) -> set[str]:
    """Functions that hand one of their own arguments to ``StepGraph`` as
    its body (``def _capture(self, body): return StepGraph(body, ...)``)."""
    out: set[str] = set()
    for fi in funcs:
        args = fi.node.args
        params = {a.arg for a in args.posonlyargs + args.args + args.kwonlyargs}
        for node in ast.walk(fi.node):
            if (
                isinstance(node, ast.Call)
                and attr_of_call(node) == _CAPTURE
                and node.args
                and isinstance(node.args[0], ast.Name)
                and node.args[0].id in params
            ):
                out.add(fi.node.name)
    return out


def _body_names(arg: ast.expr) -> list[str]:
    """The local function names a capture's body argument stands for: a
    name, or the functions a lambda calls."""
    if isinstance(arg, ast.Lambda):
        return [
            n.func.id
            for n in ast.walk(arg.body)
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
        ]
    name = dotted(arg)
    return [name.rsplit(".", 1)[-1]] if name else []


def find_captured(tree: ast.Module, funcs: list[FuncInfo]) -> dict[str, str]:
    """Local function name -> why its body is steady-state code
    ("captured" by a StepGraph, or "hot_loop")."""
    transforms = {_CAPTURE} | _capture_wrappers(funcs)
    out: dict[str, str] = {}
    for node in ast.walk(tree):
        if (
            isinstance(node, ast.Call)
            and attr_of_call(node) in transforms
            and node.args
        ):
            for name in _body_names(node.args[0]):
                out[name] = "captured"
    for fi in funcs:
        if fi.tags.hot_loop:
            out.setdefault(fi.node.name, "hot_loop")
    return out


def _body_statements(
    fn: ast.FunctionDef | ast.AsyncFunctionDef,
) -> typing.Iterator[ast.stmt]:
    stack: list[ast.stmt] = list(reversed(fn.body))
    while stack:
        stmt = stack.pop()
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            continue
        yield stmt
        children: list[ast.stmt] = []
        for field in ("body", "orelse", "finalbody"):
            children.extend(getattr(stmt, field, []) or [])
        for handler in getattr(stmt, "handlers", []) or []:
            children.extend(handler.body)
        stack.extend(reversed(children))


def _walk_no_nested_defs(stmts: typing.Iterable[ast.stmt]) -> typing.Iterator[ast.AST]:
    for stmt in stmts:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            continue
        stack: list[ast.AST] = [stmt]
        while stack:
            node = stack.pop()
            yield node
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                continue
            stack.extend(ast.iter_child_nodes(node))


# ---------------------------------------------------------------------------
# TH201 — host syncs in hot code
# ---------------------------------------------------------------------------


def _visibly_tensor(node: ast.AST) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Call):
            name = call_name(n) or ""
            if name.startswith("torch."):
                return True
            if isinstance(n.func, ast.Attribute) and n.func.attr in _TENSOR_REDUCTIONS:
                return True
    return False


def _is_to_cpu(node: ast.Call) -> bool:
    if not (isinstance(node.func, ast.Attribute) and node.func.attr == "to"):
        return False
    args = list(node.args) + [kw.value for kw in node.keywords if kw.arg == "device"]
    return any(isinstance(a, ast.Constant) and a.value == "cpu" for a in args)


def _host_sync_kind(node: ast.Call, *, in_hot_loop: bool) -> str | None:
    name = call_name(node)
    leaf = attr_of_call(node)
    if name in HOST_SYNC_FUNCS:
        return f"host sync `{name}()`"
    if isinstance(node.func, ast.Attribute) and leaf in HOST_SYNC_METHODS:
        return f"device->host `.{leaf}()`"
    if _is_to_cpu(node):
        return "device->host `.to(\"cpu\")`"
    if (
        isinstance(node.func, ast.Name)
        and node.func.id in tags.HOST_SYNC_BUILTINS
        and node.args
        and not isinstance(node.args[0], ast.Constant)
        and (in_hot_loop or _visibly_tensor(node.args[0]))
    ):
        return f"device->host `{node.func.id}()` coercion"
    return None


def _check_host_syncs(
    fi: FuncInfo, path: str, hot_module: bool, findings: list[Finding]
) -> None:
    chain = fi.chain_tags()
    if any(t.host_boundary for t in chain):
        return

    def flag(call: ast.Call, kind: str, where: str) -> None:
        findings.append(
            Finding(
                "TH201",
                path,
                call.lineno,
                f"{kind} {where} — steady-state decode must stay on device "
                "(hoist out of the loop, batch per wave, or mark a "
                "@tags.host_boundary with justification)",
            )
        )

    if any(t.hot_loop for t in chain):
        for node in _walk_no_nested_defs(fi.node.body):
            if isinstance(node, ast.Call):
                kind = _host_sync_kind(node, in_hot_loop=True)
                if kind:
                    flag(node, kind, "in a @tags.hot_loop body")
        return
    if hot_module:
        for stmt in _body_statements(fi.node):
            if isinstance(stmt, (ast.For, ast.While)):
                for node in _walk_no_nested_defs(stmt.body + stmt.orelse):
                    if isinstance(node, ast.Call):
                        kind = _host_sync_kind(node, in_hot_loop=False)
                        if kind:
                            flag(node, kind, "inside a serve-plane loop")


# ---------------------------------------------------------------------------
# TH202 — Python branching on tensor values in steady-state code
# ---------------------------------------------------------------------------


def _static_occurrence_ids(cond: ast.AST) -> set[int]:
    ok: set[int] = set()
    for n in ast.walk(cond):
        if isinstance(n, ast.Attribute) and n.attr in _STATIC_ATTRS:
            ok.update(id(x) for x in ast.walk(n))
        elif isinstance(n, ast.Call) and attr_of_call(n) in _STATIC_CALLS:
            ok.update(id(x) for x in ast.walk(n))
        elif isinstance(n, ast.Compare) and any(
            isinstance(c, ast.Constant) and c.value is None for c in n.comparators
        ):
            ok.update(id(x) for x in ast.walk(n))
    return ok


def _tainted_occurrence(node: ast.AST, tainted: set[str]) -> ast.Name | None:
    static = _static_occurrence_ids(node)
    for n in ast.walk(node):
        if (
            isinstance(n, ast.Name)
            and isinstance(n.ctx, ast.Load)
            and n.id in tainted
            and id(n) not in static
        ):
            return n
    return None


def _params(fi: FuncInfo) -> list[str]:
    args = fi.node.args
    return [
        a.arg
        for a in args.posonlyargs + args.args + args.kwonlyargs
        if a.arg != "self"
    ]


def _check_branches(
    fi: FuncInfo, path: str, why: str, findings: list[Finding]
) -> None:
    tainted = set(_params(fi))
    for stmt in _body_statements(fi.node):
        value = getattr(stmt, "value", None)
        if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)) and value is not None:
            if _tainted_occurrence(value, tainted) is not None:
                for t in ast.walk(stmt):
                    if isinstance(t, ast.Name) and isinstance(t.ctx, ast.Store):
                        tainted.add(t.id)
        conds: list[ast.expr] = []
        if isinstance(stmt, (ast.If, ast.While, ast.Assert)):
            conds.append(stmt.test)
        for node in _walk_no_nested_defs([stmt]):
            if isinstance(node, ast.IfExp):
                conds.append(node.test)
        for cond in conds:
            hit = _tainted_occurrence(cond, tainted)
            if hit is not None:
                findings.append(
                    Finding(
                        "TH202",
                        path,
                        cond.lineno,
                        f"Python branch on tensor value `{hit.id}` inside a "
                        f"{why} function — decided once at capture and "
                        "replayed forever; use torch.where or hoist to a "
                        "value fixed at capture",
                    )
                )


# ---------------------------------------------------------------------------
# TH203 — literal-dtype casts into carried buffers
# ---------------------------------------------------------------------------


def _literal_casts(node: ast.AST) -> typing.Iterator[ast.Call]:
    """``.to(<literal dtype>)`` / ``.float()`` / ... not anchored to a
    runtime ``.dtype``."""
    for n in ast.walk(node):
        if not (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)):
            continue
        if n.func.attr in _LITERAL_CASTS and not n.args:
            yield n
        elif n.func.attr == "to":
            args = list(n.args) + [kw.value for kw in n.keywords if kw.arg == "dtype"]
            if any(
                isinstance(a, ast.Attribute)
                and a.attr != "dtype"
                and (dotted(a.value) or "").endswith("torch")
                for a in args
            ):
                yield n


def _root_name(node: ast.AST) -> str | None:
    while isinstance(node, (ast.Subscript, ast.Attribute)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _check_carry_dtype(fi: FuncInfo, path: str, findings: list[Finding]) -> None:
    carry = set(_params(fi))
    for stmt in _body_statements(fi.node):
        if (
            isinstance(stmt, ast.Assign)
            and isinstance(stmt.value, (ast.Name, ast.Subscript))
            and _root_name(stmt.value) in carry
        ):
            for t in stmt.targets:
                if isinstance(t, ast.Name):
                    carry.add(t.id)

    def flag(call: ast.Call) -> None:
        findings.append(
            Finding(
                "TH203",
                path,
                call.lineno,
                "literal-dtype cast written into a captured step's carried "
                "buffer — anchor to the buffer's dtype (`.to(buf.dtype)`) "
                "so the buffer's dtype cannot flip when the model runs in "
                "another precision",
            )
        )

    for stmt in _body_statements(fi.node):
        values: list[ast.AST] = []
        if isinstance(stmt, (ast.Assign, ast.AugAssign)):
            targets = stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
            if any(_root_name(t) in carry for t in targets):
                values.append(stmt.value)
        for node in _walk_no_nested_defs([stmt]):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _INPLACE_WRITES
                and _root_name(node.func.value) in carry
            ):
                values.extend(node.args)
        for value in values:
            for call in _literal_casts(value):
                flag(call)


# ---------------------------------------------------------------------------
# TH204 — leftover debug instrumentation
# ---------------------------------------------------------------------------


def _check_debug_leftovers(
    tree: ast.Module, path: str, steady: dict[str, str],
    funcs: list[FuncInfo], findings: list[Finding],
) -> None:
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            name = call_name(node) or ""
            if name == "breakpoint" or name.endswith("pdb.set_trace"):
                findings.append(
                    Finding("TH204", path, node.lineno, f"leftover `{name}()` call")
                )
    for fi in funcs:
        why = steady.get(fi.node.name)
        if why is None:
            continue
        for node in _walk_no_nested_defs(fi.node.body):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id == "print"
            ):
                findings.append(
                    Finding(
                        "TH204", path, node.lineno,
                        f"`print()` inside a {why} function — a captured "
                        "step prints once, at capture, never on replay; "
                        "remove before shipping",
                    )
                )


def check_module(path: str, tree: ast.Module) -> list[Finding]:
    findings: list[Finding] = []
    funcs = index_functions(tree)
    steady = find_captured(tree, funcs)
    hot_module = any(path.endswith(m) for m in HOT_MODULES)
    for fi in funcs:
        _check_host_syncs(fi, path, hot_module, findings)
        why = steady.get(fi.node.name)
        if why is not None:
            _check_branches(fi, path, why, findings)
            if why == "captured":
                _check_carry_dtype(fi, path, findings)
    _check_debug_leftovers(tree, path, steady, funcs, findings)
    return findings
