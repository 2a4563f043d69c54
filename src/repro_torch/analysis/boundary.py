"""Party-boundary leak rules (PB1xx).

An intraprocedural, order-sensitive taint pass per function definition.
Party ownership and legal wire channels come from ``analysis.tags``: the
decorators applied in source (read off the AST — analyzed modules are never
imported) plus the attribute-name registries for adapter hooks that exist
only as closures on ``ModelAdapter`` fields.

Rule catalogue
--------------
PB101  client-sourced value reaches a server-side call without a
       ``@tags.wire("up", ...)`` declaration on the enclosing function.
PB102  gradient-typed value (result of torch.autograd.grad, a ``.grad``
       read after ``.backward()``, torch.func.grad / grad_and_value / vjp
       / jac*, or the port's ``_value_and_grad`` / ``plain_backward``)
       flows client-ward — passed to a client hook or returned from
       client-party code — without a ``@tags.wire("down", ...)``.
PB103  raw client features referenced inside server-party code.
PB104  wire declaration whose ``accounted_by`` does not name an existing
       ``@tags.accounting`` method (the channel would be unmetered).
PB105  server-evaluated losses fed to a ZOO gradient estimator without
       passing through ``Transport.downlink`` (bypasses DP noise + ledger).
"""

from __future__ import annotations

import ast
import typing

from repro_torch.analysis import tags
from repro_torch.analysis.astutil import (
    FuncInfo,
    attr_of_call,
    index_functions,
    is_backward_call,
    is_grad_read,
    is_gradient_source,
)
from repro_torch.analysis.findings import Finding


def collect_accounting(trees: dict[str, ast.Module]) -> set[str]:
    """Project-wide ``Class.method`` qualnames tagged ``@tags.accounting``."""
    out: set[str] = set()
    for tree in trees.values():
        for fi in index_functions(tree):
            if fi.tags.accounting:
                out.add(fi.qualname)
    return out


def _is_client_source_call(node: ast.Call) -> bool:
    attr = attr_of_call(node)
    return attr in tags.CLIENT_SOURCE_ATTRS


def _is_server_sink_call(node: ast.Call) -> bool:
    attr = attr_of_call(node)
    return attr in tags.SERVER_SINK_ATTRS


def _is_client_param_read(node: ast.AST) -> bool:
    return (
        isinstance(node, ast.Subscript)
        and isinstance(node.slice, ast.Constant)
        and node.slice.value in tags.CLIENT_PARAM_KEYS
    )


def _is_loss_source(node: ast.AST) -> bool:
    if isinstance(node, ast.Attribute) and node.attr in tags.SERVER_LOSS_NAMES:
        return True
    return isinstance(node, ast.Name) and node.id in tags.SERVER_LOSS_NAMES


def _contains(node: ast.AST, pred: typing.Callable[[ast.AST], bool]) -> bool:
    return any(pred(n) for n in ast.walk(node))


def _contains_tainted(node: ast.AST, tainted: set[str]) -> bool:
    return any(
        isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load) and n.id in tainted
        for n in ast.walk(node)
    )


def _is_downlink_call(node: ast.AST) -> bool:
    return (
        isinstance(node, ast.Call)
        and attr_of_call(node) in tags.DOWNLINK_SANITIZERS
    )


def _store_names(stmt: ast.stmt) -> set[str]:
    out: set[str] = set()
    targets: list[ast.expr] = []
    if isinstance(stmt, ast.Assign):
        targets = stmt.targets
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)) and stmt.target is not None:
        targets = [stmt.target]
    for t in targets:
        for n in ast.walk(t):
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store):
                out.add(n.id)
    return out


def _iter_statements(body: list[ast.stmt]) -> typing.Iterator[ast.stmt]:
    """Statements in source order, not descending into nested defs."""
    for stmt in body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            continue
        yield stmt
        for field in ("body", "orelse", "finalbody"):
            sub = getattr(stmt, field, None)
            if sub:
                yield from _iter_statements(sub)
        for handler in getattr(stmt, "handlers", []) or []:
            yield from _iter_statements(handler.body)


class _FunctionTaint:
    """Order-sensitive taint state for one function body."""

    def __init__(self, fi: FuncInfo, path: str, accounting: set[str]) -> None:
        self.fi = fi
        self.path = path
        self.accounting = accounting
        self.client: set[str] = set()
        self.grad: set[str] = set()
        self.loss: set[str] = set()
        # a ``.backward()`` call seen: later ``.grad`` reads are gradients
        self.backward = False
        self.findings: list[Finding] = []

    # -- sources -----------------------------------------------------------
    def _expr_client(self, node: ast.AST) -> bool:
        return (
            _contains(node, lambda n: isinstance(n, ast.Call) and _is_client_source_call(n))
            or _contains(node, _is_client_param_read)
            or _contains_tainted(node, self.client)
        )

    def _expr_grad(self, node: ast.AST) -> bool:
        return (
            _contains(node, is_gradient_source)
            or (self.backward and _contains(node, is_grad_read))
            or _contains_tainted(node, self.grad)
        )

    def _expr_loss(self, node: ast.AST) -> bool:
        return _contains(node, _is_loss_source) or _contains_tainted(node, self.loss)

    # -- declarations ------------------------------------------------------
    def _wire(self, direction: str) -> dict[str, str] | None:
        return self.fi.wire_spec(direction)

    def _flag(self, node: ast.AST, rule: str, msg: str) -> None:
        self.findings.append(Finding(rule, self.path, node.lineno, msg))

    # -- sink checks -------------------------------------------------------
    def _check_call(self, call: ast.Call) -> None:
        attr = attr_of_call(call)
        args = list(call.args) + [kw.value for kw in call.keywords]
        if _is_server_sink_call(call):
            crossing = any(self._expr_client(a) for a in args)
            if crossing and self._wire("up") is None:
                self._flag(
                    call,
                    "PB101",
                    f"client-sourced value flows into server-side `{attr}` "
                    "without a @tags.wire(\"up\", ...) declaration on the "
                    "enclosing function",
                )
        if attr in tags.CLIENT_SOURCE_ATTRS or (
            attr is not None and attr.startswith("client_") and attr not in tags.DOWNLINK_CONSUMERS
        ):
            if any(self._expr_grad(a) for a in args) and self._wire("down") is None:
                self._flag(
                    call,
                    "PB102",
                    f"gradient-typed value passed into client-side `{attr}` "
                    "without a @tags.wire(\"down\", ...) declaration",
                )
        if attr in tags.DOWNLINK_CONSUMERS:
            dirty = [
                a
                for a in args
                if self._expr_loss(a) and not _contains(a, _is_downlink_call)
            ]
            if dirty:
                self._flag(
                    call,
                    "PB105",
                    f"server-evaluated losses reach `{attr}` without passing "
                    "through Transport.downlink (DP noise + ledger bypassed)",
                )

    def _check_return(self, stmt: ast.Return) -> None:
        if stmt.value is None:
            return
        party = self.fi.party()
        clientward = party == "client" or self.fi.node.name.startswith("client_")
        if clientward and self._expr_grad(stmt.value) and self._wire("down") is None:
            self._flag(
                stmt,
                "PB102",
                "gradient-typed value returned from client-party code "
                "without a @tags.wire(\"down\", ...) declaration",
            )

    def _check_raw_features(self, stmt: ast.stmt) -> None:
        party = self.fi.party()
        serverside = party == "server" or self.fi.node.name.startswith("server_")
        if not serverside:
            return
        for n in ast.walk(stmt):
            if (
                isinstance(n, ast.Name)
                and isinstance(n.ctx, ast.Load)
                and n.id in tags.RAW_FEATURE_PARAMS
            ):
                self._flag(
                    n,
                    "PB103",
                    f"raw client feature `{n.id}` referenced inside "
                    "server-party code",
                )

    # -- driver ------------------------------------------------------------
    def run(self) -> list[Finding]:
        self._check_wire_accounting()
        for stmt in _iter_statements(self.fi.node.body):
            for n in ast.walk(stmt):
                if isinstance(n, ast.Call):
                    self._check_call(n)
            if _contains(stmt, is_backward_call):
                self.backward = True
            if isinstance(stmt, ast.Return):
                self._check_return(stmt)
            self._check_raw_features(stmt)
            self._apply_assignment(stmt)
        return self.findings

    def _apply_assignment(self, stmt: ast.stmt) -> None:
        value = getattr(stmt, "value", None)
        names = _store_names(stmt)
        if value is None or not names:
            return
        if _contains(value, _is_downlink_call):
            # Rebinding through Transport.downlink launders loss taint:
            # the channel adds DP noise and meters the release.
            self.loss -= names
        elif self._expr_loss(value):
            self.loss |= names
        if self._expr_client(value):
            self.client |= names
        if self._expr_grad(value):
            self.grad |= names

    def _check_wire_accounting(self) -> None:
        for spec in self.fi.tags.wires:
            target = spec.get("accounted_by", "")
            if target not in self.accounting:
                self._flag(
                    self.fi.node,
                    "PB104",
                    f"wire declaration names accounted_by={target!r}, which "
                    "is not an existing @tags.accounting method — the "
                    "channel would be unmetered",
                )


def check_module(
    path: str, tree: ast.Module, accounting: set[str]
) -> list[Finding]:
    findings: list[Finding] = []
    for fi in index_functions(tree):
        findings.extend(_FunctionTaint(fi, path, accounting).run())
    return findings
