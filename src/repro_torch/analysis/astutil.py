"""Small AST helpers shared by the boundary and trace-hygiene passes.

The gradient producers (the PB102 sources) are PyTorch's: the
``torch.autograd.grad`` call, ``.grad`` read after a ``.backward()`` call
in the same function, the ``torch.func`` transforms (``grad``,
``grad_and_value``, ``vjp``, ``jacrev``, ``jacfwd``), and the port's own
autograd wrappers (``_value_and_grad`` in ``core/async_engine.py`` and
``core/cascade.py``; ``plain_backward`` in ``kernels/_plain_grad.py``)."""

from __future__ import annotations

import ast
import dataclasses
import typing


def dotted(node: ast.AST) -> str | None:
    """Render ``a.b.c`` / ``name`` call targets; None for anything else."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted(node.value)
        return None if base is None else f"{base}.{node.attr}"
    return None


def call_name(node: ast.Call) -> str | None:
    return dotted(node.func)


def attr_of_call(node: ast.Call) -> str | None:
    """Final attribute name of the callee (``adapter.client_embed`` -> ``client_embed``)."""
    if isinstance(node.func, ast.Attribute):
        return node.func.attr
    if isinstance(node.func, ast.Name):
        return node.func.id
    return None


@dataclasses.dataclass
class TagInfo:
    """Tags parsed off a function's decorator list."""

    party: str | None = None
    wires: list[dict[str, str]] = dataclasses.field(default_factory=list)
    accounting: bool = False
    hot_loop: bool = False
    host_boundary: str | None = None


def _deco_tag_name(deco: ast.expr) -> tuple[str | None, ast.Call | None]:
    """Return (tag name, call node) if the decorator resolves into tags.*."""
    call = deco if isinstance(deco, ast.Call) else None
    target = deco.func if isinstance(deco, ast.Call) else deco
    name = dotted(target)
    if name is None:
        return None, None
    leaf = name.rsplit(".", 1)[-1]
    known = {"party", "wire", "accounting", "hot_loop", "host_boundary"}
    if leaf not in known:
        return None, None
    # Accept `tags.wire`, `analysis.tags.wire`, and bare `wire` (fixtures
    # import the decorators directly).
    if "." in name and ".tags." not in f".{name}":
        return None, None
    return leaf, call


def parse_tags(fn: ast.FunctionDef | ast.AsyncFunctionDef) -> TagInfo:
    info = TagInfo()
    for deco in fn.decorator_list:
        leaf, call = _deco_tag_name(deco)
        if leaf is None:
            continue
        if leaf == "accounting":
            info.accounting = True
        elif leaf == "hot_loop":
            info.hot_loop = True
        elif leaf == "party" and call is not None and call.args:
            arg = call.args[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                info.party = arg.value
        elif leaf == "host_boundary" and call is not None and call.args:
            arg = call.args[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                info.host_boundary = arg.value
        elif leaf == "wire" and call is not None:
            spec: dict[str, str] = {}
            if call.args and isinstance(call.args[0], ast.Constant):
                spec["direction"] = str(call.args[0].value)
            for kw in call.keywords:
                if kw.arg and isinstance(kw.value, ast.Constant):
                    spec[kw.arg] = str(kw.value.value)
            info.wires.append(spec)
    return info


@dataclasses.dataclass
class FuncInfo:
    """A function definition plus its enclosing-def chain and parsed tags."""

    node: ast.FunctionDef | ast.AsyncFunctionDef
    qualname: str
    chain: tuple[ast.FunctionDef | ast.AsyncFunctionDef, ...]  # outermost first
    tags: TagInfo

    def chain_tags(self) -> list[TagInfo]:
        return [parse_tags(f) for f in self.chain] + [self.tags]

    def wire_spec(self, direction: str) -> dict[str, str] | None:
        """The innermost matching wire declaration covering this function."""
        for t in reversed(self.chain_tags()):
            for spec in t.wires:
                if spec.get("direction") == direction:
                    return spec
        return None

    def party(self) -> str | None:
        for t in reversed(self.chain_tags()):
            if t.party is not None:
                return t.party
        return None


def index_functions(tree: ast.Module) -> list[FuncInfo]:
    """All function defs (any nesting depth) with enclosing chains."""
    out: list[FuncInfo] = []

    def visit(node: ast.AST, chain: tuple, prefix: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}{child.name}"
                out.append(FuncInfo(child, qual, chain, parse_tags(child)))
                visit(child, chain + (child,), f"{qual}.")
            elif isinstance(child, ast.ClassDef):
                visit(child, chain, f"{prefix}{child.name}.")
            else:
                visit(child, chain, prefix)

    visit(tree, (), "")
    return out


def walk_body(
    fn: ast.FunctionDef | ast.AsyncFunctionDef,
    *,
    into_nested: bool = False,
) -> typing.Iterator[ast.AST]:
    """Walk a function body, optionally stopping at nested function defs."""
    stack: list[ast.AST] = list(fn.body)
    while stack:
        node = stack.pop()
        yield node
        if not into_nested and isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
        ):
            continue
        stack.extend(ast.iter_child_nodes(node))


def names_in(node: ast.AST) -> set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def assigned_names(target: ast.expr) -> set[str]:
    """Names bound by an assignment target (tuple unpacking included)."""
    out: set[str] = set()
    for n in ast.walk(target):
        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store):
            out.add(n.id)
    return out


# ``torch.func`` transforms whose result is gradient-typed
FUNC_GRADIENTS: frozenset[str] = frozenset(
    {"grad", "grad_and_value", "vjp", "jacrev", "jacfwd"}
)
# the port's autograd wrappers that return gradient trees
PORT_GRADIENTS: frozenset[str] = frozenset({"_value_and_grad", "plain_backward"})


def is_gradient_source(node: ast.AST) -> bool:
    """``torch.autograd.grad`` / ``torch.func.grad`` / ... or one of the
    port's gradient wrappers, referenced anywhere (a call or a value)."""
    name = dotted(node) if isinstance(node, (ast.Attribute, ast.Name)) else None
    if name is None:
        return False
    if name in PORT_GRADIENTS or name.rsplit(".", 1)[-1] in PORT_GRADIENTS:
        return True
    if name.endswith("autograd.grad"):
        return True
    base, _, leaf = name.rpartition(".")
    return leaf in FUNC_GRADIENTS and base.split(".")[-1] in ("func", "functorch")


def is_backward_call(node: ast.AST) -> bool:
    """``<expr>.backward(...)``: every later ``.grad`` read in the function
    is gradient-typed."""
    return (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Attribute)
        and node.func.attr == "backward"
    )


def is_grad_read(node: ast.AST) -> bool:
    return (
        isinstance(node, ast.Attribute)
        and node.attr == "grad"
        and isinstance(node.ctx, ast.Load)
    )
