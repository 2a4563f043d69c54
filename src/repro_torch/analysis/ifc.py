"""Information-flow certifier over traced torch graphs (IF301–IF303).

The AST taint pass (``boundary.py``) checks the party boundary on the
*source text*: it trusts ``@tags`` annotations and cannot see through
closures or adapter indirection. This pass proves the claim on the
*traced program*: ``make_fx`` in real mode over a real step closure
(every aten op the step runs, the backward of its
``torch.autograd.grad`` calls included, one node each), then one forward
taint pass over the graph's nodes, anchored on the marks of
``marks.py``:

* ``repro_torch::wire_boundary(kind, direction)`` — the one legal
  crossing point (``Transport.downlink``, the engine's uplink fan-outs,
  the serve plane's embed/token hops);
* ``repro_torch::dp_noise`` — a configured ``GaussianLossChannel`` just
  noised the operand;
* ``repro_torch::grad_mark`` — the operand derives from first-order
  cotangents of server parameters.

Taint lattice: each value carries a set of labels from {``server``,
``grad``, ``dp``}. Inputs labelled ``server`` seed the pass (the caller
maps tree paths to parties); ``grad_mark`` adds ``grad``; ``dp_noise``
*replaces* taint with ``dp`` (the noised value is what DP releases);
``wire_boundary`` records the crossing (payload kind, direction, shape
and dtype read off the graph, and the incoming taint) and clears taint
(whatever legally crossed is the sanctioned release).

The graph keeps PyTorch's mutations and views (functionalization cannot
take the autograd Function the marks compose through, and leaves the
collectives mutating anyway), so the pass follows buffers as well as
values:

* every op maps the join of all its inputs (tensors, index lists, a
  ``torch.where`` predicate) to all its outputs — a kernel's custom op, a
  collective or any op the pass does not know included; a Python loop is
  unrolled by the trace, so no fixpoint is needed;
* an output that aliases an input (a view, an in-place op's result)
  shares the input's buffer;
* an op that writes an argument (its schema's ``alias_info.is_write``,
  or an in-place name, ``*_``, outside aten: the c10d collectives) joins
  its input taints into that argument's buffer, every alias of it
  included, and later reads see them;
* a trace that stops on a data-dependent host read (``.item()``, a Python
  branch on a tensor) is reported (:attr:`IFCReport.stopped`, IF302):
  the flow it hides cannot be certified.

Rules (evaluated by :func:`check_flows` on the analysis report):

* **IF301** — no client-bound output may carry ``grad`` taint: nothing
  derived from server-parameter cotangents reaches a client except
  through the wire bottleneck (which launders taint by construction).
* **IF302** — every server->client flow must factor through a
  ``wire_boundary`` crossing, and every *downlink* crossing must be the
  scalar bottleneck the paper claims: at most ``(1+q)·block`` loss
  scalars (or ``batch`` token ids for the serve plane) per round, shape
  read off the graph, not asserted.
* **IF303** — when a DP channel is configured, every loss downlink
  crossing must be noise-dominated: its operand carries ``dp`` taint and
  no raw ``server`` taint (noise added *before* the wire).

IF304 (wire-plane cross-checks) lives in ``certify.py``.
"""
from __future__ import annotations

import dataclasses
import operator
from typing import (Any, Callable, Dict, FrozenSet, List, Mapping, Optional,
                    Sequence, Tuple)

import torch
from torch._guards import TracingContext, tracing
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.fx.experimental.proxy_tensor import make_fx

from repro_torch.analysis import marks
from repro_torch.analysis.findings import Finding

SERVER = "server"
GRAD = "grad"
DP = "dp"

Taint = FrozenSet[str]
_EMPTY: Taint = frozenset()

# the message make_fx raises on a host read of a traced tensor
_HOST_READ = "_local_scalar_dense"


@dataclasses.dataclass(frozen=True)
class Crossing:
    """One ``wire_boundary`` node encountered in the traced program."""
    kind: str              # "emb" | "loss" | "token"
    direction: str         # "up" | "down"
    shape: Tuple[int, ...]
    dtype: str
    taint: Taint           # taint of the operand AT the crossing

    @property
    def size(self) -> int:
        n = 1
        for d in self.shape:
            n *= int(d)
        return n

    def to_json(self) -> Dict[str, Any]:
        return {"kind": self.kind, "direction": self.direction,
                "shape": list(self.shape), "dtype": self.dtype,
                "elements": self.size, "taint": sorted(self.taint)}


@dataclasses.dataclass
class IFCReport:
    """Result of the taint pass over one traced closure. ``stopped`` is
    the trace's error where it stopped on a data-dependent host read
    (then nothing else is known); ``graph`` the traced ``GraphModule``."""
    out_taints: List[Taint]
    crossings: List[Crossing]
    n_dp_eqns: int
    stopped: Optional[str] = None
    graph: Any = dataclasses.field(default=None, repr=False, compare=False)

    def down(self, kind: Optional[str] = None) -> List[Crossing]:
        return [c for c in self.crossings if c.direction == "down"
                and (kind is None or c.kind == kind)]

    def up(self) -> List[Crossing]:
        return [c for c in self.crossings if c.direction == "up"]

    def to_json(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "out_taints": [sorted(t) for t in self.out_taints],
            "crossings": [c.to_json() for c in self.crossings],
            "n_dp_eqns": self.n_dp_eqns,
        }
        if self.stopped is not None:
            out["stopped"] = self.stopped
        return out


# ------------------------------------------------------------- the walk ---

def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _nodes_in(x: Any) -> List[torch.fx.Node]:
    """The graph nodes among an op's (nested) arguments."""
    if isinstance(x, torch.fx.Node):
        return [x]
    if isinstance(x, (list, tuple)):
        return [n for a in x for n in _nodes_in(a)]
    if isinstance(x, dict):
        return [n for a in x.values() for n in _nodes_in(a)]
    return []


def _op_name(target: Any) -> Tuple[str, str]:
    """(namespace, op name) of an ``OpOverload`` target, else ("", "")."""
    schema = getattr(target, "_schema", None)
    if schema is None:
        return "", ""
    ns, _, name = schema.name.partition("::")
    return ns, name


class _Walker:
    """Forward taint over one graph; buffers are union-find classes of
    nodes that share storage."""

    def __init__(self) -> None:
        self.env: Dict[torch.fx.Node, Taint] = {}
        self.parent: Dict[torch.fx.Node, torch.fx.Node] = {}
        self.members: Dict[torch.fx.Node, List[torch.fx.Node]] = {}
        self.crossings: List[Crossing] = []
        self.n_dp = 0

    # -- buffers -----------------------------------------------------------
    def _root(self, n: torch.fx.Node) -> torch.fx.Node:
        while self.parent[n] is not n:
            n = self.parent[n]
        return n

    def _new_buffer(self, n: torch.fx.Node) -> None:
        self.parent[n] = n
        self.members[n] = [n]

    def _share(self, a: torch.fx.Node, b: torch.fx.Node) -> None:
        ra, rb = self._root(a), self._root(b)
        if ra is not rb:
            self.parent[rb] = ra
            self.members[ra] += self.members.pop(rb)

    def _write(self, n: torch.fx.Node, t: Taint) -> None:
        """Join ``t`` into every alias of ``n``'s buffer."""
        for m in self.members[self._root(n)]:
            self.env[m] = self.env.get(m, _EMPTY) | t

    # -- one node ------------------------------------------------------------
    def run(self, gm: torch.fx.GraphModule,
            in_taints: Sequence[Taint]) -> List[Taint]:
        placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
        if len(placeholders) != len(in_taints):
            raise ValueError(f"graph has {len(placeholders)} inputs, got "
                             f"{len(in_taints)} taints")
        seeds = dict(zip(placeholders, in_taints))
        out: List[Taint] = []
        for n in gm.graph.nodes:
            if n.op == "placeholder":
                self._new_buffer(n)
                self.env[n] = seeds[n]
            elif n.op == "get_attr":
                self._new_buffer(n)
                self.env[n] = _EMPTY
            elif n.op == "call_function":
                self._call(n)
            elif n.op == "output":
                out = [self.env.get(m, _EMPTY)
                       for m in _nodes_in(n.args[0])]
            else:
                raise ValueError(f"unexpected graph node {n.op} {n.target}")
        return out

    def _call(self, n: torch.fx.Node) -> None:
        ins = _nodes_in((n.args, n.kwargs))
        joined = frozenset().union(*(self.env[m] for m in ins))
        self._new_buffer(n)
        if n.target is operator.getitem:
            # an element of a multi-output op: the op's buffer and taint
            self._share(n.args[0], n)
            self.env[n] = self.env[n.args[0]]
            return
        ns, name = _op_name(n.target)
        if ns == "repro_torch" and name == "wire_boundary":
            src = n.args[0]
            val = src.meta["val"]
            self.crossings.append(Crossing(
                kind=n.args[1], direction=n.args[2],
                shape=tuple(int(d) for d in val.shape),
                dtype=_dtype_name(val.dtype), taint=self.env[src]))
            self.env[n] = _EMPTY
            return
        if ns == "repro_torch" and name == "dp_noise":
            self.n_dp += 1
            self.env[n] = frozenset({DP})
            return
        if ns == "repro_torch" and name == "grad_mark":
            self.env[n] = self.env[n.args[0]] | frozenset({GRAD, SERVER})
            return
        # any other op, known or not: all inputs to all outputs
        self.env[n] = joined
        schema = getattr(n.target, "_schema", None)
        if schema is None:
            return
        written, aliased = self._aliases(n, schema, ns, name)
        for a in written:
            self._write(a, joined)
        for a in aliased:
            self._share(a, n)
        self.env[n] = frozenset().union(
            joined, *(self.env[m] for m in self.members[self._root(n)]))

    @staticmethod
    def _aliases(n: torch.fx.Node, schema, ns: str, name: str):
        """(argument nodes the op writes, argument nodes its outputs
        alias), from the schema's alias annotations; an in-place op
        outside aten without them (the c10d collectives) writes and
        aliases every tensor argument."""
        bound: List[Tuple[Any, Any]] = []
        for i, arg in enumerate(schema.arguments):
            if arg.kwarg_only or i >= len(n.args):
                val = n.kwargs.get(arg.name)
            else:
                val = n.args[i]
            bound.append((arg, val))
        if ns != "aten" and name.endswith("_"):
            every = [m for _, v in bound for m in _nodes_in(v)]
            return every, every
        written, aliased = [], []
        ret_sets = set()
        for r in schema.returns:
            if r.alias_info is not None:
                ret_sets |= set(r.alias_info.before_set)
        for arg, val in bound:
            info = arg.alias_info
            if info is None:
                continue
            nodes = _nodes_in(val)
            if info.is_write:
                written += nodes
            if set(info.before_set) & ret_sets:
                aliased += nodes
        return written, aliased


# ----------------------------------------------------------- entry points --

def analyze(gm: torch.fx.GraphModule,
            in_taints: Sequence[Taint]) -> IFCReport:
    """Run the taint pass over a traced graph with labelled inputs."""
    w = _Walker()
    outs = w.run(gm, list(in_taints))
    report = IFCReport(out_taints=outs, crossings=w.crossings,
                       n_dp_eqns=w.n_dp, graph=gm)
    return report


def _flatten(tree: Any, path: str = "") -> List[Tuple[str, Any]]:
    """(key path, leaf) pairs in the order :func:`_rebuild` consumes them:
    a dict's keys sorted (a dict subclass such as
    ``draws.FilledDraws`` too), a tuple's or list's elements in order;
    paths read like JAX's ``keystr`` (``[0]['server']['w']``)."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _flatten(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [p for i, x in enumerate(tree)
                for p in _flatten(x, f"{path}[{i}]")]
    return [(path, tree)]


def _rebuild(tree: Any, leaves: Any) -> Any:
    if isinstance(tree, dict):
        return type(tree)({k: _rebuild(tree[k], leaves)
                           for k in sorted(tree)})
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(x, leaves) for x in tree)
    return next(leaves)


def label_args(example_args: Sequence[Any],
               is_server: Optional[Callable[[str], bool]] = None
               ) -> List[Taint]:
    """Per-tensor taints for ``example_args``, in the order of the traced
    graph's inputs. A tensor whose key path contains ``server`` (default
    predicate) seeds SERVER."""
    pred = is_server if is_server is not None else (
        lambda p: "server" in p.lower())
    return [frozenset({SERVER}) if pred(p) else _EMPTY
            for p, leaf in _flatten(tuple(example_args))
            if isinstance(leaf, torch.Tensor)]


def trace(fn: Callable[..., Any], example_args: Sequence[Any]
          ) -> torch.fx.GraphModule:
    """``make_fx`` in real mode over ``fn(*example_args)`` with the marks
    on: every tensor in the (nested) arguments is a graph input, any
    other leaf (a Python int, None) is fixed. The trace RUNS the step
    (on the card, the kernels launch once per node) and the step's
    in-place updates land on the example tensors."""
    leaves = _flatten(tuple(example_args))
    tensors = [x for _, x in leaves if isinstance(x, torch.Tensor)]

    def flat_fn(*ts):
        it = iter(ts)
        vals = iter([next(it) if isinstance(x, torch.Tensor) else x
                     for _, x in leaves])
        return fn(*_rebuild(tuple(example_args), vals))

    # one fake mode for the nodes' shape-only "val" metadata (make_fx
    # would build one a node: most of the trace's own time)
    with marks.trace_context(), tracing(TracingContext(
            FakeTensorMode(allow_fallback_kernels=True))):
        return make_fx(flat_fn, tracing_mode="real")(*tensors)


def trace_and_analyze(fn: Callable[..., Any], example_args: Sequence[Any],
                      is_server: Optional[Callable[[str], bool]] = None
                      ) -> IFCReport:
    """:func:`trace` + :func:`analyze`: certify ``fn``'s client-bound
    outputs (the closure must return ONLY client-held values). A trace
    that stops on a data-dependent host read returns a report with
    ``stopped`` set and nothing else known."""
    try:
        gm = trace(fn, example_args)
    except RuntimeError as e:
        if _HOST_READ not in str(e):
            raise
        return IFCReport(out_taints=[], crossings=[], n_dp_eqns=0,
                         stopped=str(e).splitlines()[0])
    return analyze(gm, label_args(example_args, is_server))


def count_nodes(report: IFCReport, op: str) -> int:
    """Graph nodes of the custom op ``repro_torch::<op>`` in a report's
    trace."""
    return sum(1 for n in report.graph.graph.nodes
               if n.op == "call_function"
               and _op_name(n.target) == ("repro_torch", op))


# ------------------------------------------------------------- the rules --

def check_flows(report: IFCReport, *, name: str, dp_configured: bool,
                down_limits: Mapping[str, int],
                path: str = "<certify>") -> List[Finding]:
    """Evaluate IF301–IF303 on one analysis report.

    ``down_limits`` maps downlink payload kinds to the maximum number of
    elements one crossing may carry per round (e.g. ``{"loss":
    (1+q)*block}``); a downlink crossing of any other kind is an IF302
    violation outright. A trace that stopped on a host read is IF302.

    Per-output precedence: an output carrying ``grad`` taint is IF301;
    one carrying only ``server`` taint is IF302 (flow bypassed the
    bottleneck) — so each seeded leak trips exactly one rule.
    """
    findings: List[Finding] = []
    if report.stopped is not None:
        return [Finding(
            "IF302", path, 0,
            f"{name}: the trace stopped on a data-dependent host read "
            f"({report.stopped}); a value read on the host may carry a "
            "server->client flow the graph cannot show, so the "
            "configuration cannot be certified")]

    grad_outs = [i for i, t in enumerate(report.out_taints) if GRAD in t]
    srv_outs = [i for i, t in enumerate(report.out_taints)
                if SERVER in t and GRAD not in t]
    if grad_outs:
        findings.append(Finding(
            "IF301", path, 0,
            f"{name}: client-bound output(s) {grad_outs} derive from "
            "server-parameter cotangents without passing the wire "
            "bottleneck (first-order gradient reaches a client)"))
    if srv_outs:
        findings.append(Finding(
            "IF302", path, 0,
            f"{name}: server->client flow bypasses the wire bottleneck "
            f"(server taint reaches client-bound output(s) {srv_outs} "
            "with no wire_boundary on the path)"))

    for c in report.down():
        limit = down_limits.get(c.kind)
        if limit is None:
            findings.append(Finding(
                "IF302", path, 0,
                f"{name}: unexpected downlink payload kind {c.kind!r} "
                f"(shape {list(c.shape)}); the protocol downlinks only "
                f"{sorted(down_limits)}"))
        elif c.size > limit:
            findings.append(Finding(
                "IF302", path, 0,
                f"{name}: downlink bottleneck is not scalar-shaped — "
                f"kind={c.kind} shape={list(c.shape)} carries {c.size} "
                f"elements > {limit} allowed ((1+q) scalars per "
                "activated client)"))

    if dp_configured:
        down_loss = report.down("loss")
        if not down_loss:
            findings.append(Finding(
                "IF303", path, 0,
                f"{name}: DP channel configured but no loss downlink "
                "crossing was traced (noise never reaches the wire)"))
        for c in down_loss:
            if DP not in c.taint or SERVER in c.taint:
                findings.append(Finding(
                    "IF303", path, 0,
                    f"{name}: DP channel configured but the downlink "
                    f"crossing is not noise-dominated (operand taint "
                    f"{sorted(c.taint)}; noise must be added BEFORE the "
                    "wire, as Transport.downlink does)"))

    return findings
