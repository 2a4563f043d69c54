"""The port's graph-level taint pass (``repro_torch.analysis.marks`` and
``repro_torch.analysis.ifc``), case for case with ``repro``'s
``tests/test_ifc.py`` where ``repro``'s pass still runs here:

* the marks are their operand object outside the certifier's trace,
  validate their kind and direction, and are transparent to autograd,
  ``torch.func.grad`` and ``torch.func.vmap`` inside it;
* the walker's unit cases, each held to ``repro``'s live
  ``ifc.trace_and_analyze`` report on the same numpy inputs: a Python
  loop over a server carry (``repro``'s scan fixpoint), launder and
  record, dp replaces, and control dependence (``torch.where`` against
  ``repro``'s ``cond``); a Python ``if`` on a server tensor stops the
  trace and is reported, never certified. ``repro``'s pass reads
  ``jax.core.Literal``, ``Jaxpr`` and ``ClosedJaxpr``, which jax 0.9
  keeps only in ``jax.extend.core``; the ``jax_core_names`` fixture
  points the old names at those for these tests only (``repro`` itself
  is not edited);
* soundness under mutation: in-place writes, views taken before a write
  and the c10d collectives (a one-rank gloo group) carry ``server`` to
  later reads, while a client-only write stays clean;
* the three leaky fixtures (``tests/torch_analysis_fixtures/ifc/``) each
  trip exactly their rule, as ``repro``'s do.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.analysis import ifc as jifc
from repro.analysis import marks as jmarks
from repro_torch.analysis import certify, ifc, marks

IFC_FIXTURES = os.path.join(os.path.dirname(__file__),
                            "torch_analysis_fixtures", "ifc")
REPRO_IFC_FIXTURES = os.path.join(os.path.dirname(__file__),
                                  "analysis_fixtures", "ifc")
SERVER = frozenset({ifc.SERVER})
CLEAN = frozenset()


@pytest.fixture
def jax_core_names(monkeypatch):
    """Let ``repro``'s taint pass run under a jax whose ``jax.core`` lacks
    the classes it checks equations against."""
    import jax.extend.core
    for name in ("Literal", "Jaxpr", "ClosedJaxpr"):
        monkeypatch.setattr(jax.core, name, getattr(jax.extend.core, name),
                            raising=False)


def first(p):
    return p.startswith("[0]")


def _rng(seed=0):
    return np.random.default_rng(seed)


def _crossings(rep):
    return [(c.kind, c.direction, tuple(c.shape), c.taint)
            for c in rep.crossings]


def _same_report(rep, jrep):
    assert [set(t) for t in rep.out_taints] == \
        [set(t) for t in jrep.out_taints]
    assert _crossings(rep) == _crossings(jrep)
    assert rep.n_dp_eqns == jrep.n_dp_eqns


# ======================================================= mark identity ====

def test_marks_are_their_operand_outside_the_trace():
    x = torch.linspace(-2, 2, 12).reshape(3, 4).to(torch.bfloat16)
    tree = {"a": x, "b": (x, x)}
    assert marks.wire_boundary(x, kind="emb", direction="up") is x
    assert marks.dp_noise(x) is x
    assert marks.grad_mark(x) is x
    assert marks.grad_mark(tree) is tree
    assert not marks.tracing()
    with marks.trace_context():
        assert marks.tracing()
    assert not marks.tracing()


def test_wire_boundary_validates_kind_and_direction():
    x = torch.ones(3)
    for ctx in (marks.trace_context, lambda: torch.no_grad()):
        with ctx():
            with pytest.raises(ValueError):
                marks.wire_boundary(x, kind="logits", direction="down")
            with pytest.raises(ValueError):
                marks.wire_boundary(x, kind="emb", direction="sideways")


def test_marks_are_transparent_to_grad_and_vmap_inside_the_trace():
    """Under the trace the marks are nodes, and the step's
    ``torch.autograd.grad`` (the engine's ``_value_and_grad``),
    ``torch.func.grad_and_value`` (Split-Learning) and
    ``torch.func.vmap`` (the ZOO lanes) see identities; the traced graph
    recomputes what the untraced function does."""
    def loss(w):
        return torch.sum(marks.wire_boundary(w * 3.0, kind="loss",
                                             direction="down") ** 2)

    def fn(w, lanes):
        leaf = w.detach().requires_grad_(True)
        with torch.enable_grad():
            g1 = torch.autograd.grad(loss(leaf), [leaf])[0]
        g2, _ = torch.func.grad_and_value(loss)(w)
        v = torch.func.vmap(lambda a: marks.dp_noise(a) + 1)(lanes)
        return marks.grad_mark(g1), g2, v

    w, lanes = torch.arange(4.0), torch.ones((5, 2))
    want = fn(w, lanes)
    np.testing.assert_array_equal(want[0].numpy(), 18.0 * w.numpy())
    np.testing.assert_array_equal(want[1].numpy(), 18.0 * w.numpy())
    np.testing.assert_array_equal(want[2].numpy(), np.full((5, 2), 2.0))
    gm = ifc.trace(fn, (w, lanes))
    for got, ref in zip(gm(w, lanes), want):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
    rep = ifc.analyze(gm, [SERVER, CLEAN])
    # two forward marks (autograd and torch.func) and one per lane stack
    assert [c.shape for c in rep.crossings] == [(4,), (4,)]
    assert rep.n_dp_eqns == 1
    # the backward of sum(wire(3w)^2) reads the crossing's (laundered)
    # output, so the unmarked gradient is clean
    assert rep.out_taints == [frozenset({ifc.GRAD, ifc.SERVER}), CLEAN,
                              frozenset({ifc.DP})]


# ================================================= walker vs repro's ====

def test_taint_flows_through_a_python_loop_over_a_server_carry(jax_core_names):
    """``repro``'s scan fixpoint case: the loop mixes the server seed into
    its carry on every step; the carry and the stacked outputs come out
    server, and IF302 fires (no boundary launders them)."""
    w, xs = _rng().normal(size=3), _rng(1).normal(size=4)

    def jfn(server_w, xs):
        def body(c, x):
            return c + jnp.sum(server_w) * x, c
        return jax.lax.scan(body, 0.0, xs)

    def fn(server_w, xs):
        c, ys = torch.zeros(()), []
        for i in range(xs.shape[0]):
            ys.append(c)
            c = c + torch.sum(server_w) * xs[i]
        return c, torch.stack(ys)

    jrep = jifc.trace_and_analyze(jfn, (jnp.asarray(w, jnp.float32),
                                        jnp.asarray(xs, jnp.float32)),
                                  is_server=first)
    rep = ifc.trace_and_analyze(fn, (torch.tensor(w, dtype=torch.float32),
                                     torch.tensor(xs, dtype=torch.float32)),
                                is_server=first)
    _same_report(rep, jrep)
    assert all(ifc.SERVER in t for t in rep.out_taints)
    rules = [f.rule for f in ifc.check_flows(
        rep, name="loop", dp_configured=False, down_limits={"loss": 3})]
    assert rules == [f.rule for f in jifc.check_flows(
        jrep, name="loop", dp_configured=False,
        down_limits={"loss": 3})] == ["IF302"]


def test_where_predicate_is_control_dependence(jax_core_names):
    """``repro``'s ``cond`` case in the port's form: selecting between two
    client values ON a server flag leaks one bit, so the output is
    server."""
    def jfn(server_flag, a):
        return jax.lax.cond(server_flag > 0, lambda: a + 1.0, lambda: a)

    def fn(server_flag, a):
        return torch.where(server_flag > 0, a + 1.0, a)

    jrep = jifc.trace_and_analyze(jfn, (jnp.float32(1.0), jnp.float32(2.0)),
                                  is_server=first)
    rep = ifc.trace_and_analyze(fn, (torch.tensor(1.0), torch.tensor(2.0)),
                                is_server=first)
    _same_report(rep, jrep)
    assert rep.out_taints == [SERVER]


def test_python_branch_on_a_server_tensor_is_reported():
    """A Python ``if`` on a traced tensor reads the host: the trace stops
    there, and the configuration is reported (IF302), never certified."""
    def fn(server_flag, a):
        if server_flag > 0:
            return a + 1.0
        return a

    rep = ifc.trace_and_analyze(fn, (torch.tensor(1.0), torch.tensor(2.0)),
                                is_server=first)
    assert rep.stopped is not None and "_local_scalar_dense" in rep.stopped
    assert rep.to_json()["stopped"] == rep.stopped
    rules = [f.rule for f in ifc.check_flows(
        rep, name="branch", dp_configured=False, down_limits={"loss": 3})]
    assert rules == ["IF302"]


def test_wire_boundary_launders_and_records(jax_core_names):
    w = _rng(2).normal(size=3)

    def jfn(server_w):
        e = jmarks.wire_boundary(server_w * 2.0, kind="loss",
                                 direction="down")
        return e + 1.0

    def fn(server_w):
        e = marks.wire_boundary(server_w * 2.0, kind="loss",
                                direction="down")
        return e + 1.0

    jrep = jifc.trace_and_analyze(jfn, (jnp.asarray(w, jnp.float32),),
                                  is_server=lambda p: True)
    rep = ifc.trace_and_analyze(fn, (torch.tensor(w, dtype=torch.float32),),
                                is_server=lambda p: True)
    _same_report(rep, jrep)
    assert rep.out_taints == [CLEAN]
    (c,) = rep.crossings
    assert (c.kind, c.direction, c.shape, c.dtype, c.taint) == (
        "loss", "down", (3,), "float32", SERVER)


def test_dp_noise_replaces_taint(jax_core_names):
    w = _rng(3).normal(size=2)

    def jfn(server_w):
        return jmarks.wire_boundary(jmarks.dp_noise(server_w),
                                    kind="loss", direction="down")

    def fn(server_w):
        return marks.wire_boundary(marks.dp_noise(server_w),
                                   kind="loss", direction="down")

    jrep = jifc.trace_and_analyze(jfn, (jnp.asarray(w, jnp.float32),),
                                  is_server=lambda p: True)
    rep = ifc.trace_and_analyze(fn, (torch.tensor(w, dtype=torch.float32),),
                                is_server=lambda p: True)
    _same_report(rep, jrep)
    assert rep.n_dp_eqns == 1
    assert rep.down("loss")[0].taint == frozenset({ifc.DP})
    assert not ifc.check_flows(rep, name="dp", dp_configured=True,
                               down_limits={"loss": 3})


def test_label_args_follows_key_paths():
    args = ({"server": {"w": torch.ones(2)}, "clients": torch.ones(2)},
            torch.ones(1), 3, None, [torch.ones(1)])
    assert ifc.label_args(args) == [CLEAN, SERVER, CLEAN, CLEAN]
    assert ifc.label_args(args, is_server=first) == [SERVER, SERVER, CLEAN,
                                                     CLEAN]


# ============================================== soundness under mutation ==

def _out(fn, *args):
    return ifc.trace_and_analyze(fn, args, is_server=first).out_taints


def test_in_place_writes_carry_server_to_later_reads():
    def copy_in(server_w, c):
        out = torch.zeros(3)
        out.copy_(server_w)
        return out + c

    def index_put(server_w, c):
        buf = torch.zeros(4)
        early = buf[:2]                   # a view taken before the write
        buf.index_put_((torch.tensor([0, 2]),), server_w[:2])
        return early * 1.0, buf + c[0]

    def view_write(server_w, c):
        buf = torch.zeros(3)
        buf[1:].copy_(server_w[1:])       # a write through a view
        return buf

    def client_only(server_w, c):
        out = torch.zeros(3)
        out.copy_(c)
        return out * 2.0

    w, c = torch.ones(3), torch.ones(3)
    assert _out(copy_in, w, c) == [SERVER]
    assert _out(index_put, w, c) == [SERVER, SERVER]
    assert _out(view_write, w, c) == [SERVER]
    assert _out(client_only, w, c) == [CLEAN]


def test_collectives_carry_server_to_later_reads():
    """``dist.all_reduce`` and ``dist.all_gather_into_tensor`` in a
    one-rank gloo group: the buffers they write, and views of them taken
    before, read ``server`` afterwards."""
    def all_reduce(server_w, c):
        buf = torch.zeros(3)
        early = buf.view(3)
        buf[0] = server_w[0]
        dist.all_reduce(buf)
        return early + c, buf + c

    def all_gather(server_w, c):
        out = c.new_empty((3,))
        dist.all_gather_into_tensor(out, server_w)
        return out + c

    def client_gather(server_w, c):
        out = c.new_empty((3,))
        dist.all_gather_into_tensor(out, c)
        return out * 2.0

    w, c = torch.ones(3), torch.ones(3)
    with certify.one_rank_group("cpu"):
        assert _out(all_reduce, w, c) == [SERVER, SERVER]
        assert _out(all_gather, w, c) == [SERVER]
        assert _out(client_gather, w, c) == [CLEAN]
    assert not dist.is_initialized()


# ================================================== the leaky fixtures ====

def _load_fixture(name, where=IFC_FIXTURES):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(where, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["if301_skip_downlink",
                                  "if302_embedding_downlink",
                                  "if303_noise_after_estimator"])
def test_leaky_fixture_trips_exactly_its_rule(name, jax_core_names):
    """Each port fixture trips exactly its rule, as ``repro``'s fixture of
    the same name does under ``repro``'s pass."""
    rules = {}
    for pkg, where in ((ifc, IFC_FIXTURES), (jifc, REPRO_IFC_FIXTURES)):
        mod = _load_fixture(name, where)
        b = mod.build()
        rep = pkg.trace_and_analyze(b["fn"], b["args"],
                                    is_server=b["is_server"])
        findings = pkg.check_flows(rep, name=name,
                                   dp_configured=b["dp_configured"],
                                   down_limits=b["down_limits"])
        rules[pkg] = [f.rule for f in findings]
        assert rules[pkg] == [mod.EXPECT]
    assert rules[ifc] == rules[jifc]


# ==================================================== kernels as nodes ====

def test_kernel_nodes_have_fake_implementations():
    """Each kernel's custom op (one graph node a launch on the card) has a
    fake implementation giving its outputs' shapes and dtypes."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    import repro_torch.kernels  # noqa: F401  (registers the ops)
    ops = torch.ops.repro_torch
    with FakeTensorMode():
        x, w = torch.empty(3, 8, 5), torch.empty(3, 5, 6)
        us, b, ub = torch.empty(3, 2, 5, 6), torch.empty(3, 6), \
            torch.empty(3, 2, 6)
        y, yh = ops.zoo_dual_matmul_stacked_bias_relu(x, w, us, b, ub, 0.1)
        assert (y.shape, yh.shape) == ((3, 8, 6), (3, 2, 8, 6))
        y, yh = ops.zoo_dual_matmul_stacked(x, w, us, None, None, 0.1)
        assert (y.shape, yh.shape) == ((3, 8, 6), (3, 2, 8, 6))
        x = torch.empty(4, 16, dtype=torch.bfloat16)
        out = ops.rmsnorm(x, torch.empty(16), 1e-6)
        assert (out.shape, out.dtype) == ((4, 16), torch.bfloat16)
        q, kv = torch.empty(2, 5, 4, 192), torch.empty(2, 7, 2, 192)
        o = ops.flash_attention(q, kv, torch.empty(2, 7, 2, 128), True, 0, 0)
        assert o.shape == (2, 5, 4, 128)
        xh, a = torch.empty(2, 8, 3, 4, dtype=torch.bfloat16), \
            torch.empty(2, 8, 3)
        bm = torch.empty(2, 8, 5, dtype=torch.bfloat16)
        y, st = ops.ssd_chunk(xh, a, a, bm, bm, None, 4)
        assert (y.shape, y.dtype, st.shape) == ((2, 8, 3, 4), torch.float32,
                                                (2, 3, 4, 5))
        xf = torch.empty(6, 8, 4, dtype=torch.bfloat16)
        af = torch.empty(6, 8)
        bf = torch.empty(6, 8, 5, dtype=torch.bfloat16)
        assert ops.ssd_chunk_flat(xf, af, af, bf, bf, 4).shape == (6, 8, 4)


def test_cpu_kernels_trace_their_plain_versions():
    """On the CPU the fused ZOO fan-out takes its plain version under the
    trace too: aten ops, no kernel node, and nothing launched."""
    from repro_torch.configs.paper_mlp import PaperMLPConfig
    from repro_torch.core.adapters import tabular_adapter
    from repro_torch.kernels.zoo_dual_matmul import ops as zoo_ops

    cfg = PaperMLPConfig(n_features=8, n_classes=3, n_clients=2,
                         client_embed=4, server_embed=6)
    lanes = tabular_adapter(cfg, use_kernel_lanes=True).client_lanes
    g = torch.Generator().manual_seed(0)
    blk = {"w": torch.randn(1, 4, 4, generator=g),
           "b": torch.randn(1, 4, generator=g)}
    u = {"w": torch.randn(1, 2, 4, 4, generator=g),
         "b": torch.randn(1, 2, 4, generator=g)}
    x = torch.randn(1, 3, 4, generator=g)
    before = dict(zoo_ops.launches)
    gm = ifc.trace(lambda b, uu, xx: lanes(b, uu, 1e-3, xx), (blk, u, x))
    assert zoo_ops.launches == before
    targets = {str(n.target) for n in gm.graph.nodes
               if n.op == "call_function"}
    assert not any("repro_torch" in t for t in targets)
    # the graph's inputs: the tensors in sorted-key order
    flat = (blk["b"], blk["w"], u["b"], u["w"], x)
    torch.testing.assert_close(gm(*flat), lanes(blk, u, 1e-3, x),
                               rtol=0, atol=0)
