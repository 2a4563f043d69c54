"""The production mesh of the port: parameters as DTensors placed by
``PARAM_RULES``, activations constrained at the JAX package's 27
``shard_constraint`` sites, and ``launch.train.train(mesh=)``.

* 4 gloo ranks at a (2, 2) mesh (``tests/_torch_mesh_child.py``), reduced
  phi3 and reduced qwen3 with one KV head (the GQA fallback: its four
  query heads shard over "model", its KV head cannot) in f32, against the
  unplaced port run of the same draws. After one cascaded step the loss
  and the server's parameters agree to 1e-5. The client's ZOO update
  multiplies the loss's rounding (sharded sums run in another order) by
  φ/μ, so the client is held to the one-step parity tolerances of
  ``test_torch_train_step.py`` (``repro``'s fused-vs-unrolled ZOO
  tolerance, rtol 2e-3 and atol 5e-4, and its update to 1% of its largest
  entry). The second step is also held alone: the unplaced run resumes
  from the placed run's own parameters after its first step (the
  checkpoint of an unplaced first step, its parameters swapped), and its
  loss and server agree with the placed second step to 1e-5, its client
  to the ZOO tolerance, with an update that is the unplaced one times
  one scalar (the loss difference over μ: on qwen3 the φ/μ-amplified
  rounding scales it by 0.985 at this step). Against the unplaced two
  steps, whose server and loss have seen the unplaced client, everything
  is held to the ZOO tolerance.
  Each leaf's local shape is the one ``repro``'s spec gives, and the
  ``shard_constraint`` calls are counted against their derivation;
* ``train(mesh=)`` builds the compiled step, a ``graphs.GraphedFn`` (on
  the CPU its loop form: static DTensor buffers, ``RoundDraws`` over
  ``PlacedDraws`` refilled shard by shard), whose two steps are bitwise
  the placed eager step's, with and without the DP channel; with it the
  placed run is held to the unplaced one as the two-step case is;
  ``graphs.signature`` keys a DTensor by its placements;
* one eager placed step's collectives equal the dry run's trace of it
  (``costmodel.measure`` on a fake group of 4, a child started beside
  the ranks), and the trace's update reduce-scatters each gradient in its
  own dtype where bare sgd moved its f32 upcast;
* each step factory reduces each gradient once and reads its logged
  norms from the placed gradients: at the lines of ``core/cascade.py``
  the trace (cascaded f32 and bf16, FOO) and the gloo rank carry 0-dim
  all-reduces only, and the placed runs' norms agree with the unplaced
  runs';
* ``chip_smoke.py``'s f32 gate of the card's placed run holds each
  leaf's update, and fails on one dropped.
The rules' placements and the no-mesh identity are
``test_torch_mesh_rules.py``'s.
"""
import importlib.util
import json
import os
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from _torch_mesh_child import (CASES, DP_CASE, RESUME_AT, RESUME_CASES,
                               TRAIN, case_cfg, case_noise, recorded_losses)
from repro import configs as j_configs
from repro.federation import Federation as JFederation
from repro.models import model_api as j_model_api
from repro.sharding import rules as j_rules
from repro_torch.core.partition import split_params
from repro_torch.federation import Federation
from repro_torch.launch.train import train
from repro_torch.models import common, model_api
from test_torch_support import _flat, torch_threads

ROOT = pathlib.Path(__file__).resolve().parents[1]
CHILD = pathlib.Path(__file__).with_name("_torch_mesh_child.py")
ENV = dict(os.environ, PYTHONPATH=os.pathsep.join(
    [str(ROOT / "src"), str(ROOT / "tests")]))
# one rank's collective bytes a step of the phi3 case at (2, 2) outside
# the lines of core/cascade.py, in the dry run's trace: the model's
# forward and backward, and the update's reduction of each gradient to
# its parameter's placement; the cascaded f32 step and the FOO step
OUTSIDE_NORMS = {"f32": 5_143_584, "vafl": 3_968_000}
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x2": {"data": 2, "model": 2}}
ZOO_TOL = dict(rtol=2e-3, atol=5e-4)
NAMES = [c[0] for c in CASES]
FORMS = NAMES + [DP_CASE[0]]
RESUMED = [c[0] for c in RESUME_CASES]


def _paths(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{path}/{k}")
    else:
        yield path, tree


@pytest.fixture(scope="module")
def placed(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh")
    out = d / "out.pt"
    # the dry run's trace of the phi3 case's step (a fake group) beside
    # the four ranks
    cmds = [["train", str(r), "4", str(d / "store"), str(out)]
            for r in range(4)] + [["fake", "measure", str(d / "m.json")]]
    procs = [subprocess.Popen(
        [sys.executable, str(CHILD)] + cmd, env=ENV, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for cmd in cmds]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    res = torch.load(out, weights_only=False)
    res["ck"] = str(d / "ck")
    res["measure"] = json.loads((d / "m.json").read_text())
    return res


@pytest.fixture(scope="module")
def unplaced():
    res = {}
    with torch_threads(1):
        for name, arch, over in CASES:
            for steps in (1, 2):
                outputs = []
                with recorded_losses(outputs):
                    r = train(case_cfg(arch, over), steps=steps, **TRAIN)
                r["params"] = dict(_paths(r["params"]))
                r["outputs"] = outputs
                res[f"{name}/{steps}"] = r
        name, arch, over = DP_CASE
        r = train(case_cfg(arch, over), steps=2, noise=case_noise(name),
                  **TRAIN)
        r["params"] = dict(_paths(r["params"]))
        res[f"{name}/2"] = r
    return res


@pytest.fixture(scope="module")
def unplaced_saved(tmp_path_factory):
    """The unplaced run of each resume case saved at step RESUME_AT."""
    d = tmp_path_factory.mktemp("unplaced")
    with torch_threads(1):
        for name, arch, over in RESUME_CASES:
            train(case_cfg(arch, over), steps=RESUME_AT,
                  noise=case_noise(name), checkpoint_path=str(d / name),
                  **TRAIN)
    return d


def _case(name):
    return next(c for c in CASES if c[0] == name)


def _parts(name):
    """(client paths, initial params by path) of a case."""
    _, arch, over = _case(name)
    cfg = case_cfg(arch, over)
    model = model_api.build_model(cfg, max_seq=TRAIN["seq"])
    p0 = common.materialize(model.param_specs,
                            torch.Generator().manual_seed(0), device="cpu")
    client, _ = split_params(p0, model.client_keys)
    return ({f"/{k}{p}" for k in client for p, _ in _paths(client[k])},
            dict(_paths(p0)))


def _unpaths(flat):
    tree = {}
    for path, v in flat.items():
        *keys, last = path.strip("/").split("/")
        node = tree
        for k in keys:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


def _second_step_from(name, start, tmp_path):
    """The unplaced run's second step taken from ``start`` (the placed
    run's parameters after its first step, by path): an unplaced first
    step is checkpointed, its parameters are swapped for ``start``, and
    the run resumes for the second (its ``StepOutput`` under
    ``outputs``)."""
    _, arch, over = _case(name)
    one, swapped = str(tmp_path / "one"), str(tmp_path / "swapped")
    with torch_threads(1):
        train(case_cfg(arch, over), steps=1, checkpoint_path=one, **TRAIN)
        fed, params, state = Federation.restore(one, device="cpu")
        assert set(dict(_paths(params))) == set(start)
        fed.save(swapped, _unpaths(start), step=state.step,
                 opt_state=state.opt_state, ledger=state.ledger,
                 dp_releases=state.dp_releases, metadata=state.metadata)
        outputs = []
        with recorded_losses(outputs):
            r = train(steps=2, resume=swapped, **TRAIN)
    r["params"] = dict(_paths(r["params"]))
    r["outputs"] = outputs
    return r


def _check(got, want, name, server_tol, one_step):
    """The losses, the server's leaves at ``server_tol``, and the client's
    ZOO-updated leaves at ``repro``'s ZOO tolerance and, after one step,
    their update at 1% of its largest entry."""
    clients, p0 = _parts(name)
    np.testing.assert_allclose(got["loss_first"], want["loss_first"],
                               rtol=1e-5)
    assert set(got["params"]) == set(want["params"])
    for path, w in want["params"].items():
        g = got["params"][path]
        if path in clients:
            np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=path,
                                       **ZOO_TOL)
            if not one_step:
                continue
            step = (w - p0[path]).abs().max()
            ulp = torch.finfo(torch.float32).eps * p0[path].abs().max()
            np.testing.assert_allclose(
                (g - p0[path]).numpy(), (w - p0[path]).numpy(), rtol=0,
                atol=float(1e-2 * step + ulp), err_msg=path)
        else:
            np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=path,
                                       **server_tol)


@pytest.mark.parametrize("name", NAMES)
def test_one_placed_step_matches_the_unplaced_step(placed, unplaced, name):
    _check(placed[f"{name}/1"], unplaced[f"{name}/1"], name,
           dict(rtol=1e-5, atol=1e-5), one_step=True)


@pytest.mark.parametrize("name", NAMES)
def test_two_placed_steps_match_the_unplaced_steps(placed, unplaced, name,
                                                   tmp_path):
    got, want = placed[f"{name}/2"], unplaced[f"{name}/2"]
    # the second step alone, from the placed run's own first step; its
    # loss is the second of the two that loss_last averages
    start = placed[f"{name}/1"]["params"]
    alone = _second_step_from(name, start, tmp_path)
    second = dict(got, loss_first=2 * got["loss_last"] - got["loss_first"])
    _check(second, alone, name, dict(rtol=1e-5, atol=1e-5), one_step=False)
    # the client's update is the unplaced update times one scalar, the
    # loss difference over μ, which carries the loss's rounding times φ/μ
    # (qwen3's reads 0.9852 here, where its losses differ by 2 ulps); up
    # to the parameters' own rounding
    for path in _parts(name)[0]:
        g = got["params"][path] - start[path]
        w = alone["params"][path] - start[path]
        c = float((g * w).sum() / (w * w).sum())
        ulp = torch.finfo(torch.float32).eps * start[path].abs().max()
        np.testing.assert_allclose(g.numpy(), (c * w).numpy(), rtol=0,
                                   atol=float(2 * ulp), err_msg=path)
    _check(got, want, name, ZOO_TOL, one_step=False)
    np.testing.assert_allclose(got["loss_last"], want["loss_last"],
                               **ZOO_TOL)
    assert got["wire_bytes_per_round"] == want["wire_bytes_per_round"]
    assert not got["wire_has_gradients"]


@pytest.mark.parametrize("name", NAMES)
def test_local_shapes_are_repros_specs(placed, name):
    _, arch, over = _case(name)
    j_cfg = j_configs.reduced(j_configs.get_config(arch), **over)
    j_specs = dict(_paths(j_model_api.build_model(
        j_cfg, max_seq=TRAIN["seq"]).param_specs))
    mesh = types.SimpleNamespace(shape=MESHES["2x2"])
    got = placed[f"{name}/1"]["local_shapes"]
    assert set(got) == set(j_specs)
    for path, s in j_specs.items():
        logical = s.logical if s.logical else (None,) * len(s.shape)
        spec = tuple(j_rules.resolve_spec(mesh, s.shape, logical,
                                          j_rules.PARAM_RULES))
        want = list(s.shape)
        for dim, entry in enumerate(spec):
            for a in (() if entry is None else
                      (entry,) if isinstance(entry, str) else entry):
                want[dim] //= MESHES["2x2"][a]
        assert got[path] == tuple(want), path


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("name", NAMES)
def test_shard_constraint_fires_at_its_derived_count(placed, name):
    # the derivation phase 14 (a) of chip_smoke.py holds the card's run to
    smoke = _smoke()
    _, arch, over = _case(name)
    cfg = case_cfg(arch, over)
    for steps in (1, 2):
        assert placed[f"{name}/{steps}"]["calls"] == \
            smoke.mesh_constraint_plan(cfg, steps)


def test_placed_step_collectives_equal_the_dry_runs_trace(placed):
    """One eager placed step of the phi3 case on the four gloo ranks, its
    collectives as ``utils.comms.CommRecorder`` sees them on rank 0,
    equals ``costmodel.measure``'s trace of the same step (its layers,
    batch and sequence, the CLI's fused lanes) at (2, 2) on a fake group
    of 4: count and bytes by axis and kind, bytes by kind, by axis and by
    issuing line. The trace steps as ``Federation.sync_step`` does, so it
    carries the all-reduce over "data" of the replicated parameters'
    partial-sum gradients (``optim.placed_like_params``), the one the JAX
    package's compiled step inserts. Both run DTensor's Shard(i) ->
    Shard(j) redistributes as NCCL does, one all-to-all each
    (``utils.comms.nccl_alltoall``), where DTensor's CPU route would
    all-gather. ``chip_smoke.py --mesh-ranks D`` holds the same equality
    on NCCL."""
    got, want = placed["comms"], placed["measure"]
    grad_sum = [k for k in got["by_site"]
                if k.startswith("data all-reduce optim/optimizers.py")]
    assert grad_sum, sorted(got["by_site"])
    assert {"data all-to-all", "model all-to-all"} <= set(got["by_axis_kind"])
    assert set(got["by_axis"]) == {"data", "model"}
    for key in ("by_axis_kind", "by_kind", "by_axis", "by_site"):
        assert got[key] == want[key], key


def test_card_f32_gate_holds_each_update():
    """``chip_smoke.py --mesh-ranks D``'s f32 gate (``f32_check``) on a
    step made here: a client leaf whose update is the unplaced one scaled
    as its own ĥ − h says (9.5 f32 spacings of the loss against 8; the
    loss logged at 10), server leaves off by a tenth of their update,
    within their floor. It holds that step; it fails on a server update
    or the client's update dropped, on a client update scaled apart from
    its ĥ − h, and, by its controls, when ĥ − h is too few spacings for a
    dropped client update to show."""
    smoke = _smoke()
    g = torch.Generator().manual_seed(0)
    table, wq = "params/embed/table", "params/blocks/attn/wq"
    start = {table: torch.randn(64, 32, generator=g) * 0.02,
             wq: torch.randn(4, 32, 32, generator=g) * 0.02,
             "params/blocks/ln1/scale": torch.ones(4, 32)}
    sp = float(np.spacing(np.float32(10.4)))
    dw = {table: 0.08 * sp * torch.randn(64, 32, generator=g) * 1e3,
          wq: torch.randn(4, 32, 32, generator=g) * 1e-4,
          "params/blocks/ln1/scale": torch.randn(4, 32, generator=g) * 1e-4}
    want = {k: start[k] + d for k, d in dw.items()}
    got = {k: start[k] + (d * 9.5 / 8 if k == table else d + 0.1 * d.abs()
                          .max() * torch.randn(d.shape, generator=g))
           for k, d in dw.items()}
    floor = {k: float(0.3 * d.abs().max()) for k, d in dw.items()}

    def check(got, signal=(-10 * sp, -8 * sp)):
        return smoke.f32_check(10.4, got, 10.4, want, {table}, start, floor,
                               signal, sp)
    ok = check(got)
    assert ok["held"] and not ok["blind"], ok
    assert ok["scalars"][table] == pytest.approx(9.5 / 8, rel=1e-4)
    for leaf, moved in ((wq, start[wq]), (table, start[table]),
                        (table, start[table] + 0.75 * (got[table]
                                                       - start[table]))):
        bad = check(dict(got, **{leaf: moved}))
        assert not bad["held"], (leaf, bad)
    blind = check(got, signal=(-1 * sp, -sp * 8 / 9.5))
    assert not blind["held"]
    assert blind["blind"] == [f"{table} zeroed", f"{table} doubled"]


def test_the_trace_reduce_scatters_each_gradient_in_its_dtype(placed):
    """What the optimizer wrapper changed in the dry run's trace, the bf16
    phi3 step at (2, 2) traced both ways: bare sgd's update
    (``p.float() - eta * g.float()``) upcasts a server gradient, still a
    partial sum over "data", before DTensor reduce-scatters it to its
    parameter's shard, so its reduce-scatter moved f32;
    ``placed_like_params`` reduce-scatters the bf16 gradient itself (half
    the bytes, as the JAX package's compiled step does) and adds the
    all-reduce of the replicated parameters' gradients. Beside that only
    the logged norms' sites move: bare sgd's norms still reduce-scatter
    each whole f32 gradient, the placed step's all-reduce 0-dim sums."""
    like, bare = placed["measure"]["bf16"], placed["measure"]["bf16_bare"]
    opt = "optim/optimizers.py"

    def at(sites, kind):
        return {k: n for k, n in sites.items()
                if k.startswith(f"data {kind} {opt}")}
    (scatter, n_like), = at(like, "reduce-scatter").items()
    (bare_scatter, n_bare), = at(bare, "reduce-scatter").items()
    assert scatter.endswith(" like") and bare_scatter.endswith(" <lambda>")
    assert n_bare == 2 * n_like > 0
    assert at(like, "all-reduce") and not at(bare, "all-reduce")
    # nothing else moves but the logged norms: bare sgd places nothing
    # (``Optimizer.place`` is the identity), so its norms square each
    # server gradient still a partial sum and DTensor reduce-scatters its
    # f32 upcast there; the placed step's norms sum the placed
    # gradients' squares and reduce 0-dim sums only
    assert {k: n for k, n in like.items()
            if opt not in k and not _at_norms(k)} == \
        {k: n for k, n in bare.items() if opt not in k and not _at_norms(k)}
    (bare_norm, n_norm), = {k: n for k, n in bare.items()
                            if _at_norms(k) and k.startswith(
                                "data reduce-scatter ")}.items()
    assert n_norm == n_bare
    _only_scalars(like, placed["measure"]["bf16_shapes"], 2)


def _at_norms(key) -> bool:
    """Whether a ``comms.bytes_by_site`` key ("axis kind site") names a
    line of ``core/cascade.py`` itself: the logged norms' sites. (A
    backward collective's site reads "backward core/cascade.py ...
    _value_and_grad", the frame autograd runs the model's backward
    from: the model's.)"""
    return key.split(" ", 2)[2].startswith("core/cascade.py")


def _only_scalars(by_site, shapes, norms) -> int:
    """Every collective at the norms' sites an all-reduce of 0-dim
    tensors, one over each mesh axis for each of the ``norms`` norms a
    step logs (a 0-dim f32 all-reduce moves 8 bytes); returns their
    bytes."""
    at = {k: n for k, n in by_site.items() if _at_norms(k)}
    assert {k.split(" ")[0] for k in at} == {"data", "model"}, sorted(at)
    for k in at:
        assert k.split(" ")[1] == "all-reduce" and shapes[k] == [[]], \
            (k, shapes[k])
    assert sum(at.values()) == 8 * 2 * norms, at
    return sum(at.values())


@pytest.mark.parametrize("trace", ["f32", "bf16", "vafl"])
def test_the_norms_reduce_only_scalars(placed, trace):
    """Each step factory places its gradient trees once
    (``Optimizer.place``: each gradient reduced to its parameter's
    placement in its own dtype, at the update's site ``optim/optimizers.py
    ... like``) and reads its logged norms from them: each leaf's squares
    summed on its shard, only 0-dim sums reduced. In the dry run's trace
    of the phi3 case at (2, 2) every collective at a line of
    ``core/cascade.py`` is an all-reduce of a 0-dim sum, one an axis for
    each norm (the cascaded step logs two, the FOO step one, computed
    once), and the step moves the bytes outside those sites
    (``OUTSIDE_NORMS``) and those scalars only: the cascaded f32 and bf16
    steps and the f32 FOO step (``method="vafl"``). One eager placed
    cascaded step on the four gloo ranks carries the same at those
    sites."""
    m = placed["measure"]
    by_site, shapes, total, norms = {
        "f32": (m["by_site"], m["shapes"], m["by_kind"]["total"], 2),
        "bf16": (m["bf16"], m["bf16_shapes"], None, 2),
        "vafl": (m["vafl"]["by_site"], m["vafl"]["shapes"],
                 m["vafl"]["by_kind"]["total"], 1)}[trace]
    scalars = _only_scalars(by_site, shapes, norms)
    if total is not None:
        assert total == OUTSIDE_NORMS[trace] + scalars
    if trace == "f32":
        got = placed["comms"]
        _only_scalars(got["by_site"], got["shapes_by_site"], norms)


@pytest.mark.parametrize("name", NAMES)
def test_placed_norms_match_the_unplaced_norms(placed, unplaced, name,
                                               tmp_path):
    """Each step's logged gradient norms of the placed f32 run, read from
    its placed gradients, against the unplaced run's, at the first step
    of the one- and the two-step runs (the same start) and at the second
    step taken alone from the placed run's own first step. |g_s| differs
    by the order of reduction alone: within 1e-5 relative. The client's
    ZOO gradient (one query) is φ/μ (ĥ − h) u, the same u placed or not,
    and ĥ − h is 51 to 323 f32 spacings of the loss in these steps, so a
    spacing moves |g_c| by 0.3–2% (the client update's scalar of
    ``test_two_placed_steps_match_the_unplaced_steps``): |g_c| is held to
    the unplaced |g_c| scaled by the two steps' ĥ − h, within 2 spacings
    of the placed ĥ − h."""
    def first(n):
        return (placed[f"{name}/{n}"]["outputs"][0],
                unplaced[f"{name}/{n}"]["outputs"][0])
    assert [len(placed[f"{name}/{n}"]["outputs"]) for n in (1, 2)] == [1, 2]
    alone = _second_step_from(name, placed[f"{name}/1"]["params"], tmp_path)
    pairs = [first(1), first(2),
             (placed[f"{name}/2"]["outputs"][1], alone["outputs"][0])]
    for got, want in pairs:
        np.testing.assert_allclose(got["grad_server_norm"],
                                   want["grad_server_norm"], rtol=1e-5)
        dg, dw = (abs(o["loss_perturbed"] - o["loss"]) for o in (got, want))
        # the placed |g_c| over the draw's φ/μ |u| (the unplaced run's
        # |g_c| / |ĥ − h|): the placed step's own ĥ − h, which its ranks
        # form from partial losses, each rounded, so within 2 spacings
        spacing = float(np.spacing(np.float32(got["loss"])))
        implied = got["grad_client_norm"] * dw / want["grad_client_norm"]
        assert abs(implied - dg) <= 2 * spacing, (implied, dg, spacing)


def test_card_norm_gate_reads_the_trace(placed):
    """``chip_smoke.py --mesh-ranks D``'s norm gate (``norm_sites``,
    ``beyond_scalars``) on the dry run's bf16 traces: it finds the norms'
    sites at the lines of ``core/cascade.py`` only (not the backward's,
    which autograd runs from ``_value_and_grad``), passes the placed
    step's 0-dim all-reduces, and names bare sgd's f32 reduce-scatter
    and all-reduce of whole gradients there."""
    smoke = _smoke()
    m = placed["measure"]
    like = smoke.norm_sites({"by_site": m["bf16"],
                             "shapes_by_site": m["bf16_shapes"]})
    bare = smoke.norm_sites({"by_site": m["bf16_bare"],
                             "shapes_by_site": m["bf16_bare_shapes"]})
    assert like and all(" backward " not in k for k in like)
    assert smoke.beyond_scalars(like) == []
    assert sorted(k.split(" ")[:2] for k in smoke.beyond_scalars(bare)) \
        == [["data", "all-reduce"], ["data", "reduce-scatter"]]


def test_production_mesh_refuses_a_four_rank_group(placed):
    assert "needs 256 ranks" in placed["production_mesh"]


def test_train_on_a_mesh_builds_the_compiled_step(placed):
    """``train(mesh=)`` steps through ``fed.sync_step(opt, graph=True)``,
    a ``GraphedFn``, as the unplaced run does; its result carries
    ``step_graph`` only on the card."""
    for name in FORMS:
        got = placed[f"{name}/graphed"]
        assert got["step_type"] == ["GraphedFn"], name
        assert "step_graph" not in got
        assert placed[f"{name}/bare"]["step_type"] == ["function"]


@pytest.mark.parametrize("name", FORMS)
def test_placed_compiled_loop_is_bitwise_its_body(placed, name):
    """Two steps of the compiled placed step's loop form (its static
    DTensor buffers, the batch copied in and the draws recorded once and
    refilled shard by shard) are bitwise its body's called bare on the
    run's own trees: losses, final parameters, wire and DP accounting.
    (The functional eager step is held to it too, in
    ``test_functional_placed_step_keeps_placements_and_bits``: both bring
    each gradient to its parameter's placement before the update.)"""
    got, want = placed[f"{name}/graphed"], placed[f"{name}/bare"]
    for key in ("loss_first", "loss_last", "wire_bytes_per_round",
                "dp_epsilon", "dp_delta"):
        assert got.get(key) == want.get(key), key
    assert set(got["params"]) == set(want["params"])
    for path, w in want["params"].items():
        assert torch.equal(got["params"][path], w), path


def test_placed_compiled_step_with_dp_matches_the_unplaced_steps(placed,
                                                                 unplaced):
    """The DP channel's placed compiled step against the unplaced run on
    the same noise: held as the two-step case is (the loss's rounding in
    sharded sums, times φ/μ, reaches the client)."""
    name = DP_CASE[0]
    got, want = placed[f"{name}/graphed"], unplaced[f"{name}/2"]
    _check(got, want, "phi3", ZOO_TOL, one_step=False)
    np.testing.assert_allclose(got["loss_last"], want["loss_last"],
                               **ZOO_TOL)
    assert (got["dp_epsilon"], got["dp_delta"]) == (want["dp_epsilon"],
                                                    want["dp_delta"])


def test_signature_keys_dtensors_by_placement(placed):
    """Two DTensors of one global shape and dtype placed Shard(0) and
    Replicate() get different ``graphs.signature`` keys (a graph a
    placement); two placed alike share one. A buffer refills only from
    its own placement, shard by shard."""
    sig = placed["signature"]
    assert not sig["shard_vs_replicate"] and sig["shard_vs_shard"]
    assert "Shard(dim=0)" in sig["keys"][0]
    assert "Replicate()" in sig["keys"][1]
    assert "cannot refill" in sig["refused"]
    assert torch.equal(sig["copied"],
                       torch.arange(32, dtype=torch.float32).reshape(8, 4))


@pytest.mark.parametrize("name", NAMES)
def test_functional_placed_step_keeps_placements_and_bits(placed, name):
    """Two functional eager placed steps (``fed.sync_step(opt)``, new trees
    from ``optim.sgd``'s ``update``) return every leaf in the placement
    ``PARAM_RULES`` gives it (the norm scales, replicated parameters whose
    gradients over the sharded batch are partial sums, included), and are
    bitwise the compiled placed step's loop form: losses, parameters,
    wire accounting."""
    got, want = placed[f"{name}/functional"], placed[f"{name}/graphed"]
    assert got["step_type"] == ["function"]
    assert got["placements"] == got["rule_placements"]
    for key in ("loss_first", "loss_last", "wire_bytes_per_round"):
        assert got[key] == want[key], key
    assert set(got["params"]) == set(want["params"])
    for path, w in want["params"].items():
        assert torch.equal(got["params"][path], w), path


def _manifest(path):
    with open(os.path.join(path, "session.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", RESUMED)
def test_placed_resume_is_bitwise_the_straight_run(placed, name):
    """A placed run saved at step k and resumed, placed, to 2k is bitwise
    the straight-through placed run: each step's loss, the parameters
    (each in its ``PARAM_RULES`` placement), and the checkpoints both
    write at 2k (step, ledger counts, DP releases, every leaf of the
    parameters and the optimizer state)."""
    saved, resumed = placed[f"{name}/saved"], placed[f"{name}/resumed"]
    straight = placed[f"{name}/straight"]
    assert len(saved["losses"]) == RESUME_AT
    assert saved["losses"] + resumed["losses"] == straight["losses"]
    assert resumed["start_step"] == RESUME_AT
    assert resumed["placements"] == saved["placements"]
    for key in ("wire_bytes_per_round", "dp_epsilon", "dp_delta"):
        assert resumed.get(key) == straight.get(key), key
    for path, w in straight["params"].items():
        assert torch.equal(resumed["params"][path], w), path
    a, b = f"{placed['ck']}_{name}_resumed", f"{placed['ck']}_{name}_straight"
    ma, mb = _manifest(a), _manifest(b)
    for key in ("step", "ledger_counts", "dp_releases", "noise"):
        assert ma[key] == mb[key], key
    _, pa, sa = Federation.restore(a, device="cpu")
    _, pb, sb = Federation.restore(b, device="cpu")
    fa = _flat({"params": pa, "opt": sa.opt_state})
    fb = _flat({"params": pb, "opt": sb.opt_state})
    assert set(fa) == set(fb)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


@pytest.mark.parametrize("name", RESUMED)
def test_placed_checkpoint_matches_the_unplaced_one(placed, unplaced_saved,
                                                    name):
    """The placed run's checkpoint at step k, in ``checkpoint/io.py``'s
    format, against the unplaced run's: step, ledger and DP releases
    exact, parameters at the ZOO tolerance the placed-vs-unplaced tests
    use (the loss's rounding in sharded sums, times φ/μ, reaches the
    client). It also resumes unplaced: two more steps from it stay at
    that tolerance of the placed straight-through run."""
    ck = f"{placed['ck']}_{name}"
    mine, theirs = _manifest(ck), _manifest(str(unplaced_saved / name))
    for key in ("step", "ledger_counts", "dp_releases", "layout",
                "has_opt_state"):
        assert mine[key] == theirs[key], key
    _, p, st = Federation.restore(ck, device="cpu")
    _, q, sq = Federation.restore(str(unplaced_saved / name), device="cpu")
    fp, fq = _flat(p), _flat(q)
    assert set(fp) == set(fq)
    for k in fp:
        np.testing.assert_allclose(fp[k], fq[k], err_msg=k, **ZOO_TOL)
    assert torch.equal(st.opt_state["step"], sq.opt_state["step"])
    with torch_threads(1):
        r = train(steps=2 * RESUME_AT, resume=ck, **TRAIN)
    straight = placed[f"{name}/straight"]
    got = dict(_paths(r["params"]))
    assert set(got) == set(straight["params"])
    for path, w in straight["params"].items():
        np.testing.assert_allclose(got[path].numpy(), w.numpy(), err_msg=path,
                                   **ZOO_TOL)
    assert (r.get("dp_epsilon"), r.get("dp_delta")) == (
        straight.get("dp_epsilon"), straight.get("dp_delta"))


@pytest.mark.parametrize("name", RESUMED)
def test_placed_checkpoint_restores_in_repro(placed, name):
    """``repro``'s ``Federation.restore`` reads the placed run's checkpoint:
    its parameters and optimizer state equal the port's restore of the
    same directory, leaf for leaf, and its step, ledger and DP releases
    are the saved ones."""
    ck = f"{placed['ck']}_{name}"
    _, p, st = Federation.restore(ck, device="cpu")
    _, jp, jst = JFederation.restore(ck)
    assert (jst.step, jst.dp_releases) == (st.step, st.dp_releases)
    assert jst.ledger.to_counts() == st.ledger.to_counts()
    fp = _flat({"params": p, "opt": st.opt_state})
    fj = _flat({"params": jp, "opt": jst.opt_state})
    assert set(fp) == set(fj)
    for k in fp:
        np.testing.assert_array_equal(fp[k], fj[k], err_msg=k)
