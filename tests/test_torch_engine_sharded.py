"""The port's sharded async engine (``EngineConfig.mesh_shards``) on the
CPU: every shard is a process of a gloo group, spawned through
``tests/_torch_sharded_child.py`` and joined through a ``FileStore`` in
``tmp_path``, so no pytest worker holds a process group. Three groups run
at once (1, 2 and 4 ranks); each rank runs its cases and rank 0 returns
them. The unsharded engine runs the same cases here.

What holds (``repro``'s ``tests/test_async_sharded.py`` and its child,
case for case):

* one shard, block 1 over 25 rounds and block 4 over 15: bitwise the
  unsharded engine;
* the sharded round loop called with ``graph=True`` (the card captures
  it; gloo loops it) and with ``graph=False``: bitwise equal, every
  sharded case;
* 2 and 4 shards over 8 clients, blocks 4 and 8 (and at 2 shards the
  vafl and zoo-vfl methods, the fused lanes and the DP channel): losses,
  params, the gathered table and the delays bitwise the unsharded run's.
  Every rank draws the whole block and keeps its rows, the gathers and
  the one-value-plus-zeros sums are exact, and the per-row products of a
  block of R / D rows round as the R-row block's do on the CPU, so no
  case needs a tolerance;
* one shard fed ``repro``'s draws against ``repro``'s
  ``make_client_mesh(1)`` path: one step at the engine tests' f32
  tolerances (``assert_round_parity``) and 25 normal-direction rounds at
  ``repro``'s trajectory atol 1e-3;
* the wire ledger is placement-invariant; sync methods, indivisible
  blocks and client counts, and mesh sizes out of range are refused; a
  sharded session saved, restored (the mesh rebuilt from the manifest's
  ``mesh_shards``) and run again equals the run without the break, and a
  ``repro`` session saved with ``mesh_shards`` restores and runs.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_sharded_child as child
from repro.configs.base import VFLConfig as JVFLConfig
from repro.configs.paper_mlp import PaperMLPConfig as JPaperMLPConfig
from repro.core import async_engine as j_engine
from repro.core.adapters import tabular_adapter as j_tabular_adapter
from repro.data import make_classification as j_make_classification
from repro.data import vertical_partition as j_vertical_partition
from repro.federation import Federation as JFederation
from repro.models import common as j_common
from repro.models import tabular as j_tabular
from repro.sharding.rules import PARAM_RULES as J_PARAM_RULES
from repro.sharding.rules import resolve_spec as j_resolve_spec
from repro_torch.configs.base import VFLConfig
from repro_torch.configs.paper_mlp import PaperMLPConfig
from repro_torch.core import async_engine
from repro_torch.core.partition import tree_leaves
from repro_torch.core.privacy import round_messages
from repro_torch.federation import Federation, Transport
from test_torch_support import (assert_round_parity, jax_make_schedule,
                                ledger_tuples, torch_threads)

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, os.pardir, "src")

ONE_STEP = dict(M=4, block=1, steps=1, q=1, mu=1e-2, n=64, batch=16,
                draws="jax")
TRAJ = dict(M=4, block=1, steps=25, q=2, mu=1e-3, n=512, batch=16,
            dist="normal", draws="jax")
CASES = {
    1: [dict(name="b1", M=4, block=1, steps=25),
        dict(name="b4", M=4, block=4, steps=15),
        dict(name="vafl", method="vafl", M=4, block=2, steps=25),
        dict(name="zoo-vfl", method="zoo-vfl", M=4, block=2, steps=25),
        dict(name="one_step", **ONE_STEP),
        dict(name="trajectory", **TRAJ),
        dict(name="mesh", kind="mesh")],
    2: [dict(name="b4", block=4, steps=15),
        dict(name="b8", block=8, steps=15),
        dict(name="vafl", method="vafl", block=4, steps=10),
        dict(name="zoo-vfl", method="zoo-vfl", block=4, steps=10),
        dict(name="lanes", block=4, steps=10, lanes=True),
        dict(name="dp", block=4, steps=10, noise=True),
        dict(name="resume", kind="resume", block=4, steps=6),
        dict(name="block3", kind="error", block=3),
        dict(name="mesh", kind="mesh")],
    4: [dict(name="b4", block=4, steps=15),
        dict(name="b8", block=8, steps=15),
        dict(name="six_clients", kind="error", M=6, block=4),
        dict(name="mesh", kind="mesh")],
}
RESTORE = dict(name="restore", kind="restore", M=4, block=2, steps=10)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    with torch_threads(1):
        yield


def _repro_session(c, mesh_shards):
    """``repro``'s session, params and data for a case."""
    c = dict(child.DEFAULTS, **c)
    jcfg = JPaperMLPConfig(n_features=32, n_classes=4, n_clients=c["M"],
                           client_embed=16, server_embed=32)
    X, y = j_make_classification(0, c["n"], jcfg.n_features, jcfg.n_classes)
    lr = child.LRS[c["method"]]
    vfl = JVFLConfig(mu=c["mu"], lr_server=lr, lr_client=lr,
                     zoo_queries=c["q"], zoo_dist=c["dist"])
    ec = j_engine.EngineConfig(method=c["method"], steps=c["steps"],
                               batch_size=c["batch"], block_size=c["block"],
                               seed=c["seed"], mesh_shards=mesh_shards)
    fed = JFederation.build(jcfg, vfl, ec)
    params = j_common.materialize(j_tabular.param_specs(jcfg),
                                  jax.random.key(c["seed"]))
    return fed, params, jnp.asarray(j_vertical_partition(X, c["M"])), \
        jnp.asarray(y)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{shards: {case name: results}} from three gloo groups run at once,
    the path of the ``repro`` session the one-shard group restored, and
    ``repro``'s mesh-path runs of the cases fed its draws (computed here
    while the groups run)."""
    tmp = tmp_path_factory.mktemp("sharded")
    jfed, jparams, _, _ = _repro_session(RESTORE, 1)
    saved = jfed.save(str(tmp / "repro_session"), jparams)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [SRC, HERE] + [p for p in [env.get("PYTHONPATH")] if p])
    procs, outs = [], {}
    for world, cases in CASES.items():
        cases = [dict(c, path=str(tmp / f"resume{world}"))
                 if c.get("kind") == "resume" else c for c in cases]
        if world == 1:
            cases = cases + [dict(RESTORE, path=saved)]
        spec = tmp / f"cases{world}.json"
        spec.write_text(json.dumps(cases))
        outs[world] = str(tmp / f"out{world}.pt")
        for rank in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, os.path.join(HERE, "_torch_sharded_child.py"),
                 str(rank), str(world), str(tmp / f"store{world}"),
                 outs[world], str(spec)],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    failed = []
    try:
        repro_runs = {"one_step": _repro_rounds(ONE_STEP),
                      "trajectory": _repro_rounds(TRAJ)}
        for p in procs:
            text, _ = p.communicate(timeout=240)
            if p.returncode:
                failed.append(text)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert not failed, "\n".join(failed)
    return {world: torch.load(path, weights_only=False)
            for world, path in outs.items()}, saved, repro_runs


def _flat(tree):
    return {f"{k}/{n}": t for k, v in tree.items() for n, t in v.items()}


def _assert_bitwise(got, want):
    assert np.array_equal(got["res"].losses, want["res"].losses)
    for key in ("table", "delays", "losses", "maxd"):
        assert torch.equal(got[key], want[key]), key
    for params in ("params",):
        a, b = _flat(got[params]), _flat(want[params])
        assert sorted(a) == sorted(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k
    for a, b in zip(tree_leaves(got["res"].params),
                    tree_leaves(want["res"].params)):
        assert torch.equal(a, b)
    assert got["res"].max_delay_seen == want["res"].max_delay_seen
    assert got["res"].mean_delay == want["res"].mean_delay
    assert ledger_tuples(got["res"].ledger) == ledger_tuples(
        want["res"].ledger)
    assert (got["res"].wire_bytes, got["res"].transmits_gradients) == (
        want["res"].wire_bytes, want["res"].transmits_gradients)


SHARDED = [(w, c["name"]) for w, cases in CASES.items() for c in cases
           if c.get("kind", "run") == "run" and c.get("draws") != "jax"]


@pytest.mark.parametrize("world,name", SHARDED)
def test_sharded_equals_unsharded_bitwise(runs, world, name):
    case = next(c for c in CASES[world] if c["name"] == name)
    got = runs[0][world][name]
    want = child.run_case(case)
    assert np.isfinite(got["res"].losses).all()
    _assert_bitwise(got, want)


@pytest.mark.parametrize("world,name", SHARDED)
def test_sharded_loop_form_ignores_the_graph_switch(runs, world, name):
    """On gloo the sharded runner loops its round body whether it is
    called with ``graph=True`` (as ``Federation.run`` calls it: the card
    would capture the round) or ``graph=False``: the two loops are
    bitwise equal (and the first is held to the unsharded engine
    above)."""
    got = runs[0][world][name]
    on, off = got, got["graph_off"]
    for key in ("table", "delays", "losses", "maxd"):
        assert torch.equal(on[key], off[key]), key
    a, b = _flat(on["params"]), _flat(off["params"])
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _repro_rounds(c):
    """``repro``'s ``make_client_mesh(1)`` path for a case: ``run`` and
    its round loop on the same mesh (the dict ``assert_round_parity``
    reads)."""
    c = dict(child.DEFAULTS, **c)
    fed, params, jx, jy = _repro_session(c, 1)
    assert fed.mesh is not None and fed.mesh.shape["data"] == 1
    M, T, blk = c["M"], c["steps"], c["block"]
    k_sched, k_idx, k_zoo = jax.random.split(jax.random.key(c["seed"]), 3)
    sched = jax_make_schedule(k_sched, T, M, None, blk).reshape(T, blk)
    idx = jax.random.randint(k_idx, (T, c["batch"]), 0, c["n"])
    ad = j_tabular_adapter(JPaperMLPConfig(
        n_features=32, n_classes=4, n_clients=M, client_embed=16,
        server_embed=32))
    table0 = jax.vmap(ad.client_forward)(params["clients"], jx)
    spec = j_resolve_spec(fed.mesh, table0.shape, ad.table_logical,
                          J_PARAM_RULES)
    runner = j_engine._make_runner(ad, fed.transport, fed.vfl, False, blk,
                                   False, fed.mesh, spec)
    (p, tab, dl), (ls, md) = runner(
        params, table0, jnp.zeros((M, c["n"]), jnp.int32), sched, idx,
        jax.random.split(k_zoo, T), jx, jy)
    return {"res": fed.run(params, jx, jy), "params0": params, "params": p,
            "table": tab, "delays": dl, "losses": ls, "maxd": md}


def test_one_shard_step_matches_repro_mesh_path(runs):
    """The port's one-shard step on ``repro``'s draws against ``repro``'s
    shard_map path on its one-device mesh, at the engine tests' f32
    tolerances."""
    assert_round_parity("cascaded", runs[2]["one_step"],
                        runs[0][1]["one_step"])


def test_one_shard_trajectory_matches_repro_mesh_path(runs):
    """25 normal-direction rounds (φ = 1) against ``repro``'s mesh path at
    ``repro``'s trajectory atol 1e-3."""
    j, t = runs[2]["trajectory"], runs[0][1]["trajectory"]
    assert t["res"].losses.shape == (25,)
    np.testing.assert_allclose(t["res"].losses, np.asarray(j["res"].losses),
                               atol=1e-3)
    assert t["res"].max_delay_seen == j["res"].max_delay_seen
    assert ledger_tuples(t["res"].ledger) == ledger_tuples(j["res"].ledger)


def test_sharded_wire_accounting_is_placement_invariant(runs):
    """Block rounds log block x the per-client messages whatever the mesh;
    VAFL ships gradients, the ZOO methods do not."""
    q, bs = 2, 8
    per = {m: sum(msg.nbytes for msg in round_messages(m, bs, 16, q))
           for m in ("cascaded", "vafl", "zoo-vfl")}
    for world, name, method, block, steps in (
            (2, "b4", "cascaded", 4, 15), (4, "b8", "cascaded", 8, 15),
            (2, "vafl", "vafl", 4, 10), (2, "zoo-vfl", "zoo-vfl", 4, 10),
            (1, "b4", "cascaded", 4, 15)):
        res = runs[0][world][name]["res"]
        assert res.wire_bytes == steps * block * per[method], (world, name)
        assert res.transmits_gradients == (method == "vafl")


def test_sharded_errors_and_mesh_bounds(runs):
    got = runs[0]
    assert "block_size=3" in got[2]["block3"]["error"]
    assert "n_clients=6" in got[4]["six_clients"]["error"]
    for world in (1, 2, 4):
        mesh = got[world]["mesh"]
        assert mesh["all"] == world
        assert "out of range" in mesh[0]
        assert "out of range" in mesh[world + 1]
        assert mesh["host"] == ("data", "model")
        # the production meshes need 256 and 512 ranks
        assert "needs 256 ranks" in mesh[("production", False)]
        assert "needs 512 ranks" in mesh[("production", True)]
        # a CUDA mesh over gloo is refused: CUDA tensors never go
        # through gloo
        assert "nccl" in mesh["cuda_on_gloo"]


def test_mesh_needs_a_process_group_and_rejects_sync_and_conflicts():
    """No group: no mesh (the engine never falls back to one device).
    Sync methods, a mesh without a "data" axis and indivisible blocks or
    client counts are refused as ``repro`` refuses them, and an explicit
    mesh with ``mesh_shards`` is a conflict."""
    cfg = PaperMLPConfig(n_features=32, n_classes=4, n_clients=4,
                         client_embed=16, server_embed=32)
    vfl = VFLConfig(mu=1e-3, lr_server=0.05, lr_client=0.05)
    with pytest.raises(RuntimeError, match="process group"):
        Federation.build(cfg, vfl, async_engine.EngineConfig(mesh_shards=1),
                         device="cpu")
    with pytest.raises(ValueError, match="mesh_shards"):
        Federation.build(cfg, vfl, async_engine.EngineConfig(mesh_shards=1),
                         mesh={"data": 1}, device="cpu")
    X = np.zeros((4, 16, 8), np.float32)
    y = np.zeros(16, np.int64)
    params = Federation.build(cfg, vfl, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="asynchronous"):
        async_engine.run(async_engine.EngineConfig(method="split", steps=2,
                                                   batch_size=8),
                         vfl, params, X, y, device="cpu", mesh={"data": 1})
    with pytest.raises(ValueError, match="block_size"):
        async_engine._validate_mesh({"data": 3}, False, "cascaded", block=4,
                                    M=6)
    with pytest.raises(ValueError, match="n_clients"):
        async_engine._validate_mesh({"data": 3}, False, "cascaded", block=3,
                                    M=4)
    with pytest.raises(ValueError, match="axis"):
        async_engine._validate_mesh({"model": 2}, False, "cascaded",
                                    block=2, M=4)
    with pytest.raises(ValueError, match="shards by PROCESS"):
        async_engine.run_population(
            Federation.build(cfg, device="cpu").adapter,
            Transport("cascaded"), vfl,
            async_engine.EngineConfig(mesh_shards=2), params,
            torch.from_numpy(X), torch.from_numpy(y), draws=None)


def test_sharded_session_resumes_bitwise(runs):
    """Two ranks: a run, ``fed.save``, ``Federation.restore`` (the mesh
    rebuilt from ``mesh_shards`` = 2) and a second run, against the second
    run without the break."""
    got = runs[0][2]["resume"]
    assert got["mesh_shards"] == 2 and got["mesh_size"] == 2
    assert got["step"] == 6
    a, b = got["unbroken"], got["resumed"]
    assert np.array_equal(a.losses, b.losses)
    for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)):
        assert torch.equal(x, y)
    assert (a.max_delay_seen, a.mean_delay, a.wire_bytes) == (
        b.max_delay_seen, b.mean_delay, b.wire_bytes)


def test_repro_session_with_mesh_shards_restores(runs):
    """A session ``repro`` saved with ``mesh_shards=1`` restores on one
    gloo rank, its engine config intact, and runs bitwise as the same
    session unsharded."""
    runs_, saved, _ = runs
    with open(os.path.join(saved, "session.json")) as f:
        assert json.load(f)["engine"]["mesh_shards"] == 1
    got = runs_[1]["restore"]
    assert got["engine"].mesh_shards == 1
    fed = Federation.build(
        PaperMLPConfig(n_features=32, n_classes=4, n_clients=4,
                       client_embed=16, server_embed=32), got["vfl"],
        dataclasses.replace(got["engine"], mesh_shards=0), device="cpu")
    _, _, xp, y = child.setup(RESTORE, 0)
    want = child.rounds(fed, got["params0"], xp, y,
                        lambda: child.make_draws(RESTORE))
    _assert_bitwise(got, want)
