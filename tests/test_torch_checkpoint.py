"""The port's party-scoped checkpoints (``Federation.save``/``restore``,
``federation/parties.py``, ``checkpoint/io.py``), mirroring the JAX
package's lifecycle tests (``tests/test_federation_lifecycle.py``): the
party handles in both layouts, per-party isolation, the save/restore
round trip, resume-equivalence through ``launch/train.py``, the schedule
horizon kept on resume, exhausted steps and a party-count mismatch
refused — and the format shared with ``repro``: a session saved by either
package restores in the other, bit for bit (bf16 leaves as uint16
views)."""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import VFLConfig as JVFLConfig
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.core.async_engine import EngineConfig as JEngineConfig
from repro.core.privacy import GaussianLossChannel as JChannel
from repro.federation import Federation as JFederation
from repro.models import common as j_common
from repro.models.model_api import build_model as j_build_model
from repro.optim import sgd as j_sgd
from repro_torch.checkpoint import load_checkpoint, load_tree, save_checkpoint
from repro_torch.configs import VFLConfig, get_config, reduced
from repro_torch.configs.paper_mlp import PaperMLPConfig
from repro_torch.core.adapters import tabular_adapter
from repro_torch.core.async_engine import EngineConfig
from repro_torch.core.privacy import GaussianLossChannel
from repro_torch.federation import Federation, SessionState
from repro_torch.models import common
from repro_torch.models.model_api import build_model
from repro_torch.optim import sgd
from repro_torch.tree import tree_leaves
from test_torch_support import _flat, torch_threads

SEQ = 16
TINY = dict(d_model=64, n_heads=2, n_kv_heads=1, d_ff=128, vocab_size=256)


def tiny_cfg(**overrides):
    return reduced(get_config("phi3-mini-3.8b"), **TINY, **overrides)


def j_tiny_cfg(**overrides):
    return j_reduced(j_get_config("phi3-mini-3.8b"), **TINY, **overrides)


@pytest.fixture(autouse=True)
def _threads():
    with torch_threads(2):
        yield


@pytest.fixture(scope="module")
def lm_session():
    cfg = tiny_cfg()
    fed = Federation.build(cfg, VFLConfig(), EngineConfig(method="cascaded"),
                           n_clients=2, seq_len=SEQ, device="cpu")
    return cfg, fed


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _global_params(cfg, seed=1):
    return common.materialize(build_model(cfg, max_seq=SEQ).param_specs,
                              _gen(seed))


def _equal_trees(a, b):
    fa, fb = _flat(a), _flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def _same_dtypes(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert x.dtype == y.dtype


# ---------------------------------------------------- party handles -------

def test_parties_engine_layout(lm_session):
    cfg, fed = lm_session
    params = fed.init_params(_gen())
    parties = fed.parties
    assert len(parties) == 3 and parties.server.name == "server"
    assert [p.name for p in parties] == ["server", "client_00", "client_01"]
    server = parties.server.owned(params)
    assert "embed" not in server and "lm_head" in server
    c0 = parties.clients[0].owned(params)
    assert c0["embed"]["table"].shape == (cfg.padded_vocab, cfg.d_model)
    assert torch.equal(c0["embed"]["table"],
                       params["clients"]["embed"]["table"][0])
    rebuilt = parties.assemble(server, [p.owned(params)
                                        for p in parties.clients])
    for a, b in zip(tree_leaves(params), tree_leaves(rebuilt)):
        assert torch.equal(a, b)


def test_parties_global_layout(lm_session):
    cfg, fed = lm_session
    gp = _global_params(cfg)
    parties = fed.parties
    server = parties.server.owned(gp)
    client = parties.clients[0].owned(gp)
    assert set(client) == {"embed"} and "embed" not in server
    assert set(parties.merge_global(server, client)) == set(gp)
    assert fed.client_keys == ("embed",)


# ------------------------------------- per-party checkpoint isolation -----

def _npz_keys(path, party_dir):
    with np.load(os.path.join(path, party_dir, "arrays.npz")) as data:
        return list(data.files)


def test_checkpoint_isolation_engine_layout(lm_session, tmp_path):
    cfg, fed = lm_session
    params = fed.init_params(_gen())
    path = fed.save(str(tmp_path / "ck"), params, step=7)
    assert sorted(os.listdir(path)) == ["client_00", "client_01",
                                        "server", "session.json"]
    server_keys = _npz_keys(path, "server")
    assert server_keys and not any(k.startswith("embed")
                                   for k in server_keys)
    for m in range(2):
        ckeys = _npz_keys(path, f"client_{m:02d}")
        assert ckeys == ["embed::table"]


def test_checkpoint_isolation_global_layout(lm_session, tmp_path):
    cfg, fed = lm_session
    gp = _global_params(cfg)
    opt = sgd(0.1, momentum=0.9)
    path = fed.save(str(tmp_path / "ck"), gp, step=3,
                    opt_state=opt.init(gp))
    assert not any(k.startswith("embed") for k in _npz_keys(path, "server"))
    assert all(k.startswith("embed") for k in _npz_keys(path, "clients"))
    # the optimizer's momentum tree splits on the same boundary
    assert not any("embed" in k for k in _npz_keys(path, "opt_server"))
    assert all("embed" in k for k in _npz_keys(path, "opt_clients"))


# ----------------------------------------------- save/restore roundtrip ---

def test_save_restore_roundtrip(lm_session, tmp_path):
    cfg, _ = lm_session
    noise = GaussianLossChannel(clip=5.0, epsilon=0.5, accountant="rdp")
    fed = Federation.build(cfg, VFLConfig(zoo_queries=2),
                           EngineConfig(method="cascaded"), n_clients=2,
                           seq_len=SEQ, noise=noise, device="cpu")
    params = fed.init_params(_gen())
    ledger = fed.transport.account(batch=4, embed=cfg.d_model, n_rounds=5,
                                   zoo_queries=2)
    path = fed.save(str(tmp_path / "ck"), params, step=5, ledger=ledger,
                    dp_releases=30)
    fed2, params2, state = Federation.restore(path, device="cpu")
    assert isinstance(state, SessionState)
    assert state.step == 5 and state.dp_releases == 30
    assert state.ledger.total_bytes == ledger.total_bytes
    assert state.ledger.bytes_by_kind() == ledger.bytes_by_kind()
    assert fed2.transport == fed.transport          # incl. the DP channel
    assert fed2.vfl == fed.vfl and fed2.model_cfg == cfg
    assert fed2.device.type == "cpu"
    _equal_trees(params, params2)
    _same_dtypes(params, params2)
    assert state.dp_spent(fed2.transport) == noise.spent(30)


def test_restore_runs_on_the_card_unless_asked_for_the_cpu(lm_session,
                                                           tmp_path):
    cfg, fed = lm_session
    path = fed.save(str(tmp_path / "ck"), fed.init_params(_gen()))
    if torch.cuda.is_available():
        _, params, _ = Federation.restore(path)
        assert tree_leaves(params)[0].is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            Federation.restore(path)


def test_restore_paper_mlp_session(tmp_path):
    cfg = PaperMLPConfig(n_features=16, n_classes=3, n_clients=2,
                         client_embed=8, server_embed=8)
    fed = Federation.build(cfg, VFLConfig(), EngineConfig(), device="cpu")
    params = fed.init_params(_gen())
    fed2, params2, _ = Federation.restore(
        fed.save(str(tmp_path / "ck"), params), device="cpu")
    assert fed2.n_clients == 2
    _equal_trees(params, params2)


def test_restore_adapter_session_needs_model(tmp_path):
    adapter = dataclasses.replace(
        tabular_adapter(PaperMLPConfig(n_features=8, n_classes=2,
                                       n_clients=2, client_embed=8,
                                       server_embed=8)), name="custom")
    fed = Federation.build(adapter, VFLConfig(), EngineConfig(),
                           device="cpu")
    params = fed.init_params(_gen())
    path = fed.save(str(tmp_path / "ck"), params)
    with pytest.raises(ValueError, match="adapter-built"):
        Federation.restore(path, device="cpu")
    fed2, params2, _ = Federation.restore(path, model_cfg=adapter,
                                          device="cpu")
    _equal_trees(params, params2)


def test_save_rejects_party_count_mismatch(tmp_path):
    """An adapter session whose stacked client dim disagrees with the
    session's n_clients must refuse a per-party save."""
    adapter = tabular_adapter(PaperMLPConfig(n_features=16, n_classes=2,
                                             n_clients=4, client_embed=8,
                                             server_embed=8))
    fed = Federation.build(adapter, VFLConfig(), EngineConfig(),
                           device="cpu")                  # default 2
    params = adapter.init_params(_gen())
    with pytest.raises(ValueError, match="n_clients=4"):
        fed.save(str(tmp_path / "ck"), params)
    fed4 = Federation.build(adapter, VFLConfig(), EngineConfig(),
                            n_clients=4, device="cpu")
    fed4.save(str(tmp_path / "ck"), params)
    assert sorted(p for p in os.listdir(tmp_path / "ck")
                  if p.startswith("client")) == [
        "client_00", "client_01", "client_02", "client_03"]


def test_load_checkpoint_into_a_structure(tmp_path):
    """``load_checkpoint(like)`` restores sequence nodes that ``load_tree``
    refuses, with ``[i]`` in the key path as the JAX package writes it."""
    tree = {"a": (torch.arange(3.0), torch.ones(2, dtype=torch.bfloat16)),
            "b": {"c": torch.tensor(7, dtype=torch.int32)}}
    save_checkpoint(str(tmp_path / "ck"), tree, step=4)
    with open(tmp_path / "ck" / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["keys"] == ["a::[0]", "a::[1]", "b::c"]
    assert manifest["dtypes"]["a::[1]"] == "bfloat16"
    got, step = load_checkpoint(str(tmp_path / "ck"), tree)
    assert step == 4 and isinstance(got["a"], tuple)
    for a, b in zip(tree_leaves(got), tree_leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(ValueError, match="load_checkpoint"):
        load_tree(str(tmp_path / "ck"))


# ------------------------------------------------ across the packages -----

def _j_session(noise=False):
    return JFederation.build(
        j_tiny_cfg(), JVFLConfig(zoo_queries=2),
        JEngineConfig(method="cascaded"), n_clients=2, seq_len=SEQ,
        noise=JChannel(clip=5.0, epsilon=0.5) if noise else None)


@pytest.mark.parametrize("layout", ["engine", "global"])
def test_session_saved_by_reference_restores_in_the_port(tmp_path, layout):
    jfed = _j_session(noise=True)
    if layout == "engine":
        jparams, jopt = jfed.init_params(jax.random.key(0)), None
    else:
        jparams = j_common.materialize(
            j_build_model(j_tiny_cfg(), max_seq=SEQ).param_specs,
            jax.random.key(1))
        jopt = j_sgd(0.1, momentum=0.9).init(jparams)
    jledger = jfed.transport.account(batch=4, embed=64, n_rounds=3,
                                     zoo_queries=2)
    path = jfed.save(str(tmp_path / "ck"), jparams, step=3, opt_state=jopt,
                     ledger=jledger, dp_releases=12,
                     metadata={"arch": "phi3-mini-3.8b"})
    fed, params, state = Federation.restore(path, device="cpu")
    assert fed.model_cfg == tiny_cfg() and fed.n_clients == 2
    assert fed.vfl == VFLConfig(zoo_queries=2)
    assert fed.transport.noise == GaussianLossChannel(clip=5.0, epsilon=0.5)
    assert state.step == 3 and state.dp_releases == 12
    assert state.metadata == {"arch": "phi3-mini-3.8b"}
    assert state.ledger.to_counts() == jledger.to_counts()
    _equal_trees(params, jparams)
    for t, j in zip(tree_leaves(params), jax.tree.leaves(jparams)):
        assert str(t.dtype).removeprefix("torch.") == str(j.dtype)
    if jopt is not None:
        _equal_trees(state.opt_state, jopt)
        assert state.opt_state["step"].dtype == torch.int32


@pytest.mark.parametrize("layout", ["engine", "global"])
def test_session_saved_by_the_port_restores_in_reference(tmp_path, layout):
    cfg = tiny_cfg()
    fed = Federation.build(cfg, VFLConfig(zoo_queries=2),
                           EngineConfig(method="cascaded"), n_clients=2,
                           seq_len=SEQ, device="cpu",
                           noise=GaussianLossChannel(clip=5.0, epsilon=0.5))
    if layout == "engine":
        params, opt_state = fed.init_params(_gen()), None
    else:
        params = _global_params(cfg)
        opt_state = sgd(0.1, momentum=0.9).init(params)
    ledger = fed.transport.account(batch=4, embed=64, n_rounds=3,
                                   zoo_queries=2)
    path = fed.save(str(tmp_path / "ck"), params, step=3,
                    opt_state=opt_state, ledger=ledger, dp_releases=12)
    jfed, jparams, jstate = JFederation.restore(path)
    assert jfed.model_cfg == j_tiny_cfg()
    assert jfed.transport.noise == JChannel(clip=5.0, epsilon=0.5)
    assert jstate.step == 3 and jstate.dp_releases == 12
    assert jstate.ledger.to_counts() == ledger.to_counts()
    _equal_trees(jparams, params)
    if opt_state is not None:
        _equal_trees(jstate.opt_state, opt_state)
    # the session manifests carry the same fields
    jpath = _j_session(noise=True).save(str(tmp_path / "jck"), jparams,
                                        step=3, opt_state=jstate.opt_state,
                                        ledger=jstate.ledger,
                                        dp_releases=12)
    with open(os.path.join(path, "session.json")) as f:
        ours = json.load(f)
    with open(os.path.join(jpath, "session.json")) as f:
        theirs = json.load(f)
    assert ours == theirs


@pytest.mark.parametrize("layout", ["engine", "global"])
def test_deepseek_session_crosses_both_ways(tmp_path, layout):
    """DeepSeek-V3's sessions (reduced, MLA at q/k head dim 48 and v 32):
    the engine layout's server holds dense_blocks and blocks and no MTP
    head, the global tree holds the MTP head too; a session saved by
    ``repro`` restores in the port and the port's save restores in
    ``repro``, bit for bit."""
    kw = dict(qk_nope_dim=32, qk_rope_dim=16, v_head_dim=32)
    jcfg = j_reduced(j_get_config("deepseek-v3-671b"), **kw)
    cfg = reduced(get_config("deepseek-v3-671b"), **kw)
    jfed = JFederation.build(jcfg, JVFLConfig(),
                             JEngineConfig(method="cascaded"), n_clients=2,
                             seq_len=SEQ)
    if layout == "engine":
        jparams = jfed.init_params(jax.random.key(0))
        assert "mtp" not in jparams["server"]
        assert {"dense_blocks", "blocks"} <= set(jparams["server"])
    else:
        jparams = j_common.materialize(
            j_build_model(jcfg, max_seq=SEQ).param_specs, jax.random.key(1))
        assert {"mtp", "dense_blocks", "blocks"} <= set(jparams)
    path = jfed.save(str(tmp_path / "jck"), jparams, step=2)
    fed, params, state = Federation.restore(path, device="cpu")
    assert fed.model_cfg == cfg and state.step == 2
    _equal_trees(params, jparams)
    back = fed.save(str(tmp_path / "ck"), params, step=2)
    jfed2, jparams2, jstate = JFederation.restore(back)
    assert jfed2.model_cfg == jcfg and jstate.step == 2
    _equal_trees(jparams2, params)


@pytest.mark.parametrize("arch", ["whisper-medium", "internvl2-26b"])
def test_modality_sessions_cross_both_ways(tmp_path, arch):
    """Whisper's and InternVL2's party-scoped sessions (reduced, the global
    layout the sync cascade trains: their split plane refuses the engine
    layout): the clients' directory holds the embedding and the modality
    projector and the server's neither, the optimizer state split on the
    same boundary; a session saved by ``repro`` restores in the port and
    the port's save restores in ``repro``, bit for bit."""
    jcfg, cfg = j_reduced(j_get_config(arch)), reduced(get_config(arch))
    jfed = JFederation.build(jcfg, JVFLConfig(),
                             JEngineConfig(method="cascaded"), seq_len=SEQ)
    jparams = j_common.materialize(
        j_build_model(jcfg, max_seq=SEQ).param_specs, jax.random.key(1))
    jopt = j_sgd(0.1, momentum=0.9).init(jparams)
    path = jfed.save(str(tmp_path / "jck"), jparams, step=2, opt_state=jopt)
    fed, params, state = Federation.restore(path, device="cpu")
    assert fed.model_cfg == cfg and state.step == 2
    assert fed.client_keys == ("embed", "proj")
    _equal_trees(params, jparams)
    _equal_trees(state.opt_state, jopt)
    back = fed.save(str(tmp_path / "ck"), params, step=2,
                    opt_state=state.opt_state)
    for where in (path, back):
        # the optimizer's leaves sit under its own key ("mom::embed::...")
        tops = {d: {k.split("::")[0] for k in _npz_keys(where, d)}
                for d in ("clients", "server")}
        tops.update({d: {k.split("::")[1] for k in _npz_keys(where, d)
                         if "::" in k}
                     for d in ("opt_clients", "opt_server")})
        assert tops["clients"] == tops["opt_clients"] == {"embed", "proj"}
        assert not tops["server"] & {"embed", "proj"}
        assert tops["opt_server"] == tops["server"]
    jfed2, jparams2, jstate = JFederation.restore(back)
    assert jfed2.model_cfg == jcfg and jstate.step == 2
    _equal_trees(jparams2, params)
    _equal_trees(jstate.opt_state, state.opt_state)


# ---------------------------------------------- mid-training resume -------

def test_train_resume_equivalence(tmp_path):
    """Save at step k, restore, continue → allclose to the straight-through
    run at step 2k; ledger and (ε, δ) totals exactly continued."""
    from repro_torch.launch.train import train

    noise = GaussianLossChannel(clip=10.0, epsilon=1.0)
    kw = dict(batch=4, seq=SEQ, log_every=1000, noise=noise, device="cpu")
    A = str(tmp_path / "straight")
    B1, B2 = str(tmp_path / "half"), str(tmp_path / "resumed")
    ra = train("phi3-mini-3.8b", steps=4, checkpoint_path=A, **kw)
    train("phi3-mini-3.8b", steps=2, checkpoint_path=B1, **kw)
    rb = train(steps=4, resume=B1, checkpoint_path=B2, log_every=1000,
               device="cpu")
    assert rb["start_step"] == 2 and rb["resumed_from"] == B1

    for party in ("server", "clients"):
        ta, _, _ = load_tree(os.path.join(A, party))
        tb, _, _ = load_tree(os.path.join(B2, party))
        fa, fb = _flat(ta), _flat(tb)
        assert sorted(fa) == sorted(fb)
        for k in fa:
            np.testing.assert_allclose(fa[k], fb[k], rtol=2e-5, atol=2e-5,
                                       err_msg=f"{party}/{k}")
    ma = json.load(open(os.path.join(A, "session.json")))
    mb = json.load(open(os.path.join(B2, "session.json")))
    assert ma["ledger_counts"] == mb["ledger_counts"]
    assert ma["dp_releases"] == mb["dp_releases"]
    assert ma["dp_spent"] == mb["dp_spent"]
    assert ra["dp_epsilon"] == rb["dp_epsilon"]
    # the optimizer's step clock continued, not reset
    opt_s, _, _ = load_tree(os.path.join(B2, "opt_server"))
    assert int(opt_s["step"]) == 4


def test_train_resume_keeps_schedule_horizon(tmp_path):
    """A decaying schedule continues the ORIGINAL total_steps on resume."""
    from repro_torch.launch.train import train
    p1, p2 = str(tmp_path / "a"), str(tmp_path / "b")
    train("phi3-mini-3.8b", steps=2, batch=2, seq=SEQ, schedule="cosine",
          log_every=1000, checkpoint_path=p1, device="cpu")
    train(steps=4, resume=p1, checkpoint_path=p2, log_every=1000,
          device="cpu")
    meta1 = json.load(open(os.path.join(p1, "session.json")))["metadata"]
    meta2 = json.load(open(os.path.join(p2, "session.json")))["metadata"]
    assert meta1["schedule_total_steps"] == 2
    assert meta2["schedule_total_steps"] == 2      # horizon preserved
    assert meta2["schedule"] == "cosine"


def test_train_resume_rejects_exhausted_steps(tmp_path):
    from repro_torch.launch.train import train
    p = str(tmp_path / "ck")
    train("phi3-mini-3.8b", steps=2, batch=4, seq=SEQ, log_every=1000,
          checkpoint_path=p, device="cpu")
    with pytest.raises(ValueError, match="total step count"):
        train(steps=2, resume=p, device="cpu")
    Federation.build(tiny_cfg(), device="cpu").save(
        str(tmp_path / "bare"), _global_params(tiny_cfg()))
    with pytest.raises(ValueError, match="not written by the train driver"):
        train(steps=4, resume=str(tmp_path / "bare"), device="cpu")


def test_restore_refuses_planes_not_ported(lm_session, tmp_path):
    """Every plane is ported: the serve scheduler's restores
    (``test_torch_serve_continuous.py`` resumes one), and so do the
    population engine's (``test_torch_population.py``) and a sharded
    session's (``test_torch_engine_sharded.py``, in gloo ranks). A
    sharded session restored in a process with no process group is
    refused: its mesh needs one rank a shard, and the engine never falls
    back to one device."""
    cfg, fed = lm_session
    params = fed.init_params(_gen())
    srv = fed.serve(params, max_batch=1)
    srv.submit(np.zeros(3, np.int32), 2)
    srv.run(max_steps=1)
    path = fed.save(str(tmp_path / "ck"), params,
                    serve_state=srv.snapshot())
    _, _, state = Federation.restore(path, device="cpu")
    assert state.serve_state.meta["config"]["max_batch"] == 1
    manifest_path = os.path.join(path, "session.json")
    manifest = json.load(open(manifest_path))
    assert manifest["serve_plane"] is True
    engine = dict(manifest["engine"], mesh_shards=2)
    json.dump(dict(manifest, engine=engine), open(manifest_path, "w"))
    with pytest.raises(RuntimeError, match="process group"):
        Federation.restore(path, device="cpu")
