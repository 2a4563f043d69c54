"""Graphs kept across calls of one key: ``Federation.decode`` keeps its
decode graph and buffers (``serving.run_decode(kept=)``), ``Federation.run``
its round graph, buffers and recorded draws (``_make_runner``'s
``run_rounds(kept=)``), each in a bounded ``graphs.Kept`` on the session,
as the JAX package's ``lru_cache``d scan factory, ``_AOT_CACHE`` and cached
runner keep their compiled programs. On the CPU a key keeps the buffers
its loop runs on.

* A second decode of one key reuses the key's buffers and gives the first
  call's tokens and logits bitwise; a call of the same shapes with other
  prompts (or another seed at temperature 0.8) gives what a fresh session
  gives them, so the kept caches are zeroed and refilled (the hybrid
  family's SSM states included); the second call's tokens are
  ``repro``'s; another params tree or another ``gen_len`` makes a new
  key, and the cache evicts its least recent key past its bound. A key
  does not keep its params tree alive: it goes when a leaf of the tree
  dies (``graphs.Kept``'s owners).
* The same for ``Federation.run``: a second run of one key is bitwise the
  first (losses, params, delays), other data or params of the same shapes
  give a fresh session's results, another horizon makes a new key, the
  bound evicts; a returned result is never overwritten by a later call.
"""
import dataclasses
import gc
import weakref

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.federation import Federation as JFederation
from repro.models import common as j_common
from repro_torch import graphs
from repro_torch.configs import VFLConfig, get_config, reduced
from repro_torch.configs.paper_mlp import PaperMLPConfig
from repro_torch.core.async_engine import EngineConfig
from repro_torch.data import make_classification, vertical_partition
from repro_torch.federation import Federation
from repro_torch.federation.session import KEPT_DECODES, KEPT_ROUNDS
from repro_torch.tree import tree_leaves, tree_map
from test_torch_support import to_numpy, to_torch, torch_threads

ARCHS = {"phi3-mini-3.8b": dict(param_dtype="float32", dtype="float32"),
         "zamba2-2.7b": dict(param_dtype="float32", dtype="float32",
                             n_layers=4)}
SEQ, PL, GL = 16, 6, 8
CFG = dict(n_features=32, n_classes=4, n_clients=4, client_embed=16,
           server_embed=32)


@pytest.fixture(autouse=True)
def _two_threads():
    with torch_threads(2):
        yield


def _session(arch):
    cfg = reduced(get_config(arch), **ARCHS[arch])
    fed = Federation.build(cfg, n_clients=2, seq_len=SEQ, device="cpu")
    params = fed.params_from_global(_global(arch, cfg))
    return fed, cfg, params


def _global(arch, cfg):
    from repro_torch.models import common, model_api
    specs = model_api.build_model(cfg, max_seq=SEQ).param_specs
    return common.materialize(specs, torch.Generator().manual_seed(0),
                              device="cpu")


def _prompts(cfg, seed, batch=2):
    g = np.random.default_rng(seed)
    return g.integers(0, cfg.vocab_size, (batch, PL)).astype(np.int32)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_second_decode_reuses_its_key_bitwise(arch):
    fed, cfg, params = _session(arch)
    a = fed.decode(params, _prompts(cfg, 1), gen_len=GL)
    assert not a.kept and len(fed._kept_decodes) == 1
    key = fed._kept_decodes.keys()[0]
    entry = fed._kept_decodes.get(key)
    b = fed.decode(params, _prompts(cfg, 1), gen_len=GL)
    assert b.kept and fed._kept_decodes.keys() == [key]
    assert fed._kept_decodes.get(key) is entry
    np.testing.assert_array_equal(a.tokens, b.tokens)
    assert torch.equal(a.logits, b.logits)
    assert a.logits is not entry["st"]["logits"]
    # other prompts of the same shapes: the kept caches are zeroed and
    # refilled, so the result is a fresh session's (and the eager loop's)
    c = fed.decode(params, _prompts(cfg, 2), gen_len=GL)
    fresh, _, _ = _session(arch)
    want = fresh.decode(params, _prompts(cfg, 2), gen_len=GL)
    eager = fresh.decode(params, _prompts(cfg, 2), gen_len=GL,
                         use_scan=False)
    assert c.kept and not want.kept
    np.testing.assert_array_equal(c.tokens, want.tokens)
    np.testing.assert_array_equal(c.tokens, eager.tokens)
    assert torch.equal(c.logits, want.logits)
    assert c.ledger.to_counts() == want.ledger.to_counts()


def test_kept_sampled_decode_takes_each_calls_noise():
    fed, cfg, params = _session("phi3-mini-3.8b")
    p = _prompts(cfg, 1)
    a = fed.decode(params, p, gen_len=GL, temperature=0.8, seed=3)
    b = fed.decode(params, p, gen_len=GL, temperature=0.8, seed=4)
    assert b.kept
    fresh, _, _ = _session("phi3-mini-3.8b")
    for res, seed in ((a, 3), (b, 4)):
        want = fresh.decode(params, p, gen_len=GL, temperature=0.8,
                            seed=seed, use_scan=False)
        np.testing.assert_array_equal(res.tokens, want.tokens)
        assert torch.equal(res.logits, want.logits)
    # greedy at the same shapes is a key of its own
    assert not fed.decode(params, p, gen_len=GL).kept


def test_decode_keys_follow_params_gen_len_and_the_bound():
    fed, cfg, params = _session("phi3-mini-3.8b")
    p = _prompts(cfg, 1)
    fed.decode(params, p, gen_len=GL)
    first = fed._kept_decodes.keys()[0]
    # the same values in other tensors: another key
    other = tree_map(torch.clone, params)
    res = fed.decode(other, p, gen_len=GL)
    assert not res.kept and len(fed._kept_decodes) == 2
    res = fed.decode(params, p, gen_len=GL - 2)
    assert not res.kept
    assert len(fed._kept_decodes) == KEPT_DECODES
    assert first not in fed._kept_decodes.keys()
    # a global tree is converted anew each call: never kept
    fed2, _, _ = _session("phi3-mini-3.8b")
    g = _global("phi3-mini-3.8b", cfg)
    fed2.decode(g, p, gen_len=GL)
    assert len(fed2._kept_decodes) == 0


def test_kept_decode_key_goes_with_its_params_tree():
    fed, cfg, params = _session("phi3-mini-3.8b")
    p = _prompts(cfg, 1)
    want = fed.decode(params, p, gen_len=GL, use_scan=False)
    other = tree_map(torch.clone, params)
    a = fed.decode(other, p, gen_len=GL)
    assert len(fed._kept_decodes) == 1
    entry = fed._kept_decodes.get(fed._kept_decodes.keys()[0])
    # nothing the key keeps is a leaf of the tree
    ids = {id(x) for x in tree_leaves(other)}
    assert not ids & {id(x) for x in tree_leaves(entry["st"])}
    del other, entry
    gc.collect()
    assert len(fed._kept_decodes) == 0
    np.testing.assert_array_equal(a.tokens, want.tokens)
    # the session's own tree: kept while it lives, results unchanged
    b = fed.decode(params, p, gen_len=GL)
    c = fed.decode(params, p, gen_len=GL)
    assert c.kept and len(fed._kept_decodes) == 1
    np.testing.assert_array_equal(b.tokens, c.tokens)
    np.testing.assert_array_equal(c.tokens, want.tokens)


def test_kept_owners_drop_their_key():
    kept = graphs.Kept(2)
    a, b, c = torch.zeros(1), torch.zeros(2), torch.zeros(3)
    kept.put("x", 1, owners=[a, b])
    kept.put("y", 2, owners=[c])
    del b
    assert kept.keys() == ["y"]
    # an evicted or replaced key stops watching its owners
    kept.put("z", 3, owners=[a])
    kept.put("w", 4)
    assert kept.keys() == ["z", "w"]
    del c
    kept.put("z", 5)
    del a
    assert kept.keys() == ["w", "z"] and kept.get("z") == 5
    # the finalizers hold the cache weakly: it goes with its owner
    d = torch.zeros(1)
    kept.put("v", 6, owners=[d])
    ref = weakref.ref(kept)
    del kept
    gc.collect()
    assert ref() is None
    del d


def test_kept_decode_gives_repros_tokens():
    """The second call of a key against ``repro``'s ``Federation.decode``
    (whose scan is an ``lru_cache``d compiled program) on the same
    weights and prompts."""
    arch = "phi3-mini-3.8b"
    jcfg = j_reduced(j_get_config(arch), **ARCHS[arch])
    cfg = reduced(get_config(arch), **ARCHS[arch])
    jfed = JFederation.build(jcfg, n_clients=2, seq_len=SEQ)
    fed = Federation.build(cfg, n_clients=2, seq_len=SEQ, device="cpu")
    key = jax.random.key(0)
    gp = j_common.materialize(jfed.model.param_specs, key)
    toks = np.asarray(jax.random.randint(jax.random.fold_in(key, 1),
                                         (2, PL), 0, cfg.vocab_size))
    params = fed.params_from_global(to_torch(gp))
    want = jfed.decode(jfed.params_from_global(gp), toks, gen_len=GL)
    fed.decode(params, toks, gen_len=GL)
    got = fed.decode(params, toks, gen_len=GL)
    assert got.kept
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    np.testing.assert_allclose(to_numpy(got.logits), to_numpy(want.logits),
                               atol=1e-4)


def _tabular(steps=12, seed=0):
    X, y = make_classification(seed, 256, CFG["n_features"],
                               CFG["n_classes"])
    fed = Federation.build(
        PaperMLPConfig(**CFG),
        VFLConfig(mu=1e-2, lr_server=0.05, lr_client=0.05, zoo_queries=2,
                  zoo_dist="normal"),
        EngineConfig(method="cascaded", steps=steps, batch_size=8,
                     block_size=2), device="cpu")
    params = fed.init_params(torch.Generator().manual_seed(seed))
    return fed, params, vertical_partition(X, CFG["n_clients"]), y


def _same_run(a, b):
    np.testing.assert_array_equal(a.losses, b.losses)
    for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)):
        assert torch.equal(x, y)
    assert (a.max_delay_seen, a.mean_delay, a.wire_bytes) == (
        b.max_delay_seen, b.mean_delay, b.wire_bytes)


def test_second_run_reuses_its_key_bitwise():
    fed, params, xp, y = _tabular()
    a = fed.run(params, xp, y)
    assert len(fed._kept_rounds) == 1
    key = fed._kept_rounds.keys()[0]
    entry = fed._kept_rounds.get(key)
    held = [x.clone() for x in tree_leaves(a.params)]
    b = fed.run(params, xp, y)
    assert fed._kept_rounds.keys() == [key]
    assert fed._kept_rounds.get(key) is entry
    _same_run(a, b)
    # the first result is the caller's, not the key's buffers
    for x, h in zip(tree_leaves(a.params), held):
        assert torch.equal(x, h)
    assert all(x is not s for x, s in zip(tree_leaves(a.params),
                                          tree_leaves(entry["st"]["params"])))


def test_kept_run_takes_new_data_and_params():
    fed, params, xp, y = _tabular()
    fed.run(params, xp, y)
    _, params2, xp2, y2 = _tabular(seed=1)
    got = fed.run(params2, xp2, y2)
    assert len(fed._kept_rounds) == 1
    fresh, _, _, _ = _tabular()
    _same_run(got, fresh.run(params2, xp2, y2))
    # the draws of the call's own source
    fresh2, _, _, _ = _tabular()
    fed.engine = dataclasses.replace(fed.engine, seed=5)
    fresh2.engine = dataclasses.replace(fresh2.engine, seed=5)
    _same_run(fed.run(params, xp, y), fresh2.run(params, xp, y))
    assert len(fed._kept_rounds) == 1


def test_run_keys_follow_the_horizon_and_the_bound():
    fed, params, xp, y = _tabular()
    first = None
    for i, steps in enumerate((12, 10, 8, 6, 4)):
        fed.engine = dataclasses.replace(fed.engine, steps=steps)
        res = fed.run(params, xp, y)
        assert len(res.losses) == steps
        if first is None:
            first = fed._kept_rounds.keys()[0]
        assert len(fed._kept_rounds) == min(i + 1, KEPT_ROUNDS)
    assert first not in fed._kept_rounds.keys()
    fresh, _, _, _ = _tabular(steps=4)
    _same_run(fed.run(params, xp, y), fresh.run(params, xp, y))
    # the horizon of the first key is rebuilt, its results unchanged
    fed.engine = dataclasses.replace(fed.engine, steps=12)
    fresh12, _, _, _ = _tabular(steps=12)
    _same_run(fed.run(params, xp, y), fresh12.run(params, xp, y))


def test_run_eager_switch_shares_the_key_on_the_cpu():
    """On the CPU nothing is captured, so the switch does not change the
    key: the eager comparison reuses the loop's buffers and its bits."""
    fed, params, xp, y = _tabular()
    a = fed.run(params, xp, y)
    b = fed.run(params, xp, y, use_graph=False)
    assert len(fed._kept_rounds) == 1
    _same_run(a, b)
