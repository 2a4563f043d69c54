"""The population server's two compiled functions
(``async_engine._population_fns``: ``server_update`` and ``losses_fn`` as
:class:`repro_torch.graphs.GraphedFn`, keyed by shape as ``jax.jit``
retraces) on the CPU, where the captured bodies loop on their static
buffers with their draws refilled through a ``RoundDraws``.

* The looped run equals the eager run (``use_graph=False``) bitwise —
  losses, params, table, delays, ledger and counters — for the tabular
  protocol clean, with faults and admission (degraded rounds: an admitted
  block of length 0 is a key of its own), with a DP channel at block 2
  (the noise through the recorded draws), with zoo-vfl (the server's own
  directions through the recorded draws), and on reduced phi3 in f32.
* One key per distinct input shape: the admitted lengths for
  ``server_update``; one for ``losses_fn``, whose client m and block row r
  are device indices.
* ``until``/resume through the looped bodies equals the unbroken eager run.
* Each ``ClientWorker`` runs its uplink and update through
  ``GraphedFn``s of its own (``wire.worker._worker_fns``; on the CPU
  their loop form): driven frame by frame over several activations, with
  a skipped round, an undelivered downlink and an act that abandons its
  round in between, its uplink frames and row are bitwise a
  ``graph=False`` worker's, one key each, the row updated in place and
  the caller's row untouched; the population run with every graph on
  stays bitwise ``Federation.run``'s on the same ``RowDraws``.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import VFLConfig
from repro_torch.configs.paper_mlp import PaperMLPConfig
from repro_torch.core import async_engine
from repro_torch.core.adapters import tabular_adapter
from repro_torch.core.async_engine import EngineConfig, PopulationConfig
from repro_torch.core.draws import RowDraws
from repro_torch.core.privacy import GaussianLossChannel
from repro_torch.data import (lm_token_batches, make_classification,
                              vertical_partition)
from repro_torch.federation import Federation
from repro_torch.tree import tree_leaves
from repro_torch import graphs
from repro_torch.wire import ClientWorker, FaultPlan, LoopbackBackend
from repro_torch.wire.backend import WireTimeout
from repro_torch.wire.codec import WireMessage
from test_torch_support import ledger_tuples, torch_threads

CFG = dict(n_features=32, n_classes=4, n_clients=4, client_embed=16,
           server_embed=32)
VFL = dict(mu=1e-2, lr_server=0.05, lr_client=0.05, zoo_queries=2,
           zoo_dist="normal")
STEPS, BATCH = 16, 8
FAULTS = dict(fault=dict(seed=3, drop=0.35, latency_ms=4.0, jitter_ms=3.0,
                         max_retries=1, party_latency_ms=((1, 20.0),)),
              population=dict(admission_ms=12.0, staleness_bound=4))
CASES = {
    "clean": dict(),
    "faults": FAULTS,
    "dp-block2": dict(noise=dict(clip=10.0, epsilon=0.5, delta=1e-5),
                      vfl=dict(lr_client=1e-6), block=2,
                      fault=dict(seed=5, drop=0.1, max_retries=0)),
    "zoo-vfl": dict(method="zoo-vfl", **FAULTS),
}


@pytest.fixture(autouse=True)
def _two_threads():
    with torch_threads(2):
        yield


class KeyRecorder:
    """Keeps the two functions ``_population_fns`` returns, so a test can
    read their keys (``GraphedFn.graphs``: one entry a key)."""

    def __init__(self, monkeypatch):
        inner = async_engine._population_fns
        self.fns = []

        def fns(*args, **kw):
            out = inner(*args, **kw)
            self.fns.append(out)
            return out
        monkeypatch.setattr(async_engine, "_population_fns", fns)


def _tabular(case):
    c = CASES[case]
    X, y = make_classification(0, 256, CFG["n_features"], CFG["n_classes"])
    fed = Federation.build(
        PaperMLPConfig(**CFG), VFLConfig(**{**VFL, **c.get("vfl", {})}),
        EngineConfig(method=c.get("method", "cascaded"), steps=STEPS,
                     batch_size=BATCH, block_size=c.get("block", 1)),
        device="cpu",
        noise=(GaussianLossChannel(**c["noise"]) if "noise" in c else None))
    params = fed.init_params(torch.Generator().manual_seed(0))
    kw = {}
    if "fault" in c:
        kw["fault_plan"] = FaultPlan(**c["fault"])
    if "population" in c:
        kw["population"] = PopulationConfig(**c["population"])
    return fed, params, vertical_partition(X, CFG["n_clients"]), y, kw


def assert_same(a, b):
    np.testing.assert_array_equal(a.losses, b.losses)
    for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)):
        assert torch.equal(x, y)
    assert torch.equal(a.state.table, b.state.table)
    np.testing.assert_array_equal(a.state.delays, b.state.delays)
    assert a.state.counters == b.state.counters
    assert a.stats == b.stats
    assert ledger_tuples(a.ledger) == ledger_tuples(b.ledger)
    assert (a.dp_releases, a.epsilon, a.serialized_bytes) == (
        b.dp_releases, b.epsilon, b.serialized_bytes)


@pytest.mark.parametrize("case", list(CASES))
def test_looped_server_bodies_equal_eager(case, monkeypatch):
    fed, params, xp, y, kw = _tabular(case)
    rec = KeyRecorder(monkeypatch)
    looped = fed.run_population(params, xp, y, **kw)
    eager = fed.run_population(params, xp, y, use_graph=False, **kw)
    assert_same(looped, eager)
    (update, losses), (e_update, _) = rec.fns
    assert isinstance(update, async_engine.graphs.GraphedFn)
    assert not isinstance(e_update, async_engine.graphs.GraphedFn)
    # no key captures on the CPU, but each has its static buffers
    assert all(g is None for g in update.graphs.values())
    assert len(losses.graphs) == 1
    if case in ("faults", "zoo-vfl"):
        # degraded rounds: the empty admitted block is a key of its own
        assert looped.stats["degraded_rounds"] > 0
        assert len(update.graphs) == 2
    else:
        assert len(update.graphs) >= 1


def test_keys_follow_admitted_lengths_and_rows(monkeypatch):
    """One key per admitted length for ``server_update``, and one for
    ``losses_fn`` over every (m, r); a repeated shape reuses its key."""
    fed, params, xp, y, kw = _tabular("faults")
    seen_update, seen_loss = set(), set()
    inner = async_engine._population_fns

    def fns(*args, **kw_):
        update, losses = inner(*args, **kw_)

        def up(*a):
            seen_update.add(a[3].shape[0])
            return update(*a)

        def down(*a):
            seen_loss.add((int(a[2]), int(a[5])))
            return losses(*a)
        fns.pair = (update, losses)
        return up, down
    monkeypatch.setattr(async_engine, "_population_fns", fns)
    res = fed.run_population(params, xp, y, **kw)
    update, losses = fns.pair
    assert len(update.graphs) == len(seen_update) == 2
    # (m, r) are device indices: one key serves every admitted row
    assert len(seen_loss) > 1 and len(losses.graphs) == 1
    assert res.stats["degraded_rounds"] > 0


def test_population_lm_looped_equals_eager():
    """Reduced phi3 in f32 (the LM adapter's server loss, its flash and
    RMSNorm plain versions on the CPU), with faults."""
    cfg = reduced(get_config("phi3-mini-3.8b"), param_dtype="float32",
                  dtype="float32")
    fed = Federation.build(cfg, VFLConfig(mu=1e-2, lr_server=0.05,
                                          lr_client=1e-4, zoo_queries=2,
                                          zoo_dist="normal"),
                           EngineConfig(method="cascaded", steps=6,
                                        batch_size=4),
                           n_clients=2, seq_len=16, device="cpu")
    params = fed.init_params(torch.Generator().manual_seed(0))
    toks = next(lm_token_batches(1, cfg.vocab_size, 32, 16))["tokens"]
    xp = vertical_partition(toks, 2)
    kw = dict(fault_plan=FaultPlan(seed=2, drop=0.3, max_retries=0))
    assert_same(fed.run_population(params, xp, toks, **kw),
                fed.run_population(params, xp, toks, use_graph=False, **kw))


def test_resume_of_looped_run_equals_unbroken_eager(tmp_path):
    fed, params, xp, y, kw = _tabular("faults")
    whole = fed.run_population(params, xp, y, use_graph=False, **kw)
    half = fed.run_population(params, xp, y, until=7, **kw)
    path = fed.save(str(tmp_path / "ck"), half.params, step=7,
                    ledger=half.ledger, async_state=half.state)
    fed2, params2, state = Federation.restore(path, device="cpu")
    cont = fed2.run_population(params2, xp, y, state=state.async_state,
                               ledger=state.ledger, **kw)
    np.testing.assert_array_equal(cont.losses, whole.losses[7:])
    for a, b in zip(tree_leaves(cont.params), tree_leaves(whole.params)):
        assert torch.equal(a, b)
    assert torch.equal(cont.state.table, whole.state.table)
    np.testing.assert_array_equal(cont.state.delays, whole.state.delays)


def test_run_population_leaves_the_callers_params():
    """The run updates its own copy of the server tree in place."""
    fed, params, xp, y, kw = _tabular("clean")
    before = [x.clone() for x in tree_leaves(params)]
    fed.run_population(params, xp, y, **kw)
    for a, b in zip(before, tree_leaves(params)):
        assert torch.equal(a, b)


# a worker's frames: ("act", t), ("loss", t, delivered), ("skip", t)
WORKER_FRAMES = [("act", 0), ("loss", 0, True), ("act", 1), ("skip", 1),
                 ("act", 2), ("loss", 2, False), ("act", 3), ("act", 4),
                 ("loss", 4, True), ("act", 5), ("loss", 5, True)]


def _drive_worker(graph, warm=False):
    """One tabular party (q = 2) driven through :data:`WORKER_FRAMES` on a
    loopback pair (with ``warm``, after :meth:`ClientWorker.warm`): its
    uplink frames in order, the worker, and the row it was given."""
    cfg = PaperMLPConfig(**CFG)
    vfl = VFLConfig(**VFL)
    ad = tabular_adapter(cfg)
    fed = Federation.build(cfg, vfl, EngineConfig(steps=8, batch_size=BATCH),
                           device="cpu")
    params = fed.init_params(torch.Generator().manual_seed(0))
    X, _ = make_classification(0, 64, CFG["n_features"], CFG["n_classes"])
    xp = torch.from_numpy(vertical_partition(X, CFG["n_clients"]))
    draws, m, q = RowDraws(0, "cpu"), 2, vfl.zoo_queries
    row = {k: v[m] for k, v in params["clients"].items()}
    given = [x.clone() for x in tree_leaves(row)]
    eng, wk = LoopbackBackend.pair()
    worker = ClientWorker(ad, vfl, row, xp[m], m, wk,
                          directions=draws.directions, graph=graph)
    if warm:
        worker.warm(BATCH, draws.row_key(0, 0))
    own = tree_leaves(worker.client_params)
    rng = np.random.default_rng(7)
    frames = []
    for ev in WORKER_FRAMES:
        t = ev[1]
        if ev[0] == "act":
            idx = rng.integers(0, 64, BATCH).astype(np.int32)
            eng.send(WireMessage("act", "server", t, {"party": m},
                                 {"idx": idx, "key": draws.row_key(t, 0)}))
        elif ev[0] == "skip":
            eng.send(WireMessage("skip", "server", t, {"reason": "drop"}))
        else:
            for lane in range(1 + q):
                h = torch.tensor(1.0 + 0.1 * lane + 0.01 * t)
                eng.send(WireMessage("loss", "server", t,
                                     {"lane": lane, "delivered": ev[2]},
                                     {"h": h}))
        worker.pump()
        while True:
            try:
                msg, _ = eng.recv(timeout=0.0)
            except WireTimeout:
                break
            frames.append((msg.round, msg.meta["lane"], msg.payload["c"]))
    assert all(a is b for a, b in zip(own, tree_leaves(worker.client_params)))
    for a, b in zip(given, tree_leaves(row)):
        assert torch.equal(a, b)
    return frames, worker, given


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warmed"])
def test_worker_graphed_loop_equals_its_eager_functions(warm):
    got, worker, given = _drive_worker(graph=True, warm=warm)
    want, eager, _ = _drive_worker(graph=False)
    assert len(got) == len(want) == 6 * (1 + VFL["zoo_queries"])
    for (t, lane, c), (t2, lane2, c2) in zip(got, want):
        assert (t, lane) == (t2, lane2) and torch.equal(c, c2)
    for a, b in zip(tree_leaves(worker.client_params),
                    tree_leaves(eager.client_params)):
        assert torch.equal(a, b)
    # three updates ran: the row moved
    assert not all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(worker.client_params), given))
    assert isinstance(worker._uplink, graphs.GraphedFn)
    assert isinstance(worker._update, graphs.GraphedFn)
    assert len(worker._uplink.graphs) == len(worker._update.graphs) == 1
    assert set(worker.stats()) == {"uplink", "update"}
    assert eager.stats() == {}


def test_population_with_worker_graphs_equals_federation_run(monkeypatch):
    fed, params, xp, y, _ = _tabular("clean")
    workers = []
    warm = ClientWorker.warm

    def record(self, batch, key):
        workers.append(self)
        warm(self, batch, key)
    monkeypatch.setattr(ClientWorker, "warm", record)
    res = fed.run_population(params, xp, y)
    # each worker warmed before the rounds: the stand-in round's keys are
    # the ones its rounds used
    assert len(workers) == CFG["n_clients"]
    for w in workers:
        assert len(w._uplink.graphs) == len(w._update.graphs) == 1
    whole = fed.run(params, xp, y, draws=RowDraws(0, "cpu"))
    np.testing.assert_array_equal(res.losses, whole.losses)
    for a, b in zip(tree_leaves(res.params), tree_leaves(whole.params)):
        assert torch.equal(a, b)
    assert (res.max_delay_seen, res.mean_delay) == (whole.max_delay_seen,
                                                    whole.mean_delay)
