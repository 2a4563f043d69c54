"""The port's population engine (``async_engine.run_population`` through
``Federation.run_population``) on the CPU.

* Against ``repro``'s ``run_population`` on ``repro``'s draws (the act
  frame carries ``repro``'s threefry key data; the port's workers replay
  the directions it stands for), on the wire tests' tabular protocol and
  on reduced phi3 in f32, with and without faults and a DP channel:
  losses and params at the reference's tolerances (1e-5 with normal
  directions; the trajectory atol 1e-3 of
  ``tests/test_zoo_vectorized.py`` with sphere directions, whose φ/μ
  magnifies f32 rounding), and the fault counters, virtual clock,
  delays, DP releases and the ledger's measured bytes exact.
* Against the port's own ``Federation.run`` on the same ``RowDraws``:
  losses, params, embedding table and delays bitwise.
* Durability: ``until``, ``fed.save(async_state=)``,
  ``Federation.restore`` and a resume equal to the unbroken run bitwise;
  the async plane and the sessions that carry it load in the other
  package in both directions.
* Over a socket: the port's engine with a port worker in another
  process equals the loopback run exactly; ``repro``'s engine trains
  with a port worker in another process as with its own; a worker
  ``kill -9``'d mid-round is declared dead and the run finishes.
* Graceful degradation and the engine's refusals.
"""
import collections
import contextlib
import json
import os
import signal
import subprocess
import sys
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.configs.base import VFLConfig as JVFLConfig
from repro.configs.paper_mlp import PaperMLPConfig as JPaperMLPConfig
from repro.core import async_engine as j_engine
from repro.core.privacy import GaussianLossChannel as JChannel
from repro.core.privacy import Ledger as JLedger
from repro.data import lm_token_batches, make_classification, vertical_partition
from repro.federation import Federation as JFederation
from repro.models import common as j_common
from repro.models import tabular as j_tabular
from repro.wire import FaultPlan as JFaultPlan
from repro.wire import accept as j_accept
from repro.wire import listen as j_listen
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import VFLConfig
from repro_torch.configs.paper_mlp import PaperMLPConfig
from repro_torch.core import async_engine
from repro_torch.core.async_engine import (AsyncPlaneState, EngineConfig,
                                           PopulationConfig)
from repro_torch.core.draws import RowDraws, TorchDraws
from repro_torch.core.privacy import GaussianLossChannel
from repro_torch.federation import Federation
from repro_torch.tree import tree_leaves
from repro_torch.wire import FaultPlan, accept, listen
from test_torch_support import (JaxPopulationDraws, ledger_tuples, to_numpy,
                                to_torch, torch_threads, tree_allclose)

CFG = dict(n_features=32, n_classes=4, n_clients=4, client_embed=16,
           server_embed=32)
VFL = dict(mu=1e-2, lr_server=0.05, lr_client=0.05, zoo_queries=2,
           zoo_dist="normal")
STEPS, BATCH = 16, 8
F32 = dict(param_dtype="float32", dtype="float32")
CHILD = os.path.join(os.path.dirname(__file__), "_torch_wire_socket_child.py")


@pytest.fixture(autouse=True)
def _two_threads():
    with torch_threads(2):
        yield


@pytest.fixture
def fixed_width_crc(monkeypatch):
    """Both codecs write the payload's CRC32 into the frame header as a
    decimal number, so a frame's size follows its payload's last bits:
    the two frameworks' f32 rounding can move a CRC across a power of 10.
    For the byte-exact comparison every CRC here is 10 digits wide (its
    top four bits set; encode and decode in this process agree)."""
    crc = zlib.crc32
    monkeypatch.setattr(zlib, "crc32",
                        lambda data, value=0: crc(data, value) | 0xF0000000)


@contextlib.contextmanager
def _hard_timeout(seconds):
    """A per-test deadline for the socket tests: a deadlock fails the
    test instead of wedging its worker."""
    def _fire(signum, frame):  # pragma: no cover - only on deadlock
        raise TimeoutError(f"socket test exceeded {seconds}s")
    old = signal.signal(signal.SIGALRM, _fire)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def _tabular():
    X, y = make_classification(0, 256, CFG["n_features"], CFG["n_classes"])
    Xp = vertical_partition(X, CFG["n_clients"])
    jp = j_common.materialize(j_tabular.param_specs(JPaperMLPConfig(**CFG)),
                              jax.random.key(0))
    return Xp, y, jp


def _feds(vkw, ekw, noise=None):
    """(repro session, port session) of the tabular protocol."""
    jfed = JFederation.build(JPaperMLPConfig(**CFG), JVFLConfig(**vkw),
                             j_engine.EngineConfig(**ekw),
                             noise=None if noise is None else JChannel(**noise))
    fed = Federation.build(PaperMLPConfig(**CFG), VFLConfig(**vkw),
                           EngineConfig(**ekw), device="cpu",
                           noise=(None if noise is None
                                  else GaussianLossChannel(**noise)))
    return jfed, fed


def _assert_matches_reference(res, jres, jp, *, atol, exact_bytes=True):
    np.testing.assert_allclose(res.losses, jres.losses, rtol=1e-5, atol=atol)
    tree_allclose(res.params, jres.params, atol=atol, rtol=1e-5)
    assert res.stats == jres.stats
    assert res.max_delay_seen == jres.max_delay_seen
    assert res.mean_delay == jres.mean_delay
    s, js = res.state, jres.state
    np.testing.assert_array_equal(s.delays, js.delays)
    np.testing.assert_array_equal(s.last_active, js.last_active)
    assert s.clock_ms == js.clock_ms and s.step == js.step
    np.testing.assert_allclose(to_numpy(s.table), to_numpy(js.table),
                               rtol=1e-5, atol=atol)
    assert (res.dp_releases, res.epsilon, res.delta,
            res.transmits_gradients) == (jres.dp_releases, jres.epsilon,
                                         jres.delta,
                                         jres.transmits_gradients)
    if exact_bytes:
        assert ledger_tuples(res.ledger) == ledger_tuples(jres.ledger)
        assert (res.serialized_bytes, res.overhead_bytes, res.wire_bytes,
                res.control_bytes) == (
            jres.serialized_bytes, jres.overhead_bytes, jres.wire_bytes,
            jres.control_bytes)
        assert s.counters == js.counters


CASES = {
    "clean": dict(),
    "faults": dict(fault=dict(seed=3, drop=0.35, latency_ms=4.0,
                              jitter_ms=3.0, max_retries=1,
                              party_latency_ms=((1, 20.0),)),
                   population=dict(admission_ms=12.0, staleness_bound=4)),
    # the noised losses' differences over μ move a client by lr_client ·
    # σ/μ ≈ 1e4 · lr_client a coordinate: a small client lr keeps the
    # trajectory finite
    "dp-block2": dict(noise=dict(clip=10.0, epsilon=0.5, delta=1e-5),
                      vfl=dict(lr_client=1e-6), block=2,
                      fault=dict(seed=5, drop=0.1, max_retries=0)),
    "sphere": dict(vfl=dict(zoo_dist="sphere"), atol=1e-3,
                   fault=dict(seed=1, drop=0.2, max_retries=0)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_population_matches_reference(case, fixed_width_crc):
    c = CASES[case]
    Xp, y, jp = _tabular()
    vkw = dict(VFL, **c.get("vfl", {}))
    ekw = dict(method="cascaded", steps=STEPS, batch_size=BATCH,
               block_size=c.get("block", 1))
    jfed, fed = _feds(vkw, ekw, c.get("noise"))
    fault = c.get("fault")
    pop = c.get("population")
    jres = jfed.run_population(
        jp, jnp.asarray(Xp), jnp.asarray(y), ledger=JLedger(),
        fault_plan=None if fault is None else JFaultPlan(**fault),
        population=(None if pop is None
                    else j_engine.PopulationConfig(**pop)))
    res = fed.run_population(
        to_torch(jp), Xp, y, draws=JaxPopulationDraws(0),
        fault_plan=None if fault is None else FaultPlan(**fault),
        population=None if pop is None else PopulationConfig(**pop))
    _assert_matches_reference(res, jres, jp, atol=c.get("atol", 1e-5))
    if fault:
        assert res.stats["uplink_drops"] + res.stats["downlink_drops"] > 0
        assert fault.get("max_retries") == 0 or res.stats[
            "retransmit_frames"] > 0
    if pop:
        assert res.stats["stragglers"] > 0 and res.stats["forced"] > 0


def test_lm_population_matches_reference(fixed_width_crc):
    """Reduced phi3 in f32, 4 client parties over token spans, the
    active-row mask on: the (1+q) lanes' server losses one forward a
    lane, against ``repro``'s vmapped lanes."""
    jcfg = j_reduced(j_get_config("phi3-mini-3.8b"), **F32)
    cfg = reduced(get_config("phi3-mini-3.8b"), **F32)
    vkw = dict(mu=1e-2, lr_server=0.05, lr_client=1e-3, zoo_queries=1,
               zoo_dist="normal", active_rows_only=True)
    ekw = dict(method="cascaded", steps=4, batch_size=4)
    jfed = JFederation.build(jcfg, JVFLConfig(**vkw),
                             j_engine.EngineConfig(**ekw), n_clients=4,
                             seq_len=16)
    fed = Federation.build(cfg, VFLConfig(**vkw), EngineConfig(**ekw),
                           n_clients=4, seq_len=16, device="cpu")
    jp = jfed.init_params(jax.random.key(0))
    toks = next(lm_token_batches(1, cfg.vocab_size, 16, 16))["tokens"]
    xp = vertical_partition(toks, 4)
    jres = jfed.run_population(jp, jnp.asarray(xp), jnp.asarray(toks),
                               ledger=JLedger())
    res = fed.run_population(to_torch(jp), xp, toks,
                             draws=JaxPopulationDraws(0))
    _assert_matches_reference(res, jres, jp, atol=1e-5)


# ------------------------------------------- population == the port's run --

def _run_rounds(fed, params, x_parts, y, draws):
    """The port's in-process round loop on ``draws``: (params, table,
    delays, losses) — ``Federation.run`` without its result wrapping."""
    p, xp, yy = fed._engine_inputs(params, x_parts, y)
    block = fed.engine.block_size
    M, n = xp.shape[:2]
    runner = async_engine._make_runner(fed.adapter, fed.transport, fed.vfl,
                                       False, block, False)
    (p, table, delays), (losses, _) = runner(
        p, fed.adapter.client_forward(p["clients"], xp),
        torch.zeros((M, n), dtype=torch.int32),
        draws.schedule(fed.engine.steps, M, None, block),
        draws.sample_indices(fed.engine.steps, fed.engine.batch_size, n),
        draws, xp, yy)
    return p, table, delays, losses


def _lm_session(rows=True, method="cascaded", steps=6, block=1):
    cfg = reduced(get_config("phi3-mini-3.8b"), **F32)
    fed = Federation.build(
        cfg, VFLConfig(mu=1e-3, lr_server=0.05, lr_client=1e-3,
                       zoo_queries=2, active_rows_only=rows),
        EngineConfig(method=method, steps=steps, batch_size=4,
                     block_size=block),
        n_clients=4, seq_len=16, device="cpu")
    params = fed.init_params(torch.Generator().manual_seed(0))
    toks = next(lm_token_batches(2, cfg.vocab_size, 16, 16))["tokens"]
    return fed, params, vertical_partition(toks, 4), toks


@pytest.mark.parametrize("model", ["tabular-block1", "tabular-block3-sphere",
                                   "tabular-zoo-vfl-dp", "lm-rows",
                                   "lm-block2"])
def test_population_equals_run_bitwise(model):
    """FaultPlan.none() over loopback workers, on the same RowDraws: the
    population run's losses, params, table and delays equal the port's
    in-process run bit for bit (and ``Federation.run``'s result)."""
    if model.startswith("lm"):
        fed, params, xp, y = _lm_session(block=2 if "block2" in model
                                         else 1)
    else:
        Xp, y, jp = _tabular()
        vkw = dict(VFL)
        ekw = dict(method="cascaded", steps=STEPS, batch_size=BATCH)
        noise = None
        if "block3" in model:
            vkw.update(zoo_dist="sphere", mu=1e-3)
            ekw.update(block_size=3)
        if "zoo-vfl" in model:
            vkw.update(lr_server=1e-3)
            ekw.update(method="zoo-vfl")
            noise = dict(clip=10.0, epsilon=0.5, delta=1e-5)
        _, fed = _feds(vkw, ekw, noise)
        params, xp = to_torch(jp), Xp
    p, table, delays, losses = _run_rounds(fed, params, xp, y,
                                           RowDraws(0, "cpu"))
    res = fed.run_population(params, xp, y)
    whole = fed.run(params, xp, y, draws=RowDraws(0, "cpu"))
    assert np.array_equal(res.losses, losses.numpy())
    assert np.array_equal(res.losses, whole.losses)
    for a, b, c in zip(tree_leaves(res.params), tree_leaves(p),
                       tree_leaves(whole.params)):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert torch.equal(res.state.table, table)
    np.testing.assert_array_equal(res.state.delays, delays.numpy())
    assert (res.max_delay_seen, res.mean_delay) == (whole.max_delay_seen,
                                                    whole.mean_delay)
    assert res.stats["participation"] == 1.0
    assert res.stats["degraded_rounds"] == 0
    assert res.epsilon == whole.epsilon and res.delta == whole.delta
    # the measured wire: every data frame metered at its real size, the
    # payload formula a lower bound
    assert all(m.wired > m.nbytes for m in res.ledger.messages)
    assert res.serialized_bytes == res.ledger.serialized_bytes
    assert res.serialized_bytes >= res.stats["formula_bytes"]
    assert not res.transmits_gradients and res.control_bytes > 0


def test_serialized_bytes_are_the_frames_sent(monkeypatch):
    """On a clean wire the ledger's serialized bytes are exactly the
    emb/loss frames the loopback endpoints queued, bf16 LM embeddings
    included; the f32 payload formula is logged beside them."""
    from repro_torch.wire import backend, codec
    sent = []
    inner = backend.LoopbackBackend.send

    def send(endpoint, msg):
        n = inner(endpoint, msg)
        if msg.tag in codec.DATA_TAGS:
            sent.append((msg.tag, n))
        return n
    monkeypatch.setattr(backend.LoopbackBackend, "send", send)
    cfg = reduced(get_config("phi3-mini-3.8b"))            # bf16
    fed = Federation.build(cfg, VFLConfig(zoo_queries=2),
                           EngineConfig(steps=3, batch_size=4),
                           n_clients=4, seq_len=16, device="cpu")
    params = fed.init_params(torch.Generator().manual_seed(0))
    toks = next(lm_token_batches(2, cfg.vocab_size, 16, 16))["tokens"]
    res = fed.run_population(params, vertical_partition(toks, 4), toks)
    assert len(sent) == 3 * 2 * 3                # rounds x (emb, loss) x lanes
    assert res.serialized_bytes == sum(n for _, n in sent)
    assert {m.dtype for m in res.ledger.messages if m.kind == "embedding"} \
        == {"bfloat16"}
    assert res.wire_bytes == res.ledger.total_bytes
    assert res.stats["formula_bytes"] > res.wire_bytes   # f32 formula


# ------------------------------------------------------------ durability --

def test_resume_through_a_session_checkpoint_is_bitwise(tmp_path):
    """Stop at round 7 under faults, ``fed.save(async_state=)``,
    ``Federation.restore`` and continue: the combined run equals the
    unbroken one bitwise, with the ledger multiset and byte totals and
    the fault state continued exactly."""
    fed, params, xp, y = _lm_session(rows=False, steps=12)
    plan = FaultPlan(seed=4, drop=0.3, latency_ms=2.0, jitter_ms=1.0,
                     max_retries=1)
    full = fed.run_population(params, xp, y, fault_plan=plan)
    half = fed.run_population(params, xp, y, fault_plan=plan, until=7)
    assert half.state.step == 7
    path = fed.save(str(tmp_path / "ck"), half.params, step=7,
                    ledger=half.ledger, dp_releases=half.dp_releases,
                    async_state=half.state)
    manifest = json.load(open(os.path.join(path, "session.json")))
    assert manifest["async_plane"] is True
    fed2, params2, state = Federation.restore(path, device="cpu")
    assert state.async_state.step == 7
    cont = fed2.run_population(params2, xp, y, fault_plan=plan,
                               state=state.async_state, ledger=state.ledger,
                               dp_releases=state.dp_releases)
    assert np.array_equal(full.losses[7:], cont.losses)
    for a, b in zip(tree_leaves(full.params), tree_leaves(cont.params)):
        assert torch.equal(a, b)
    for f in ("table",):
        assert torch.equal(getattr(full.state, f), getattr(cont.state, f))
    np.testing.assert_array_equal(full.state.delays, cont.state.delays)
    np.testing.assert_array_equal(full.state.last_active,
                                  cont.state.last_active)
    assert full.state.clock_ms == cont.state.clock_ms
    assert full.max_delay_seen == cont.max_delay_seen
    assert (collections.Counter(full.ledger.messages)
            == collections.Counter(cont.ledger.messages))
    assert full.serialized_bytes == cont.serialized_bytes
    # the counters continue: the resumed run's are the unbroken run's
    same = ("uplink_drops", "stragglers", "downlink_drops", "forced",
            "degraded_rounds", "retransmit_frames", "dead_parties",
            "virtual_ms")
    assert {k: cont.stats[k] for k in same} == {k: full.stats[k]
                                                for k in same}
    assert cont.state.counters == dict(
        full.state.counters, control_bytes=cont.control_bytes)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_async_plane_loads_in_the_other_package(tmp_path, dtype):
    """An AsyncPlaneState saved by either package loads in the other with
    every field equal, a bf16 table included."""
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.standard_normal((3, 5, 4)).astype(
        np.float32)).to(getattr(torch, dtype))
    state = AsyncPlaneState(
        step=7, table=table,
        delays=rng.integers(0, 9, (3, 5)).astype(np.int32),
        last_active=np.asarray([1, 6, 4], np.int32), clock_ms=12.5,
        max_delay_seen=8, counters={"rounds": 7, "control_bytes": 999},
        seed=3)
    state.save(str(tmp_path / "port"))
    jstate = j_engine.AsyncPlaneState.load(str(tmp_path / "port"))
    assert str(jstate.table.dtype) == dtype
    np.testing.assert_array_equal(to_numpy(jstate.table), to_numpy(table))
    jstate.save(str(tmp_path / "jax"))
    back = AsyncPlaneState.load(str(tmp_path / "jax"))
    for got in (jstate, back):
        np.testing.assert_array_equal(np.asarray(got.delays), state.delays)
        np.testing.assert_array_equal(np.asarray(got.last_active),
                                      state.last_active)
        assert (got.step, got.clock_ms, got.max_delay_seen, got.counters,
                got.seed) == (7, 12.5, 8, state.counters, 3)
    assert back.table.dtype == table.dtype and torch.equal(back.table, table)


@pytest.mark.parametrize("writer", ["repro", "port"])
def test_population_session_restores_in_the_other_package(tmp_path, writer):
    """A population session saved mid-run by one package restores in the
    other: the async plane, step and ledger carry over, and the restored
    session finishes the horizon with the same counters and clock the
    writer's own unbroken run reaches (the table and delays at the
    reference's tolerances; the trajectories themselves are held by
    ``test_population_matches_reference``)."""
    Xp, y, jp = _tabular()
    ekw = dict(method="cascaded", steps=STEPS, batch_size=BATCH)
    jfed, fed = _feds(VFL, ekw)
    fault = dict(seed=2, drop=0.2, max_retries=0)
    if writer == "repro":
        half = jfed.run_population(jp, jnp.asarray(Xp), jnp.asarray(y),
                                   fault_plan=JFaultPlan(**fault), until=6)
        path = jfed.save(str(tmp_path / "ck"), half.params, step=6,
                         ledger=half.ledger, async_state=half.state)
        fed2, params2, state = Federation.restore(path, device="cpu")
        cont = fed2.run_population(params2, Xp, y, fault_plan=FaultPlan(
            **fault), state=state.async_state, ledger=state.ledger,
            draws=JaxPopulationDraws(0))
    else:
        half = fed.run_population(to_torch(jp), Xp, y,
                                  fault_plan=FaultPlan(**fault), until=6,
                                  draws=JaxPopulationDraws(0))
        path = fed.save(str(tmp_path / "ck"), half.params, step=6,
                        ledger=half.ledger, async_state=half.state)
        jfed2, jparams2, state = JFederation.restore(path)
        cont = jfed2.run_population(jparams2, jnp.asarray(Xp),
                                    jnp.asarray(y),
                                    fault_plan=JFaultPlan(**fault),
                                    state=state.async_state,
                                    ledger=state.ledger)
    assert state.async_state.step == 6 and state.step == 6
    full = jfed.run_population(jp, jnp.asarray(Xp), jnp.asarray(y),
                               fault_plan=JFaultPlan(**fault))
    np.testing.assert_allclose(cont.losses, full.losses[6:], rtol=0,
                               atol=1e-5)
    for k in ("uplink_drops", "degraded_rounds", "retransmit_frames",
              "rounds", "activations", "admitted"):
        assert cont.state.counters[k] == full.state.counters[k], k
    assert cont.state.clock_ms == full.state.clock_ms
    np.testing.assert_array_equal(np.asarray(cont.state.delays),
                                  np.asarray(full.state.delays))
    assert len(cont.ledger.messages) == len(full.ledger.messages)


# ---------------------------------------------------------- over sockets --

def _child(port, party, *extra):
    env = dict(os.environ)
    here = os.path.dirname(__file__)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(here, "..", "src"), here, env.get("PYTHONPATH", "")])
    return subprocess.Popen([sys.executable, CHILD, str(port), str(party),
                             *extra], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _port_params(fed):
    """The port's own init (what the socket child rebuilds)."""
    return fed.init_params(torch.Generator().manual_seed(0))


def test_port_socket_worker_matches_loopback():
    """Party 2 in another process behind a TCP socket: the port engine's
    trace and per-message ledger bytes equal the all-loopback run's."""
    Xp, y, _ = _tabular()
    _, fed = _feds(VFL, dict(method="cascaded", steps=STEPS,
                             batch_size=BATCH))
    params = _port_params(fed)
    loop = fed.run_population(params, Xp, y)
    with _hard_timeout(240):
        listener, port = listen()
        proc = _child(port, 2)
        try:
            chan = accept(listener, timeout=120.0)
            sock = fed.run_population(params, Xp, y, channels={2: chan})
            out, err = proc.communicate(timeout=120)
        finally:
            listener.close()
            if proc.poll() is None:  # pragma: no cover - failure path
                proc.kill()
    assert proc.returncode == 0 and "CHILD_OK" in out, err
    assert np.array_equal(loop.losses, sock.losses)
    for a, b in zip(tree_leaves(loop.params), tree_leaves(sock.params)):
        assert torch.equal(a, b)
    assert loop.ledger.messages == sock.ledger.messages
    assert (loop.serialized_bytes, loop.control_bytes) == (
        sock.serialized_bytes, sock.control_bytes)


def test_repro_engine_trains_with_a_port_worker_over_a_socket():
    """``repro``'s run_population with party 2 served by the PORT's
    ClientWorker in another process (it reads ``repro``'s threefry key
    data from the act frames and draws the same directions): the run
    equals ``repro``'s all-loopback run at the reference tolerance, with
    the same counters and the same ledger messages (their measured sizes
    differ at most by the width of the header's decimal CRC32, which
    follows the two frameworks' last bits)."""
    Xp, y, jp = _tabular()
    jfed, _ = _feds(VFL, dict(method="cascaded", steps=STEPS,
                              batch_size=BATCH))
    jx, jy = jnp.asarray(Xp), jnp.asarray(y)
    loop = jfed.run_population(jp, jx, jy, ledger=JLedger())
    with _hard_timeout(240):
        listener, port = j_listen()
        proc = _child(port, 2, "--engine", "repro")
        try:
            chan = j_accept(listener, timeout=120.0)
            sock = jfed.run_population(jp, jx, jy, channels={2: chan},
                                       ledger=JLedger())
            out, err = proc.communicate(timeout=120)
        finally:
            listener.close()
            if proc.poll() is None:  # pragma: no cover - failure path
                proc.kill()
    assert proc.returncode == 0 and "CHILD_OK" in out, err
    np.testing.assert_allclose(sock.losses, loop.losses, rtol=0, atol=1e-5)
    tree_allclose(sock.params, loop.params, atol=1e-5)
    assert sock.stats == loop.stats
    got, want = ledger_tuples(sock.ledger), ledger_tuples(loop.ledger)
    assert [g[:4] for g in got] == [w[:4] for w in want]
    assert all(abs(g[4] - w[4]) <= 1 for g, w in zip(got, want))


def test_population_survives_worker_kill9():
    """Party 2's process is ``kill -9``'d as it sends its 2nd frame
    (inside its first round's fan-out): the engine declares it dead,
    finishes every round with finite losses, and collects its initial
    row."""
    Xp, y, _ = _tabular()
    _, fed = _feds(VFL, dict(method="cascaded", steps=STEPS,
                             batch_size=BATCH))
    params = _port_params(fed)
    with _hard_timeout(240):
        listener, port = listen()
        proc = _child(port, 2, "--die-after-frames", "2")
        try:
            chan = accept(listener, timeout=120.0)
            pop = fed.run_population(params, Xp, y, channels={2: chan},
                                     wire_timeout_s=30.0)
            out, err = proc.communicate(timeout=120)
        finally:
            listener.close()
            if proc.poll() is None:  # pragma: no cover - failure path
                proc.kill()
    assert proc.returncode == 9 and "CHILD_OK" not in out
    assert len(pop.losses) == STEPS and np.isfinite(pop.losses).all()
    assert pop.stats["dead_parties"] == 1
    assert pop.stats["uplink_drops"] > 0
    assert pop.stats["participation"] < 1.0
    for k, v in params["clients"].items():
        assert torch.equal(pop.params["clients"][k][2], v[2])


# ------------------------------------------------ degradation / refusals --

def test_dropout_degrades_gracefully():
    """20% dropout without retries loses rounds, not the run."""
    Xp, y, jp = _tabular()
    _, fed = _feds(VFL, dict(method="cascaded", steps=STEPS,
                             batch_size=BATCH))
    params = to_torch(jp)
    pop = fed.run_population(params, Xp, y,
                             fault_plan=FaultPlan(seed=1, drop=0.2,
                                                  max_retries=0))
    clean = fed.run_population(params, Xp, y)
    assert len(pop.losses) == STEPS and np.isfinite(pop.losses).all()
    assert pop.stats["uplink_drops"] + pop.stats["downlink_drops"] > 0
    assert pop.stats["participation"] < 1.0
    assert pop.max_delay_seen >= clean.max_delay_seen


def test_population_refusals():
    Xp, y, jp = _tabular()
    params = to_torch(jp)
    for method in ("split", "vafl"):
        _, fed = _feds(VFL, dict(method=method, steps=2))
        with pytest.raises(ValueError, match="synchronous"):
            fed.run_population(params, Xp, y)
    _, fed = _feds(VFL, dict(method="cascaded", steps=2, use_lanes=True))
    with pytest.raises(ValueError, match="use_lanes"):
        fed.run_population(params, Xp, y)
    _, fed = _feds(dict(VFL, zoo_unrolled_oracle=True),
                   dict(method="cascaded", steps=2))
    with pytest.raises(ValueError, match="unrolled"):
        fed.run_population(params, Xp, y)
    _, fed = _feds(VFL, dict(method="cascaded", steps=2))
    with pytest.raises(ValueError, match="population draw source"):
        fed.run_population(params, Xp, y, draws=TorchDraws(0, "cpu"))
    stale = AsyncPlaneState(step=1, table=torch.zeros((4, 256, 16)),
                            delays=np.zeros((4, 256), np.int32),
                            last_active=np.zeros((4,), np.int32), seed=99)
    with pytest.raises(ValueError, match="seed"):
        fed.run_population(params, Xp, y, state=stale)
    with pytest.raises(RuntimeError, match="CUDA"):
        if torch.cuda.is_available():
            raise RuntimeError("CUDA present: the default device is the card")
        Federation.build(PaperMLPConfig(**CFG)).run_population(params, Xp, y)
