"""The port's wire plane (``repro_torch.wire``) and the model hooks its
worker drives, against the JAX package's, on the CPU.

* The codec: frames byte-identical to ``repro``'s for the same message
  (f32, bf16 through its uint view, int32 indices, uint32 key data, 0-d
  scalars) and each package decoding the other's bytes; v1 frames still
  read; CRC, truncation and foreign frames refused as ``repro`` refuses
  them; the tree flattening keys equal.
* Faults: ``FaultPlan.delivery``/``require`` equal to ``repro``'s over a
  grid of seeds, rounds, parties, directions and per-party overrides;
  ``ChaosBackend`` damaging the same bytes ``repro``'s damages.
* Backends: loopback framing, socket self-heal, the heartbeat, a worker
  restarted from a party-scoped checkpoint.
* The LM adapter's training hooks (``client_forward``, ``client_lanes``,
  ``server_loss``, ``row_mask``) and ``mlp_adapter`` against ``repro``'s
  on the same weights: reduced phi3 in f32 and reduced zamba2 with 4
  layers (f32 forward tolerance 1e-5).
* ``ClientWorker``'s uplink and ZOO update against ``repro``'s on the
  same injected directions.
"""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.configs.base import VFLConfig as JVFLConfig
from repro.configs.paper_mlp import PaperMLPConfig as JPaperMLPConfig
from repro.core.adapters import from_model_config as j_from_model_config
from repro.core.adapters import mlp_adapter as j_mlp_adapter
from repro.core.adapters import tabular_adapter as j_tabular_adapter
from repro.data import make_classification, vertical_partition
from repro.wire import codec as jcodec
from repro.wire import faults as jfaults
from repro.wire import worker as jworker
from repro.wire.backend import LoopbackBackend as JLoopbackBackend
from repro_torch.checkpoint.io import save_checkpoint
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import VFLConfig
from repro_torch.configs.paper_mlp import PaperMLPConfig
from repro_torch.core.adapters import (from_model_config, mlp_adapter,
                                       tabular_adapter)
from repro_torch.wire import (ChaosBackend, ChaosPlan, ClientWorker,
                              DeliveryFailed, FaultPlan, FrameCorruption,
                              LoopbackBackend, SocketBackend, WireMessage,
                              accept, codec, heartbeat, listen)
from repro_torch.wire.worker import _client_fns
from test_torch_support import (raw_normals, to_jax, to_numpy, to_torch,
                                torch_threads, tree_allclose)

F32 = dict(param_dtype="float32", dtype="float32")
FWD_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _two_threads():
    with torch_threads(2):
        yield


# ================================================================ codec ====

def _payloads(case, seed=0):
    """(repro payload, port payload) of one dtype case, same values."""
    rng = np.random.default_rng(seed)
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    if case == "f32":
        return {"c": f32}, {"c": torch.from_numpy(f32)}
    if case == "bf16":
        return ({"c": jnp.asarray(f32, jnp.bfloat16)},
                {"c": torch.from_numpy(f32).to(torch.bfloat16)})
    if case == "int32":
        idx = rng.integers(0, 1000, 8).astype(np.int32)
        return {"idx": idx}, {"idx": torch.from_numpy(idx)}
    if case == "scalar":
        h = np.float32(rng.standard_normal())
        return {"h": np.asarray(h)}, {"h": torch.tensor(float(h))}
    if case == "keydata":
        kd = np.asarray(jax.random.key_data(jax.random.key(seed)))
        return {"key": kd}, {"key": kd}
    assert case == "mixed"
    j, t = {}, {}
    for i, c in enumerate(("f32", "bf16", "int32", "scalar", "keydata")):
        jp, tp = _payloads(c, seed + i)
        j.update({f"{k}{i}": v for k, v in jp.items()})
        t.update({f"{k}{i}": v for k, v in tp.items()})
    return j, t


@pytest.mark.parametrize("case", ["f32", "bf16", "int32", "scalar",
                                  "keydata", "mixed"])
def test_frames_byte_identical_both_ways(case):
    """The same message encodes to the same bytes in both packages, and
    each decodes the other's frame to the same values, shapes (a 0-d loss
    stays 0-d) and dtypes."""
    jpay, tpay = _payloads(case, seed=len(case))
    meta = {"party": 2, "lane": 1, "delivered": True}
    jbuf = jcodec.encode(jcodec.WireMessage("emb", "client", 7, meta, jpay))
    tbuf = codec.encode(WireMessage("emb", "client", 7, meta, tpay))
    assert tbuf == jbuf
    got = codec.decode(jbuf)
    jgot = jcodec.decode(tbuf)
    assert (got.tag, got.sender, got.round, got.meta) == (
        "emb", "client", 7, meta)
    for k, want in jpay.items():
        want = np.asarray(want)
        assert tuple(got.payload[k].shape) == want.shape
        assert str(got.payload[k].dtype).replace("torch.", "") == str(
            want.dtype)
        np.testing.assert_array_equal(to_numpy(got.payload[k]),
                                      to_numpy(want))
        assert jgot.payload[k].dtype == want.dtype
        np.testing.assert_array_equal(to_numpy(jgot.payload[k]),
                                      to_numpy(want))
    assert codec.FRAME_OVERHEAD == jcodec.FRAME_OVERHEAD
    assert codec.frame(tbuf) == jcodec.frame(jbuf)


def _payload_msg(rnd=3):
    return WireMessage("emb", "client", rnd, {"party": 1, "lane": 0},
                       {"c": torch.arange(24, dtype=torch.float32).reshape(
                           4, 6)})


def _as_v1(buf: bytes) -> bytes:
    """Re-pack a v2 frame as the pre-checksum v1 layout."""
    import json
    _, _, hlen = codec._HEAD.unpack_from(buf, 0)
    header = json.loads(buf[codec._HEAD.size:codec._HEAD.size + hlen])
    body = buf[codec._HEAD.size + hlen:]
    del header["crc"]
    header["v"] = 1
    hb = json.dumps(header, sort_keys=True,
                    separators=(",", ":")).encode("utf-8")
    return codec._HEAD.pack(codec._MAGIC, 1, len(hb)) + hb + body


def test_codec_reads_v1_frames():
    """A v1 frame (no checksum) decodes exactly, in both packages; lacking
    a checksum, a damaged v1 body decodes without raising."""
    msg = _payload_msg()
    v1 = _as_v1(codec.encode(msg))
    for dec in (codec.decode, jcodec.decode):
        out = dec(v1)
        assert (out.tag, out.sender, out.round, out.meta) == (
            msg.tag, msg.sender, msg.round, msg.meta)
        np.testing.assert_array_equal(to_numpy(out.payload["c"]),
                                      to_numpy(msg.payload["c"]))
    damaged = v1[:-1] + bytes([v1[-1] ^ 0x01])
    bad = codec.decode(damaged)
    assert not torch.equal(bad.payload["c"], msg.payload["c"])


def test_codec_refuses_damaged_and_foreign_frames():
    """Bit flips, truncation and header damage raise FrameCorruption (a
    ValueError); a foreign magic or version raises ValueError — the same
    errors ``repro`` raises on the same bytes."""
    buf = codec.encode(_payload_msg())
    flipped = buf[:-1] + bytes([buf[-1] ^ 0x01])
    hdr = bytearray(buf)
    hdr[codec._HEAD.size] ^= 0x01
    cases = [(flipped, FrameCorruption, jcodec.FrameCorruption, "CRC32"),
             (bytes(hdr), FrameCorruption, jcodec.FrameCorruption,
              "header"),
             (buf[:-3], FrameCorruption, jcodec.FrameCorruption,
              "truncated"),
             (buf[:codec._HEAD.size + 4], FrameCorruption,
              jcodec.FrameCorruption, "truncated"),
             (buf[:6], FrameCorruption, jcodec.FrameCorruption,
              "truncated"),
             (b"NOPE" + buf[4:], ValueError, ValueError, "magic"),
             (buf[:4] + (99).to_bytes(2, "big") + buf[6:], ValueError,
              ValueError, "version")]
    for bad, err, jerr, match in cases:
        with pytest.raises(err, match=match):
            codec.decode(bad)
        with pytest.raises(jerr, match=match):
            jcodec.decode(bad)
    assert issubclass(FrameCorruption, ValueError)
    with pytest.raises(ValueError, match="unknown wire tag"):
        WireMessage("gradient", "server")


def test_flatten_tree_matches_reference():
    rng = np.random.default_rng(0)
    tree = {"embed": {"w": rng.standard_normal((3, 2)).astype(np.float32),
                      "b": np.zeros((2,), np.float32)},
            "norm": {"scale": np.full((2,), 0.5, np.float32)}}
    flat = codec.flatten_tree(to_torch(tree))
    jflat = jcodec.flatten_tree(tree)
    assert list(flat) == list(jflat) == ["embed::b", "embed::w",
                                         "norm::scale"]
    tree_allclose(codec.unflatten_tree(flat), tree, atol=0.0)
    # the params frame both packages build from it is the same bytes
    assert codec.encode(WireMessage("params", "client", 3, {"party": 1},
                                    flat)) == jcodec.encode(
        jcodec.WireMessage("params", "client", 3, {"party": 1}, jflat))
    with pytest.raises(ValueError, match="string-keyed"):
        codec.flatten_tree({"layers": [torch.zeros(1)]})


def test_frame_prefix_is_the_measured_overhead():
    buf = codec.encode(WireMessage("stop", "server"))
    framed = codec.frame(buf)
    assert len(framed) == codec.FRAME_OVERHEAD + len(buf)
    assert codec.unframe_length(framed[:codec.FRAME_OVERHEAD]) == len(buf)
    a, b = LoopbackBackend.pair()
    sent = a.send(WireMessage("stop", "server"))
    msg, got = b.recv()
    assert sent == got == len(framed) and msg.tag == "stop"


# =============================================================== faults ====

PLANS = [
    dict(),
    dict(seed=3, drop=0.3, latency_ms=5.0, jitter_ms=2.0, max_retries=2),
    dict(seed=0, drop=0.5, max_retries=0),
    dict(seed=11, drop=0.2, latency_ms=1.5, jitter_ms=4.0, timeout_ms=10.0,
         backoff=1.5, max_retries=3),
    dict(seed=7, drop=0.9, latency_ms=1.0, party_drop=((2, 0.0), (1, 1.0)),
         party_latency_ms=((3, 9.0),), max_retries=1),
]


@pytest.mark.parametrize("plan", PLANS, ids=lambda p: str(sorted(p)))
def test_fault_plan_matches_reference(plan):
    """Every delivery — outcome, attempts, virtual ms and the attempt
    trail — equals ``repro``'s over rounds, parties and directions, and
    ``require`` fails where ``repro``'s does with the same message."""
    ours, ref = FaultPlan(**plan), jfaults.FaultPlan(**plan)
    assert ours.active == ref.active
    for t in range(25):
        for m in range(5):
            for d in ("up", "down"):
                got, want = ours.delivery(t, m, d), ref.delivery(t, m, d)
                assert tuple(got) == tuple(want), (t, m, d)
                if not want.ok:
                    with pytest.raises(DeliveryFailed) as e:
                        ours.require(t, m, d)
                    with pytest.raises(jfaults.DeliveryFailed) as je:
                        ref.require(t, m, d)
                    assert str(e.value) == str(je.value)


def test_fault_plan_validates_as_reference():
    for bad in (dict(drop=1.0), dict(drop=-0.1), dict(max_retries=-1),
                dict(timeout_ms=-1.0), dict(party_drop=((0, 1.5),))):
        with pytest.raises(ValueError):
            FaultPlan(**bad)
        with pytest.raises(ValueError):
            jfaults.FaultPlan(**bad)


@pytest.mark.parametrize("plan", [dict(corrupt_at_frame=2),
                                  dict(truncate_at_frame=3, truncate_to=5),
                                  dict(corrupt_at_frame=1,
                                       truncate_at_frame=4)])
def test_chaos_backend_damages_the_reference_bytes(plan):
    """The chaos layer damages the framed bytes exactly as ``repro``'s:
    the queued frames are equal byte for byte, the damaged ones raise
    FrameCorruption on decode and the rest decode clean."""
    a, b = LoopbackBackend.pair()
    ja, jb = JLoopbackBackend.pair()
    chaos = ChaosBackend(a, ChaosPlan(**plan))
    jchaos = jfaults.ChaosBackend(ja, jfaults.ChaosPlan(**plan))
    for r in range(5):
        msg = _payload_msg(rnd=r)
        assert chaos.send(msg) == jchaos.send(jcodec.WireMessage(
            msg.tag, msg.sender, msg.round, msg.meta,
            {"c": msg.payload["c"].numpy()}))
    assert list(b._inbox) == list(jb._inbox)
    damaged = {plan.get("corrupt_at_frame"), plan.get("truncate_at_frame")}
    for n in range(1, 6):
        if n in damaged:
            with pytest.raises(FrameCorruption):
                b.recv()
        else:
            assert b.recv()[0].round == n - 1
    assert chaos.frames_sent == 5


def test_chaos_backend_stalls_a_send():
    a, b = LoopbackBackend.pair()
    chaos = ChaosBackend(a, ChaosPlan(stall_at_frame=2, stall_s=0.15))
    t0 = time.monotonic()
    chaos.send(WireMessage("act", "server", 0))
    fast = time.monotonic() - t0
    t0 = time.monotonic()
    chaos.send(WireMessage("act", "server", 1))
    slow = time.monotonic() - t0
    assert slow >= 0.15 > fast
    assert [b.recv()[0].round for _ in range(2)] == [0, 1]


# ============================================================= backends ====

def test_socket_self_heal_reconnects_after_peer_drop():
    """A ``self_heal=True`` socket survives its peer dropping the
    connection between frames: the recv that hits the dead stream
    re-dials with backoff and lands on the listener's next accept."""
    listener, port = listen()
    got = {}

    def server():
        be1 = accept(listener, timeout=30.0)
        msg, _ = be1.recv(timeout=30.0)
        got["before"] = msg.meta["n"]
        be1.close()
        be2 = accept(listener, timeout=30.0)
        be2.send(WireMessage("pong", "server", 0, {"nonce": 1}))
        msg2, _ = be2.recv(timeout=30.0)
        got["after"] = msg2.meta["n"]
        be2.close()

    th = threading.Thread(target=server, daemon=True)
    th.start()
    try:
        cli = SocketBackend.connect("127.0.0.1", port, self_heal=True,
                                    heal_attempts=20, heal_delay_s=0.05)
        cli.send(WireMessage("ping", "client", 0, {"n": 1}))
        msg, _ = cli.recv(timeout=30.0)
        assert msg.tag == "pong" and msg.meta["nonce"] == 1
        cli.send(WireMessage("ping", "client", 0, {"n": 2}))
        th.join(timeout=30.0)
        assert not th.is_alive()
        assert cli.reconnects == 1
        assert got == {"before": 1, "after": 2}
        cli.close()
    finally:
        listener.close()


def _tabular_row(party=2):
    """The wire tests' tabular protocol: config, VFL, the row's params as
    torch tensors and its feature slice."""
    from repro.models import common as j_common
    from repro.models import tabular as j_tabular
    kw = dict(n_features=32, n_classes=4, n_clients=4, client_embed=16,
              server_embed=32)
    X, _ = make_classification(0, 256, 32, 4)
    Xp = vertical_partition(X, 4)
    jp = j_common.materialize(j_tabular.param_specs(JPaperMLPConfig(**kw)),
                              jax.random.key(0))
    row = to_torch(jax.tree.map(lambda a: a[party], jp["clients"]))
    return PaperMLPConfig(**kw), row, Xp[party]


def test_heartbeat_and_restart_from_checkpoint(tmp_path):
    """A loopback worker answers pings (a silent peer reads as dead, no
    exception); a worker restarted from a party-scoped checkpoint serves
    exactly the frozen row, and a missing party directory is an error."""
    cfg, row, x = _tabular_row(2)
    vfl = VFLConfig(zoo_queries=2)
    eng, cli = LoopbackBackend.pair()
    worker = ClientWorker(tabular_adapter(cfg), vfl, row, x, 2, cli)
    eng.send(WireMessage("ping", "server", 0, {"nonce": 41}))
    assert worker.pump() == 1
    msg, _ = eng.recv()
    assert msg.tag == "pong" and msg.meta == {"party": 2, "nonce": 41}
    assert heartbeat(eng, nonce=7, timeout=0.0) is False

    save_checkpoint(str(tmp_path / "client_02"), row)
    eng, cli = LoopbackBackend.pair()
    worker = ClientWorker.from_checkpoint(tabular_adapter(cfg), vfl,
                                          str(tmp_path), 2, x, cli,
                                          device="cpu")
    eng.send(WireMessage("collect", "server", 0))
    assert worker.pump() == 1
    msg, _ = eng.recv()
    assert msg.tag == "params" and msg.meta["party"] == 2
    tree_allclose(codec.unflatten_tree(msg.payload), row, atol=0.0)
    with pytest.raises(FileNotFoundError):
        ClientWorker.from_checkpoint(tabular_adapter(cfg), vfl,
                                     str(tmp_path), 3, x, cli, device="cpu")


# ================================================ the LM training hooks ====

FAMILIES = {"dense": ("phi3-mini-3.8b", {}),
            "hybrid": ("zamba2-2.7b", dict(n_layers=4))}
SEQ, M, N_ROWS, Q = 16, 2, 6, 2


def _lm(family):
    arch, kw = FAMILIES[family]
    jcfg = j_reduced(j_get_config(arch), **F32, **kw)
    cfg = reduced(get_config(arch), **F32, **kw)
    jad = j_from_model_config(jcfg, n_clients=M, seq_len=SEQ)
    ad = from_model_config(cfg, n_clients=M, seq_len=SEQ)
    jp = jad.init_params(jax.random.key(0))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (N_ROWS, SEQ)).astype(np.int32)
    return jcfg, cfg, jad, ad, jp, toks


@pytest.mark.parametrize("family", list(FAMILIES))
def test_lm_training_hooks_match_reference(family):
    """client_forward over the stacked clients, row_mask, client_lanes
    over a block of rows and server_loss (one table slice and a stack of
    1 + q lane slices) equal ``repro``'s vmapped hooks on the same
    weights, tokens and directions."""
    jcfg, cfg, jad, ad, jp, toks = _lm(family)
    tp = to_torch(jp)
    xp = vertical_partition(toks, M)                      # (M, n, span)
    tx = torch.from_numpy(xp).long()

    c = ad.client_forward(tp["clients"], tx)              # (M, n, e)
    jc = jax.vmap(jad.client_forward)(jp["clients"], jnp.asarray(xp))
    np.testing.assert_array_equal(to_numpy(c), to_numpy(jc))

    mask = ad.row_mask(tp["clients"], tx)
    jmask = jax.vmap(jad.row_mask)(jp["clients"], jnp.asarray(xp))
    tree_allclose(mask, jmask, atol=0.0)

    rng = np.random.default_rng(2)
    table = np.asarray(jp["clients"]["embed"]["table"])
    u = rng.standard_normal((M, Q) + table.shape[1:]).astype(np.float32)
    lanes = ad.client_lanes(tp["clients"],
                            {"embed": {"table": torch.from_numpy(u)}},
                            1e-3, tx)                      # (M, 1+q, n, e)
    jlanes = jax.vmap(lambda cm, uu, x: jad.client_lanes(
        cm, {"embed": {"table": uu}}, 1e-3, x))(
        jp["clients"], jnp.asarray(u), jnp.asarray(xp))
    np.testing.assert_allclose(to_numpy(lanes), to_numpy(jlanes), **FWD_TOL)

    y = toks[:4]
    c_all = c[:, :4]
    loss = ad.server_loss(tp["server"], c_all, torch.from_numpy(y))
    jloss = jad.server_loss(jp["server"], jc[:, :4], jnp.asarray(y))
    np.testing.assert_allclose(to_numpy(loss), to_numpy(jloss), **FWD_TOL)
    stack = torch.stack([c_all.index_put((torch.tensor([1]),),
                                         lanes[1, i, :4].unsqueeze(0))
                         for i in range(1 + Q)])        # (1+q, M, bs, e)
    per_lane = ad.server_loss(tp["server"], stack, torch.from_numpy(y))
    jper = jax.vmap(lambda ca: jad.server_loss(jp["server"], ca,
                                               jnp.asarray(y)))(
        to_jax(stack))
    assert per_lane.shape == (1 + Q,)
    np.testing.assert_allclose(to_numpy(per_lane), to_numpy(jper),
                               **FWD_TOL)
    # the fused gather form equals perturb-then-forward on the port
    pert = ad.client_forward(
        {"embed": {"table": (tp["clients"]["embed"]["table"][1]
                             + 1e-3 * torch.from_numpy(u[1]))}}, tx[1])
    np.testing.assert_allclose(to_numpy(lanes[1, 1:]), to_numpy(pert),
                               **FWD_TOL)


def test_lm_adapter_active_rows_gates_the_mask():
    cfg = reduced(get_config("phi3-mini-3.8b"), **F32)
    assert from_model_config(cfg, n_clients=M, seq_len=SEQ).row_mask
    assert from_model_config(cfg, n_clients=M, seq_len=SEQ,
                             active_rows=False).row_mask is None


def test_mlp_adapter_matches_reference():
    """The SwiGLU-MLP pair: client_forward over the stacked clients and
    server_loss (one slice and a leading lane dim) equal ``repro``'s."""
    jad, ad = j_mlp_adapter(), mlp_adapter()
    jp = jad.init_params(jax.random.key(3))
    tp = to_torch(jp)
    X, y = make_classification(1, 16, 32, 4)
    xp = vertical_partition(X, 4)
    c = ad.client_forward(tp["clients"], torch.from_numpy(xp))
    jc = jax.vmap(jad.client_forward)(jp["clients"], jnp.asarray(xp))
    np.testing.assert_allclose(to_numpy(c), to_numpy(jc), **FWD_TOL)
    loss = ad.server_loss(tp["server"], c, torch.from_numpy(y).long())
    jloss = jad.server_loss(jp["server"], jc, jnp.asarray(y))
    np.testing.assert_allclose(to_numpy(loss), to_numpy(jloss), **FWD_TOL)
    lanes = torch.stack([c, 2 * c])
    both = ad.server_loss(tp["server"], lanes, torch.from_numpy(y).long())
    jboth = jax.vmap(lambda ca: jad.server_loss(jp["server"], ca,
                                                jnp.asarray(y)))(
        jnp.stack([jc, 2 * jc]))
    np.testing.assert_allclose(to_numpy(both), to_numpy(jboth), **FWD_TOL)
    specs = ad.param_specs()
    jspecs = jad.param_specs()
    assert (jax.tree.map(lambda s: tuple(s.shape), jspecs,
                         is_leaf=lambda x: hasattr(x, "logical"))
            == {k: jax.tree.map(lambda s: tuple(s.shape), v,
                                is_leaf=lambda x: hasattr(x, "logical"))
                for k, v in specs.items()})


# ================================================ the worker's compute ====

@pytest.mark.parametrize("model", ["tabular", "lm-rows"])
def test_worker_uplink_and_update_match_reference(model):
    """``ClientWorker``'s two computations against ``repro``'s
    ``_client_fns`` on the same row, batch and key: the uplink's
    direction stack, φ and (1+q) embedding lanes, then the ZOO update
    from the same (1+q) losses."""
    vkw = dict(mu=1e-2, lr_client=0.05, zoo_queries=Q)
    if model == "tabular":
        cfg, row, x = _tabular_row(1)
        jad = j_tabular_adapter(JPaperMLPConfig(
            n_features=32, n_classes=4, n_clients=4, client_embed=16,
            server_embed=32))
        ad = tabular_adapter(cfg)
        xb = x[:8]
    else:
        jcfg, cfg, _, _, jp, toks = _lm("dense")
        jad = j_from_model_config(jcfg, n_clients=M, seq_len=SEQ)
        ad = from_model_config(cfg, n_clients=M, seq_len=SEQ)
        row = to_torch(jax.tree.map(lambda a: a[1], jp["clients"]))
        xb = vertical_partition(toks, M)[1][:4]
    key = jax.random.key(5)
    j_uplink, j_update = jworker._client_fns(jad, JVFLConfig(**vkw))
    uplink, update = _client_fns(ad, VFLConfig(**vkw))
    ju, jphi, jemb = j_uplink(to_jax(row), jnp.asarray(xb), key)
    u, phi, emb = uplink(row, torch.from_numpy(np.asarray(xb)),
                         raw_normals(key, row, Q))
    tree_allclose(u, ju, atol=1e-6)
    np.testing.assert_allclose(to_numpy(torch.as_tensor(phi)),
                               to_numpy(jphi), rtol=1e-6)
    np.testing.assert_allclose(to_numpy(emb), to_numpy(jemb), **FWD_TOL)
    losses = np.asarray([1.25, 1.2513, 1.2478], np.float32)[:1 + Q]
    new = update(row, u, phi, torch.from_numpy(losses))
    jnew = j_update(to_jax(row), ju, jphi, jnp.asarray(losses))
    tree_allclose(new, jnew, atol=1e-6)


def test_port_act_frame_reads_in_reference():
    """The port engine's act frame (int32 batch indices, the (seed, t,
    row) key words of ``RowDraws``) is a valid v2 frame ``repro``'s
    decode reads, and the default worker source draws from its words
    alone: the same directions as the engine's ``client_directions``."""
    from repro_torch.core.draws import RowDraws, seed_directions
    draws = RowDraws(11, "cpu")
    idx = np.arange(8, dtype=np.int32)
    buf = codec.encode(WireMessage("act", "server", 5, {"party": 3},
                                   {"idx": idx, "key": draws.row_key(5, 2)}))
    jmsg = jcodec.decode(buf)
    assert (jmsg.tag, jmsg.round, jmsg.meta) == ("act", 5, {"party": 3})
    np.testing.assert_array_equal(jmsg.payload["idx"], idx)
    np.testing.assert_array_equal(jmsg.payload["key"], [11, 5, 2])
    template = {"embed": {"table": torch.zeros(7, 3)}}
    got = seed_directions(codec.decode(buf).payload["key"], template, 2)
    want = draws.client_directions(5, template, 3, 2)
    assert torch.equal(got["embed"]["table"], want["embed"]["table"][2])
