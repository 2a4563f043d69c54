"""The engine's compiled round (``async_engine._make_runner``): one round
body on static buffers, captured as a CUDA graph on the card and looped
here on the CPU, with its draws read from a ``RoundDraws``.

* The body looped over two rounds against ``repro``'s ``run`` on its
  injected threefry draws, for the five methods, the fused lanes, block
  3 with q = 4 and the DP loss channel, at the engine tests' one-round
  tolerances (``assert_round_parity``). The second round reads the draws
  ``RoundDraws.fill`` copied into the buffers the first recorded. Past
  two rounds a ZOO client's φ/μ carries the frameworks' f32 rounding
  into the table beyond those tolerances (ROADMAP Queue 3 item 4);
  ``test_torch_engine_run.py`` holds 25 rounds through the same body at
  ``repro``'s trajectory atol.
* A recording draw source sees the same calls, arguments and order from
  the filled rounds as from the step called directly in a plain eager
  loop, for each method, so a ``TorchDraws`` generator advances as the
  eager step advances it: the two loops' results are bitwise equal.
* ``RoundDraws`` refuses a round that asks out of its record.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import VFLConfig
from repro_torch.configs.paper_mlp import PaperMLPConfig
from repro_torch.core import async_engine
from repro_torch.core.adapters import tabular_adapter
from repro_torch.core.draws import RoundDraws, TorchDraws
from repro_torch.core.methods import SYNC_METHODS
from repro_torch.core.partition import tree_leaves, tree_map
from repro_torch.core.privacy import GaussianLossChannel
from repro_torch.data import make_classification, vertical_partition
from repro_torch.federation import Federation
from test_torch_support import (ENGINE_MLP, LRS, assert_round_parity,
                                engine_case, torch_threads)

ROUNDS = 2
NOISE = dict(clip=10.0, epsilon=1.0, delta=1e-5)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    with torch_threads(1):
        yield


def _id(case):
    return "-".join(f"{k}={v}" for k, v in case.items() if k != "noise") + (
        "-dp" if "noise" in case else "")


# every method, the fused lanes (plain and kernel), block 3 with q = 4,
# and the DP channel, each over ROUNDS rounds of the static-buffer body
PARITY = [
    dict(method="cascaded", q=1, block=1, dist="sphere"),
    dict(method="cascaded", q=4, block=3, dist="normal", use_lanes=True,
         kernel_lanes=True),
    # under the DP channel at the engine tests' μ = 1e-2 the noise, over
    # μ, moves a client by ~1e3 in one round, and the table it refreshes
    # in the next carries the frameworks' rounding past the one-round
    # tolerance; at μ = 1 with normal directions it moves ~9
    dict(method="cascaded", q=2, block=3, dist="normal", mu=1.0,
         noise=NOISE),
    dict(method="vafl", block=3),
    dict(method="zoo-vfl", q=2, block=1, dist="normal"),
    dict(method="split"),
    dict(method="syn-zoo", q=2, dist="normal"),
]


@pytest.mark.parametrize("case", PARITY, ids=_id)
def test_round_body_loop_matches_reference(case):
    case = dict(case)
    method = case.pop("method")
    j, t = engine_case(method, steps=ROUNDS, **case)
    assert t["res"].round_graph is None          # the CPU loops the body
    assert t["losses"].shape == (ROUNDS,)
    assert_round_parity(method, j, t)


class RecordingDraws:
    """A draw source that logs every round-draw call (method, t, its
    template's leaf shapes, its integer arguments) and passes it on."""

    def __init__(self, inner):
        self.inner, self.log = inner, []

    def _call(self, name, t, *args):
        shapes = tuple(tuple(leaf.shape) for a in args
                       if not isinstance(a, int) for leaf in tree_leaves(a))
        self.log.append((name, t, shapes,
                         tuple(a for a in args if isinstance(a, int))))
        return getattr(self.inner, name)(t, *args)

    def client_directions(self, t, template, n_rows, q):
        return self._call("client_directions", t, template, n_rows, q)

    def server_directions(self, t, template, q):
        return self._call("server_directions", t, template, q)

    def global_directions(self, t, template, q):
        return self._call("global_directions", t, template, q)

    def noise(self, t, n_rows, n):
        return self._call("noise", t, n_rows, n)


def eager_rounds(step_fn, params, table, delays, schedule, sample_idx,
                 draws, x, y, sync):
    """The plain eager loop: the step called directly with the Python
    round index and the draw source itself."""
    params = tree_map(torch.clone, params)
    table, delays = table.clone(), delays.clone()
    losses, maxd = [], []
    for t in range(schedule.shape[0]):
        m_blk, idx = schedule[t], sample_idx[t]
        params, table, loss = step_fn(params, table, m_blk, idx, t, draws,
                                      x, y)
        if sync:
            delays.zero_()
        else:
            delays += 1
            delays[m_blk[:, None], idx[None, :]] = 0
        losses.append(loss)
        maxd.append(delays.max())
    return (params, table, delays), (torch.stack(losses), torch.stack(maxd))


DRAW_CASES = [
    dict(method="cascaded", q=2, block=2),
    dict(method="cascaded", q=4, block=3, use_lanes=True),
    dict(method="cascaded", q=2, block=2, noise=NOISE),
    dict(method="vafl", block=2),
    dict(method="zoo-vfl", q=2, block=2),
    dict(method="split"),
    dict(method="syn-zoo", q=3),
]


@pytest.mark.parametrize("case", DRAW_CASES, ids=_id)
def test_filled_rounds_ask_what_the_eager_step_asks(case):
    method = case["method"]
    sync = method in SYNC_METHODS
    q, block = case.get("q", 1), 1 if sync else case.get("block", 1)
    use_lanes = case.get("use_lanes", False)
    cfg = PaperMLPConfig(**ENGINE_MLP)
    X, y = make_classification(0, 64, cfg.n_features, cfg.n_classes)
    x = torch.from_numpy(vertical_partition(X, cfg.n_clients))
    y = torch.from_numpy(y).long()
    ad = tabular_adapter(cfg)
    vfl = VFLConfig(mu=1e-2, lr_server=LRS[method], lr_client=LRS[method],
                    zoo_queries=q)
    fed = Federation.build(
        ad, vfl, async_engine.EngineConfig(method=method, steps=4,
                                           batch_size=8, block_size=block,
                                           use_lanes=use_lanes),
        noise=(GaussianLossChannel(**case["noise"]) if "noise" in case
               else None), device="cpu")
    params = ad.init_params(torch.Generator().manual_seed(0))
    table0 = ad.client_forward(params["clients"], x)
    delays0 = torch.zeros(table0.shape[:2], dtype=torch.int32)
    if sync:
        step_fn = async_engine._make_sync_step(ad, fed.transport, vfl)
    else:
        step_fn = async_engine._make_async_step(ad, fed.transport, vfl,
                                                use_lanes)
    runner = async_engine._make_runner(ad, fed.transport, vfl, sync, block,
                                       use_lanes)
    out, logs = [], []
    for loop in (eager_rounds, None):
        src = TorchDraws(5, "cpu")
        sched = src.schedule(4, cfg.n_clients, None, block)
        idx = src.sample_indices(4, 8, x.shape[1])
        rec = RecordingDraws(src)
        if loop is None:
            out.append(runner(params, table0, delays0, sched, idx, rec, x, y))
        else:
            out.append(loop(step_fn, params, table0, delays0, sched, idx,
                            rec, x, y, sync))
        logs.append(rec.log)
    assert logs[0] == logs[1]
    assert {t for _, t, _, _ in logs[0]} == (
        set() if method in ("vafl", "split") else set(range(4)))
    (p0, tab0, d0), (l0, m0) = out[0]
    (p1, tab1, d1), (l1, m1) = out[1]
    for a, b in ((tab0, tab1), (d0, d1), (l0, l1), (m0, m1)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(p0), tree_leaves(p1)):
        assert torch.equal(a, b)


def test_round_draws_refuse_a_round_out_of_its_record():
    src = TorchDraws(0, "cpu")
    template = {"w": torch.zeros(3, 2)}
    rd = RoundDraws(src)
    rd.fill(0)
    first = rd.client_directions(0, template, 2, 1)
    rd.noise(0, 2, 2)
    rd.done()
    assert rd.calls[0][0] == "client_directions"
    rd.fill(1)
    again = rd.client_directions(1, template, 2, 1)
    assert again["w"] is first["w"]               # the recorded buffer
    with pytest.raises(RuntimeError, match="record has noise"):
        rd.server_directions(1, template, 1)
    rd = RoundDraws(src)
    rd.fill(0)
    rd.noise(0, 2, 2)
    rd.done()
    rd.fill(1)
    with pytest.raises(RuntimeError, match="record has noise"):
        rd.noise(1, 3, 2)                         # another shape
    rd = RoundDraws(src)
    rd.fill(0)
    rd.noise(0, 2, 2)
    rd.done()
    rd.fill(1)
    with pytest.raises(RuntimeError, match="0 of its 1"):
        rd.done()                                 # a draw left unasked


def test_fill_refills_the_buffers_in_place_from_the_source():
    """Round t's draws land in the buffers the first round recorded:
    the same tensors, holding what the source answers for round t."""
    template = {"b": torch.zeros(4), "w": torch.zeros(3, 2)}
    rd = RoundDraws(TorchDraws(1, "cpu"))
    want = TorchDraws(1, "cpu")
    rd.fill(0)
    buf = rd.client_directions(0, template, 2, 3)
    ref0 = want.client_directions(0, template, 2, 3)
    rd.done()
    for k in buf:
        assert torch.equal(buf[k], ref0[k])
    ptrs = {k: v.data_ptr() for k, v in buf.items()}
    rd.fill(1)
    got = rd.client_directions(1, template, 2, 3)
    rd.done()
    ref1 = want.client_directions(1, template, 2, 3)
    for k in got:
        assert got[k].data_ptr() == ptrs[k]
        assert torch.equal(got[k], ref1[k])
    assert not np.array_equal(got["w"].numpy(), ref0["w"].numpy())
