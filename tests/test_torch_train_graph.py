"""The compiled LM training step (``Federation.sync_step(opt,
graph=True)``: a :class:`repro_torch.graphs.GraphedFn` over the step with
the optimizer's in-place update, the counterpart of the JAX driver's
``jax.jit(step_fn, donate_argnums=(0, 1))``) on the CPU, where the
captured body loops on its static buffers and its draws are refilled
through a ``RoundDraws`` over ``StepDraws``.

* Looped for 3 steps it equals the functional step bitwise (losses,
  every StepOutput, params, optimizer state) for cascaded at q = 1 and 4,
  vafl, zoo-vfl, syn-zoo, the DP loss channel and the active-row mask,
  on reduced phi3 in f32.
* A later (refilled) call matches ``repro``'s ``jax.jit(step_fn)`` on the
  injected threefry draws at ``tests/test_torch_train_step.py``'s
  tolerances.
* A ``RoundDraws`` over ``StepDraws`` asks the same calls, in the same
  order, as the eager step, for each method.
* :class:`GraphedFn`'s keys: one a distinct shape (and Python value),
  reused for repeated shapes; donated arguments are read where they are,
  the rest copied into the key's buffers (no capture runs here).
* The optimizers' in-place update equals the functional one bitwise,
  and the functional one leaves its inputs untouched.
* Resume at step k of the looped form equals the unbroken run bitwise.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import VFLConfig as JVFLConfig
from repro.core import cascade as j_cascade
from repro.optim import sgd as j_sgd
from repro_torch import graphs
from repro_torch.configs import VFLConfig, get_config, reduced
from repro_torch.core.async_engine import EngineConfig
from repro_torch.core.draws import StepDraws
from repro_torch.core.privacy import GaussianLossChannel
from repro_torch.data import lm_token_batches
from repro_torch.federation import Federation
from repro_torch.models import common
from repro_torch.optim import adamw, in_place, make_schedule, sgd
from repro_torch.tree import tree_leaves, tree_map
from test_torch_support import _flat, to_torch, torch_threads
from test_torch_train_step import B, PHI3, S, JaxStepDraws, _setup

STEPS = 3
NOISE = dict(clip=10.0, epsilon=1.0, delta=1e-5)
CASES = {
    "cascaded-q1": dict(method="cascaded"),
    "cascaded-q4": dict(method="cascaded", q=4),
    "vafl": dict(method="vafl"),
    "zoo-vfl": dict(method="zoo-vfl", q=2),
    "syn-zoo": dict(method="syn-zoo"),
    "dp": dict(method="cascaded", noise=NOISE, dist="sphere", mu=1e-3),
    "active-rows": dict(method="cascaded", q=2, dist="sphere", mu=5e-2,
                        active_rows_only=True),
}


@pytest.fixture(autouse=True)
def _threads():
    with torch_threads(2):
        yield


def _session(case):
    c = dict(CASES[case])
    method, noise = c.pop("method"), c.pop("noise", None)
    cfg = reduced(get_config(PHI3), param_dtype="float32")
    vfl = VFLConfig(mu=c.pop("mu", 1e-2), lr_server=0.05, lr_client=0.02,
                    zoo_dist=c.pop("dist", "normal"),
                    zoo_queries=c.pop("q", 1), **c)
    fed = Federation.build(cfg, vfl, EngineConfig(method=method,
                                                  batch_size=B),
                           seq_len=S, device="cpu",
                           noise=None if noise is None
                           else GaussianLossChannel(**noise))
    params = common.materialize(fed.model.param_specs,
                                torch.Generator().manual_seed(0),
                                device="cpu")
    batches = [{k: torch.from_numpy(v) for k, v in b.items()}
               for _, b in zip(range(2 * STEPS), lm_token_batches(
                   1, cfg.vocab_size, B, S))]
    return fed, params, batches


def _clone(tree):
    return tree_map(torch.clone, tree)


def _loop(step, params, state, batches, start, stop, draws):
    outs = []
    for t in range(start, stop):
        params, state, out = step(params, state, batches[t], t, draws)
        outs.append(tuple(x.clone() for x in (
            out.loss, out.loss_perturbed, out.grad_client_norm,
            out.grad_server_norm)))
    return params, state, outs


def _assert_bitwise(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("case", list(CASES))
def test_static_step_loop_equals_functional(case):
    fed, params, batches = _session(case)
    opt = sgd(make_schedule("cosine", 0.05, total_steps=10))
    draws = StepDraws(7, "cpu")
    fp, fs, fouts = _loop(fed.sync_step(opt), _clone(params),
                          opt.init(params), batches, 0, STEPS, draws)
    graphed = fed.sync_step(opt, graph=True)
    assert isinstance(graphed, graphs.GraphedFn)
    p0, s0 = _clone(params), opt.init(params)
    gp, gs, gouts = _loop(graphed, p0, s0, batches, 0, STEPS, draws)
    # donated: the step wrote into the trees it was given
    assert gp is p0 and gs is s0
    assert len(graphed.graphs) == 1
    _assert_bitwise(gouts, fouts)
    _assert_bitwise(gp, fp)
    _assert_bitwise(gs, fs)
    assert int(gs["step"]) == STEPS


def test_refilled_call_matches_reference_step():
    """The looped body's second call (static inputs copied in, the draws
    of its t refilled) against ``repro``'s jitted step at t from the same
    params, at the step tests' tolerances (FOO leaves' steps at 1e-4 of
    their largest entry, the ZOO client's at 1e-2)."""
    jcfg, cfg, jmodel, model, jparams, jbatch, batch = _setup(PHI3)
    vk = dict(mu=1e-2, lr_server=0.05, lr_client=0.02, zoo_dist="normal")
    jopt = j_sgd(0.05)
    jstep = j_cascade.make_step_for_method(
        "cascaded", jmodel.loss_fn, jmodel.client_keys, JVFLConfig(**vk),
        jopt, vocab=jcfg.padded_vocab)
    t = 3
    jp, _, jo = jax.jit(jstep)(jparams, jopt.init(jparams), jbatch,
                               jax.random.fold_in(jax.random.key(5), t))
    fed = Federation.build(cfg, VFLConfig(**vk), EngineConfig(batch_size=B),
                           seq_len=S, device="cpu")
    opt = sgd(0.05)
    step = fed.sync_step(opt, graph=True)
    draws = JaxStepDraws(5, "cascaded")
    warm = to_torch(jparams)
    step(warm, opt.init(warm), {k: v + 1 for k, v in batch.items()}, t - 1,
         draws)
    params = to_torch(jparams)
    tp, ts, to = step(params, opt.init(params), batch, t, draws)
    # a tree passed anew is copied into the donated one and updated there
    assert tp is warm
    np.testing.assert_allclose(float(to.loss), float(jo.loss), rtol=1e-5)
    np.testing.assert_allclose(float(to.grad_server_norm),
                               float(jo.grad_server_norm), rtol=1e-4)
    np.testing.assert_allclose(float(to.grad_client_norm),
                               float(jo.grad_client_norm), rtol=5e-3)
    assert int(ts["step"]) == 1
    p0, got, want = _flat(jparams), _flat(tp), _flat(jp)
    for k in want:
        zoo = k.startswith("embed/")
        delta = np.abs(want[k] - p0[k]).max()
        ulp = np.spacing(np.abs(p0[k]).max().astype(np.float32))
        np.testing.assert_allclose(got[k] - p0[k], want[k] - p0[k], rtol=0,
                                   atol=(1e-2 if zoo else 1e-4) * delta
                                   + ulp, err_msg=k)


class RecordingDraws:
    """Logs every draw call (method, t, template shapes, integer args)."""

    def __init__(self, inner):
        self.inner, self.log = inner, []

    def _call(self, name, t, *args):
        shapes = tuple(tuple(x.shape) for a in args
                       if not isinstance(a, int) for x in tree_leaves(a))
        self.log.append((name, t, shapes,
                         tuple(a for a in args if isinstance(a, int))))
        return getattr(self.inner, name)(t, *args)

    def client_directions(self, t, template, n_rows, q):
        return self._call("client_directions", t, template, n_rows, q)

    def server_directions(self, t, template, q):
        return self._call("server_directions", t, template, q)

    def noise(self, t, n_rows, n):
        return self._call("noise", t, n_rows, n)


@pytest.mark.parametrize("case", list(CASES))
def test_round_draws_ask_what_the_eager_step_asks(case):
    fed, params, batches = _session(case)
    opt = sgd(0.05)
    eager, looped = (RecordingDraws(StepDraws(3, "cpu")) for _ in range(2))
    _loop(fed.sync_step(opt), _clone(params), opt.init(params), batches, 0,
          STEPS, eager)
    _loop(fed.sync_step(opt, graph=True), _clone(params), opt.init(params),
          batches, 0, STEPS, looped)
    assert looped.log == eager.log
    assert bool(eager.log) == (CASES[case]["method"] != "vafl")


def test_graphed_fn_keys():
    """One key a distinct (structure, shape, dtype, value); a repeated
    key reuses its buffers and records nothing anew."""
    calls = []

    class Source:
        def noise(self, t, n_rows, n):
            return torch.full((n_rows, n), float(t))

    def fn(acc, x, k, t, draws):
        calls.append(x.shape)
        noise = draws.noise(t, 1, 2)
        acc.add_(x.sum() * k + noise.sum())
        return x * 2

    g = graphs.GraphedFn(fn, "cpu", donate=(0,))
    acc = torch.zeros(())
    a, b = torch.ones(3), torch.ones(4)
    a_before = a.clone()
    out = [g(acc, a, 1, 0, Source()), g(acc, a + 1, 1, 1, Source()),
           g(acc, b, 1, 2, Source()), g(acc, a, 2, 3, Source()),
           g(acc, b, 1, 4, Source())]
    assert len(g.graphs) == 3 and set(g.graphs.values()) == {None}
    assert g.stats()["graphs"] == 0          # nothing captured on the CPU
    assert torch.equal(a, a_before)          # not donated: never written
    # acc accumulates in place: sums 3, 6, 4, 6, 4 and the noise 2t
    assert float(acc) == 3 + 0 + 6 + 2 + 4 + 4 + 6 + 6 + 4 + 8
    assert torch.equal(out[1], torch.full((3,), 4.0))
    assert calls == [(3,), (3,), (4,), (3,), (4,)]
    assert graphs.signature((a, 1)) != graphs.signature((a, 2))
    assert graphs.signature({"x": a}) == graphs.signature({"x": a + 1})
    assert graphs.signature((a,)) != graphs.signature((a.double(),))


@pytest.mark.parametrize("opt", [
    sgd(0.05), sgd(make_schedule("cosine", 0.1, total_steps=4),
                   momentum=0.9, weight_decay=1e-2, grad_clip=0.5),
    adamw(1e-2, weight_decay=1e-2, grad_clip=1.0)],
    ids=["sgd", "sgd-momentum", "adamw"])
def test_in_place_update_equals_functional(opt):
    gen = torch.Generator().manual_seed(0)
    params = {"a": torch.randn(5, 3, generator=gen),
              "b": {"c": torch.randn(7, generator=gen).bfloat16()}}
    grads = [tree_map(lambda p: torch.randn(p.shape, generator=gen)
                      .to(p.dtype), params) for _ in range(3)]
    fp, fs = _clone(params), opt.init(params)
    ip, istate = _clone(params), opt.init(params)
    upd = in_place(opt).update
    for g in grads:
        fp, fs = opt.update(g, fs, fp)
        tp, ts = upd(g, istate, ip)
        assert tp is ip and ts is istate
        _assert_bitwise(ip, fp)
        _assert_bitwise(istate, fs)


@pytest.mark.parametrize("opt", [
    sgd(0.05), sgd(make_schedule("cosine", 0.1, total_steps=4),
                   momentum=0.9, weight_decay=1e-2, grad_clip=0.5),
    adamw(1e-2, weight_decay=1e-2, grad_clip=1.0)],
    ids=["sgd", "sgd-momentum", "adamw"])
def test_functional_update_leaves_its_inputs_untouched(opt):
    """``update`` returns new trees (SGD's is its in-place body on
    clones): the params, state and grads it is given keep their values,
    and the new trees are other tensors."""
    gen = torch.Generator().manual_seed(1)
    params = {"a": torch.randn(5, 3, generator=gen),
              "b": {"c": torch.randn(7, generator=gen).bfloat16()}}
    state = opt.init(params)
    for _ in range(2):
        grads = tree_map(lambda p: torch.randn(p.shape, generator=gen)
                         .to(p.dtype), params)
        before = _clone((grads, state, params))
        new_params, new_state = opt.update(grads, state, params)
        _assert_bitwise((grads, state, params), before)
        assert int(new_state["step"]) == int(state["step"]) + 1
        for new, old in zip(tree_leaves((new_params, new_state)),
                            tree_leaves((params, state))):
            assert new.data_ptr() != old.data_ptr()
        assert not all(torch.equal(x, y) for x, y in
                       zip(tree_leaves(new_params), tree_leaves(params)))
        params, state = new_params, new_state


def test_resume_of_looped_step_equals_unbroken():
    """The looped static form stopped at step k, its trees copied out
    and a new compiled step resumed from them, equals the unbroken
    run."""
    fed, params, batches = _session("cascaded-q1")
    opt = sgd(0.05)
    draws = StepDraws(7, "cpu")
    k, n = 2, 2 * STEPS
    wp, ws, wouts = _loop(fed.sync_step(opt, graph=True), _clone(params),
                          opt.init(params), batches, 0, n, draws)
    hp, hs, houts = _loop(fed.sync_step(opt, graph=True), _clone(params),
                          opt.init(params), batches, 0, k, draws)
    rp, rs, routs = _loop(fed.sync_step(opt, graph=True), _clone(hp),
                          _clone(hs), batches, k, n, draws)
    _assert_bitwise(houts + routs, wouts)
    _assert_bitwise(rp, wp)
    _assert_bitwise(rs, ws)
