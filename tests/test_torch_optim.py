"""The port's optimizers and schedules (``repro_torch.optim``) against the
JAX package's (``repro.optim``): the same trees, the same gradients, the
same step clocks -> the same params, state and learning rates, at 1e-6.

The trees mix an f32 and a bf16 leaf (the full models' params are bf16
with f32 norms), so the f32 state and the ``(p.f32 − η·u).to(p.dtype)``
rounding are both held. The reference's update runs jitted, as its train
step does: eager JAX rounds ``η·u`` of a bf16 gradient to bf16 (after
rounding a float η to bf16), the jitted step keeps it in f32, as the port
does. The bf16 leaf is held to one bf16 step (at most 2^-7 relative):
XLA's CPU backend may contract ``p − η·u`` into one fused multiply-add,
whose f32 result can sit one f32 ulp off the port's and round to the
neighbouring bf16 value."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as j_optim
from repro.optim import optimizers as j_optimizers
from repro.optim import schedule as j_schedule
from repro_torch import optim
from repro_torch.optim import optimizers, schedule
from test_torch_support import to_torch, tree_allclose

TOL = dict(atol=1e-6, rtol=1e-6)
BF16_STEP = dict(atol=1e-6, rtol=2.0 ** -7)


def _trees(seed=0):
    rng = np.random.default_rng(seed)
    params = {"a": {"w": rng.normal(size=(6, 5)).astype(np.float32)},
              "b": rng.normal(size=(7,)).astype(np.float32)}
    grads = [{"a": {"w": rng.normal(size=(6, 5)).astype(np.float32)},
              "b": rng.normal(size=(7,)).astype(np.float32)}
             for _ in range(3)]
    jp = {"a": {"w": jnp.asarray(params["a"]["w"])},
          "b": jnp.asarray(params["b"], jnp.bfloat16)}
    return jp, [jax.tree.map(jnp.asarray, g) for g in grads]


def _jax_to_torch(tree):
    return to_torch(jax.tree.map(np.asarray, tree))


def _run_both(j_opt, opt):
    """Three updates of each optimizer from the same grads, each update of
    the port from the reference's params and state of that step (a bf16
    leaf one step apart would compound); the bf16 grads of the bf16 leaf
    cross bit-exactly."""
    jp, jgrads = _trees()
    jgrads = [{"a": g["a"], "b": g["b"].astype(jnp.bfloat16)} for g in jgrads]
    js = j_opt.init(jp)
    ts = opt.init(_jax_to_torch(jp))
    tree_allclose(ts, js, atol=0)
    for jg in jgrads:
        tp, ts = opt.update(_jax_to_torch(jg), _jax_to_torch(js),
                            _jax_to_torch(jp))
        jp, js = jax.jit(j_opt.update)(jg, js, jp)
        assert tp["b"].dtype == torch.bfloat16
        tree_allclose(tp["a"], jp["a"], **TOL)
        tree_allclose({"b": tp["b"]}, {"b": jp["b"]}, **BF16_STEP)
        tree_allclose(ts, js, **TOL)
    return tp, ts


@pytest.mark.parametrize("momentum,weight_decay", [(0.0, 0.0), (0.9, 0.0),
                                                   (0.0, 0.1), (0.9, 0.1)])
def test_sgd_matches_reference(momentum, weight_decay):
    _, ts = _run_both(j_optim.sgd(0.05, momentum=momentum,
                                  weight_decay=weight_decay),
                      optim.sgd(0.05, momentum=momentum,
                                weight_decay=weight_decay))
    assert int(ts["step"]) == 3 and ts["step"].dtype == torch.int32
    assert ("mom" in ts) == bool(momentum)


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adamw_matches_reference(weight_decay):
    _run_both(j_optim.adamw(1e-2, weight_decay=weight_decay),
              optim.adamw(1e-2, weight_decay=weight_decay))


@pytest.mark.parametrize("clip", [0.5, 100.0])
def test_grad_clip_matches_reference(clip):
    _, jgrads = _trees(1)
    got = optimizers._clip(_jax_to_torch(jgrads[0]), clip)
    tree_allclose(got, j_optimizers._clip(jgrads[0], clip), **TOL)
    _run_both(j_optim.sgd(0.05, momentum=0.9, grad_clip=clip),
              optim.sgd(0.05, momentum=0.9, grad_clip=clip))
    _run_both(j_optim.adamw(1e-2, grad_clip=clip),
              optim.adamw(1e-2, grad_clip=clip))


SCHEDULES = [("constant", {}), ("cosine", {"total_steps": 40}),
             ("cosine", {"warmup": 10, "total_steps": 40}),
             ("inv_sqrt", {"warmup": 8})]


@pytest.mark.parametrize("name,kw", SCHEDULES,
                         ids=["constant", "cosine", "warmup_cosine",
                              "inv_sqrt"])
def test_schedules_match_reference(name, kw):
    fn, j_fn = (schedule.make_schedule(name, 0.3, **kw),
                j_schedule.make_schedule(name, 0.3, **kw))
    for step in (0, 1, 5, 9, 10, 11, 25, 40, 41, 100):
        got = fn(torch.tensor(step, dtype=torch.int32))
        want = j_fn(jnp.int32(step))
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), float(want), **TOL,
                                   err_msg=f"{name} at step {step}")
    with pytest.raises(ValueError, match="unknown schedule"):
        schedule.make_schedule("linear", 0.3)


def test_scheduled_sgd_matches_reference():
    """The schedule drives the update through the step clock."""
    _run_both(j_optim.sgd(j_schedule.warmup_cosine(0.1, 1, 3)),
              optim.sgd(schedule.warmup_cosine(0.1, 1, 3)))
