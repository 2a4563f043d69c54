"""Functional optimizers over tensor trees (the JAX package's hand-rolled
ones, not ``torch.optim``, whose state layout and rounding differ).

The paper applies *vanilla SGD* to every framework ("To make a fair
comparison, we applied the vanilla SGD strategy to all VFL frameworks"),
so production configs default to SGD; AdamW is provided for ablations and
small-scale runs. State is a dict of trees with a 0-dim int32 ``step``;
moments are float32 whatever the params' dtype, and each update is
``(p.f32 − η·u).to(p.dtype)`` as in the JAX package. ``update`` returns
new trees and leaves its inputs untouched; :func:`in_place` gives the
form whose ``update`` writes the new values into the trees it is given,
the counterpart of the JAX driver's ``donate_argnums=(0, 1)`` (a captured
training step, ``graphs.GraphedFn``, updates its static trees that way).
``η·u`` is formed in f32, as
the JAX package's jitted step computes it (XLA keeps the f32 of
``p.f32 − η·u`` and drops the bf16 rounding of a bf16 ``η·u`` that its
eager type promotion would insert); torch keeps bf16 against a 0-dim f32
tensor, so the port widens u explicitly. Each update runs in a profiler
range ("SGD update", "AdamW update").
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch.distributed.tensor import DTensor
from torch.profiler import record_function

from repro_torch.tree import tree_leaves, tree_map


def _as_given(grads, params):
    return grads


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable      # params -> state
    update: Callable    # (grads, state, params) -> (new_params, new_state)
    name: str = "sgd"
    # the donated form of ``update``: (grads, state, params) -> (params,
    # state), the new values written into the given trees; None:
    # ``in_place`` copies ``update``'s values in
    apply: Optional[Callable] = None
    # (grads, params) -> grads as ``update`` takes them: a step factory
    # places its gradient trees once, then reads its logged norms from
    # them and hands them to ``update``; the identity but under
    # ``placed_like_params``
    place: Callable = _as_given


def in_place(opt: Optimizer) -> Optimizer:
    """``opt`` whose ``update`` writes the new parameters and state into
    the trees it is given and returns those trees, with the bits of the
    functional update."""
    def copied(grads, state, params):
        new_params, new_state = opt.update(grads, state, params)
        for old, new in zip(tree_leaves((params, state)),
                            tree_leaves((new_params, new_state))):
            old.copy_(new)
        return params, state
    return dataclasses.replace(opt, update=opt.apply or copied, apply=None)


def placed_like_params(opt: Optimizer) -> Optimizer:
    """``opt`` whose ``place`` brings each DTensor gradient to its
    parameter's placement: a parameter's gradient over a sharded batch
    comes out of autograd a partial sum, and this is the reduction the
    JAX driver's jitted step inserts there (a reduce-scatter to a sharded
    parameter's shard, an all-reduce for a replicated one), in the
    gradient's own dtype, so every new leaf keeps its parameter's
    placement and the functional and the in-place update agree bitwise.
    The step factories place each gradient tree once, before their norms
    and the update. Plain tensors pass as they are."""
    def like(g, p):
        if (isinstance(p, DTensor) and isinstance(g, DTensor)
                and g.placements != p.placements):
            return g.redistribute(p.device_mesh, p.placements)
        return g

    def place(grads, params):
        return tree_map(like, grads, params)
    return dataclasses.replace(opt, place=place)


def _tree_zeros_f32(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _step0(params) -> torch.Tensor:
    device = tree_leaves(params)[0].device
    return torch.zeros((), dtype=torch.int32, device=device)


def sgd(lr, momentum: float = 0.0, weight_decay: float = 0.0,
        grad_clip: float = 0.0) -> Optimizer:
    """lr: float or schedule fn(step) -> 0-dim f32 tensor."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        state = {"step": _step0(params)}
        if momentum:
            state["mom"] = _tree_zeros_f32(params)
        return state

    def step_(grads, state, params, put):
        """The update's arithmetic; ``put(old, new)`` stores each new leaf
        and returns it: written into ``old`` (``copy_`` rounds to its
        type) or as a new tensor of ``old``'s type. Either way one new
        leaf's f32 temporaries are alive at once."""
        step = state["step"]
        eta = lr_fn(step)
        grads = _clip(grads, grad_clip)
        if weight_decay:
            grads = tree_map(lambda g, p: g.float() + weight_decay * p.float(),
                             grads, params)
        upd = grads
        new_state = {}
        if momentum:
            upd = new_state["mom"] = tree_map(
                lambda m, g: put(m, momentum * m + g.float()),
                state["mom"], grads)
        new_params = tree_map(
            lambda p, u: put(p, p.float() - eta * u.float()), params, upd)
        new_state["step"] = put(step, step + 1)
        return new_params, new_state

    def update(grads, state, params):
        return step_(grads, state, params, lambda old, new: new.to(old.dtype))

    def apply(grads, state, params):
        step_(grads, state, params, lambda old, new: old.copy_(new))
        return params, state

    return Optimizer(init=init, update=_ranged("SGD", update),
                     name="sgd", apply=_ranged("SGD", apply))


def adamw(lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0, grad_clip: float = 0.0) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        return {"step": _step0(params), "m": _tree_zeros_f32(params),
                "v": _tree_zeros_f32(params)}

    def update(grads, state, params):
        step = state["step"] + 1
        eta = lr_fn(step)
        grads = _clip(grads, grad_clip)
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.float(),
                     state["m"], grads)
        v = tree_map(
            lambda v_, g: b2 * v_ + (1 - b2) * torch.square(g.float()),
            state["v"], grads)
        bc1 = 1 - b1 ** step.float()
        bc2 = 1 - b2 ** step.float()

        def upd(p, m_, v_):
            u = (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
            if weight_decay:
                u = u + weight_decay * p.float()
            return (p.float() - eta * u).to(p.dtype)

        new_params = tree_map(upd, params, m, v)
        return new_params, {"step": step, "m": m, "v": v}

    return Optimizer(init=init, update=_ranged("AdamW", update),
                     name="adamw")


def _ranged(name: str, update: Callable) -> Callable:
    """``update`` without grad, in a profiler range "<name> update"."""
    def ranged(grads, state, params):
        with torch.no_grad(), record_function(f"{name} update"):
            return update(grads, state, params)
    return ranged


def _clip(grads, clip: float):
    """Scale the whole tree to global norm ``clip`` (f32, as the JAX
    package's f32 factor promotes a bf16 gradient)."""
    if not clip:
        return grads
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                        for g in tree_leaves(grads)))
    scale = torch.clamp(clip / torch.clamp(gn, min=1e-12), max=1.0)
    return tree_map(lambda g: g.float() * scale, grads)
