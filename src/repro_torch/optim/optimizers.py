"""Functional optimizers over tensor trees (the JAX package's hand-rolled
ones, not ``torch.optim``, whose state layout and rounding differ).

The paper applies *vanilla SGD* to every framework ("To make a fair
comparison, we applied the vanilla SGD strategy to all VFL frameworks"),
so production configs default to SGD; AdamW is provided for ablations and
small-scale runs. State is a dict of trees with a 0-dim int32 ``step``;
moments are float32 whatever the params' dtype, and each update is
``(p.f32 − η·u).to(p.dtype)`` as in the JAX package. ``update`` returns
new trees and leaves its inputs untouched. ``η·u`` is formed in f32, as
the JAX package's jitted step computes it (XLA keeps the f32 of
``p.f32 − η·u`` and drops the bf16 rounding of a bf16 ``η·u`` that its
eager type promotion would insert); torch keeps bf16 against a 0-dim f32
tensor, so the port widens u explicitly. Each update runs in a profiler
range ("SGD update", "AdamW update").
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch.profiler import record_function

from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable      # params -> state
    update: Callable    # (grads, state, params) -> (new_params, new_state)
    name: str = "sgd"


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

    def update(grads, state, params):
        step = state["step"]
        eta = lr_fn(step)
        grads = _clip(grads, grad_clip)
        if weight_decay:
            grads = tree_map(lambda g, p: g.float() + weight_decay * p.float(),
                             grads, params)
        if momentum:
            mom = tree_map(lambda m, g: momentum * m + g.float(),
                           state["mom"], grads)
            upd = mom
            new_state = {"step": step + 1, "mom": mom}
        else:
            upd = grads
            new_state = {"step": step + 1}
        new_params = tree_map(
            lambda p, u: (p.float() - eta * u.float()).to(p.dtype),
            params, upd)
        return new_params, new_state

    return Optimizer(init=init, update=_ranged("SGD", update),
                     name="sgd")


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
