"""The paper's contribution: cascaded hybrid optimization (Alg. 1).

One train step =
  1. client forward, clean + perturbed:  c = F_m(w_m;x),  ĉ = F_m(w_m+μu;x)
  2. server losses  h = L(F_0(w_0, c), y),  ĥ = L(F_0(w_0, ĉ), y)
     (only c/ĉ go up the wire, only h/ĥ come down — the privacy ledger in
     ``repro_torch.core.privacy`` accounts for exactly these)
  3. client ZOO grad   ∇̂_{w_m} = φ(d_m)/μ (ĥ − h) u         (Eq. 3)
  4. server FOO grad   ∇_{w_0} = ∂[L + λg(w_0)]/∂w_0          (Eq. 4, local
     backprop — never transmitted)
  5. SGD updates on both partitions.

The server backward never differentiates through the client partition
(the client tree is detached, as the JAX package's ``stop_gradient`` on
the boundary), exactly matching the protocol: the server cannot form
∂L/∂w_m because it does not know F_m.

Ported from the JAX package's ``core/cascade.py``. A step is
``step(params, opt_state, batch, t, draws) -> (params, opt_state,
StepOutput)``: where the JAX step takes a key, the port's takes the step
index ``t`` and a draw source (:mod:`repro_torch.core.draws`) that
answers ``client_directions(t, tree, 1, q)``, ``server_directions(t, tree,
q)`` and ``noise(t, 1, n)``. The server's gradient is
``torch.autograd.grad`` of the clean lane's loss over the server leaves;
the q perturbed lanes run under ``torch.no_grad()``, one forward each,
since the model's CUDA kernels cannot be ``vmap``-ed (the JAX package's
comment: the gradient flows from the clean lane only).
"""
from __future__ import annotations

import dataclasses
import functools
import operator
from typing import Callable, Tuple

import torch

from repro_torch.configs.base import VFLConfig
from repro_torch.core import zoo
from repro_torch.core.methods import canonical_method
from repro_torch.core.partition import merge_params, split_params
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class StepOutput:
    loss: torch.Tensor
    loss_perturbed: torch.Tensor
    grad_client_norm: torch.Tensor
    grad_server_norm: torch.Tensor


def _maybe_row_mask(cfg_vfl: VFLConfig, client, batch, vocab: int):
    """Active-row perturbation mask tree for the embedding table."""
    if not cfg_vfl.active_rows_only:
        return None
    mask_tree = tree_map(
        lambda w: torch.ones((w.shape[0],), dtype=torch.float32,
                             device=w.device), client)
    if "embed" in client and "tokens" in batch:
        m = zoo.embedding_row_mask(batch["tokens"], vocab)
        mask_tree = dict(mask_tree)
        mask_tree["embed"] = {"table": m}
    return mask_tree


def _value_and_grad(loss_fn: Callable, params, batch, wrt):
    """(loss, grad tree of ``params[k]`` for k in ``wrt``): the loss of
    ``params`` with the leaves under ``wrt`` made differentiable and every
    other leaf left as it is. A leaf the loss does not reach gets a zero
    gradient, as ``jax.grad`` gives."""
    part = {k: params[k] for k in wrt}
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(part)]
    live = dict(params)
    live.update(tree_unflatten(part, leaves))
    with torch.enable_grad():
        loss = loss_fn(live, batch)[0]
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten(part, grads)


def _direction_draws(draws, t: int, client, q: int):
    """The (q, *leaf) raw N(0, 1) client draws of step t."""
    return tree_map(lambda r: r[0], draws.client_directions(t, client, 1, q))


def make_cascaded_step(loss_fn: Callable, client_keys: Tuple[str, ...],
                       vfl: VFLConfig, optimizer,
                       vocab: int = 0, transport=None) -> Callable:
    """Build the cascaded hybrid step.

    loss_fn(params, batch) -> (loss, aux).  optimizer: repro_torch.optim
    object with ``init(params)`` / ``update(grads, state, params)`` /
    ``place(grads, params)``. Returns step(params, opt_state, batch, t,
    draws) -> (params, opt_state, StepOutput). Each gradient tree is
    placed once (``optimizer.place``: on a mesh, each gradient reduced to
    its parameter's placement); the logged norms and the update both read
    the placed trees.

    ``transport`` (a ``repro_torch.federation.Transport``) optionally
    noises the scalar losses the CLIENT receives over the downlink before
    it forms its ZOO gradient (Eq. 3); the server's FOO step keeps the
    exact local loss — only the wire is perturbed, matching the async
    engine. Its N(0, 1) draws are ``draws.noise(t, 1, 1 + q)``.
    """
    if transport is not None and transport.noise is not None \
            and not vfl.fused_dual:
        raise ValueError(
            "the DP loss channel requires the fused lane path "
            "(vfl.fused_dual=True); the unrolled per-query loop is a "
            "noise-free numerical test oracle")
    q = vfl.zoo_queries

    def step(params, opt_state, batch, t, draws):
        client, server = split_params(params, client_keys)
        client = tree_map(torch.Tensor.detach, client)    # stop_gradient
        row_mask = _maybe_row_mask(vfl, client, batch, vocab)
        raw = _direction_draws(draws, t, client, q)

        def lane_loss(c):
            return loss_fn(merge_params(c, server), batch)[0]

        if vfl.fused_dual:
            # ---- default path: ALL q directions drawn as stacked leaves;
            # lane 0 is the clean client, lanes 1..q the perturbed ones.
            # The server's gradient comes from the clean lane alone; the
            # perturbed lanes only need their losses.
            u_stack, d_eff = zoo.sample_directions(
                raw, client, q, vfl.zoo_dist, row_mask)
            phi = zoo.phi_factor(vfl.zoo_dist, d_eff)
            lanes = zoo.stack_lanes(client, u_stack, vfl.mu)
            clean = tree_map(lambda w: w[0], lanes)
            loss_clean, g_server = _value_and_grad(
                loss_fn, merge_params(clean, server), batch, server.keys())
            with torch.no_grad():
                pert = [lane_loss(tree_map(lambda w: w[i], lanes))
                        for i in range(1, q + 1)]
            losses = torch.stack([loss_clean] + pert)
            # the client builds Eq. 3 from the losses it RECEIVES — under
            # a DP transport those are the clipped+noised downlink values
            if transport is None:
                recv = losses
            elif transport.noise is None:
                recv = transport.downlink(losses)
            else:
                recv = transport.downlink(losses, draws.noise(t, 1, q + 1)[0])
            g_client = zoo.grad_from_losses(u_stack, recv[1:], recv[0],
                                            vfl.mu, phi)
            loss_pert = losses[1]
        else:
            # ---- unrolled oracle (test-only): per-query directions and
            # passes, kept as the numerical reference for the stacked path
            us, d_effs = zip(*[zoo.sample_direction(
                tree_map(lambda r: r[i], raw), client, vfl.zoo_dist,
                row_mask) for i in range(q)])
            phis = [zoo.phi_factor(vfl.zoo_dist, d) for d in d_effs]

            # server FOO (Eq. 4): exact backprop on w_0 only
            loss_clean, g_server = _value_and_grad(
                loss_fn, merge_params(client, server), batch, server.keys())
            with torch.no_grad():
                lps = [lane_loss(zoo.perturb(client, u, vfl.mu)) for u in us]

            # client ZOO (Eq. 2/3) from the raw losses: this branch is the
            # noise-free numerical reference and rejects DP transports
            gs = [zoo.two_point_grad(u, lp, loss_clean, vfl.mu, phi)
                  for u, lp, phi in zip(us, lps, phis)]
            g_client = tree_map(lambda *x: sum(x) / float(len(x)), *gs)
            loss_pert = lps[0]

        g_client = optimizer.place(g_client, client)
        g_server = optimizer.place(g_server, server)
        # ---- updates (separate lrs per party, paper §VI-A-d) -------------
        grads = merge_params(
            tree_map(lambda g: g * (vfl.lr_client / vfl.lr_server),
                     g_client),
            g_server)
        new_params, new_opt_state = optimizer.update(grads, opt_state, params)

        out = StepOutput(
            loss=loss_clean, loss_perturbed=loss_pert,
            grad_client_norm=_norm(g_client), grad_server_norm=_norm(g_server))
        return new_params, new_opt_state, out

    return step


def make_step_for_method(method: str, loss_fn, client_keys, vfl: VFLConfig,
                         optimizer, vocab: int = 0, transport=None):
    """Factory covering the paper's five frameworks at step granularity.

    cascaded      : ZOO client + FOO server   (ours)
    vafl / split  : FOO client + FOO server   (privacy-leaky upper bound)
    zoo-vfl / syn-zoo : ZOO client + ZOO server
    (sync-vs-async semantics live in repro_torch.core.async_engine;
    spellings normalize through repro_torch.core.methods so the modules
    agree).

    ``transport`` optionally carries the DP loss channel (cascaded only at
    step granularity; the other ZOO methods noise through the async
    engine)."""
    method = canonical_method(method)
    if transport is not None and transport.method != method:
        raise ValueError(f"transport method {transport.method!r} does not "
                         f"match step method {method!r}")
    if method == "cascaded":
        return make_cascaded_step(loss_fn, client_keys, vfl, optimizer,
                                  vocab, transport)
    if transport is not None and transport.noise is not None:
        raise NotImplementedError(
            f"the DP loss channel is wired into the cascaded step factory "
            f"and the async engine; for {method!r} run through "
            "Federation.run")
    if method in ("vafl", "split"):
        return make_foo_step(loss_fn, optimizer)
    assert method in ("zoo-vfl", "syn-zoo"), method
    return make_full_zoo_step(loss_fn, client_keys, vfl, optimizer, vocab)


def make_foo_step(loss_fn, optimizer):
    """First-order step on all parties (Split-Learning / VAFL). It draws
    nothing; ``t`` and ``draws`` are taken for the common signature."""
    def step(params, opt_state, batch, t, draws):
        loss, grads = _value_and_grad(loss_fn, params, batch, params.keys())
        grads = optimizer.place(grads, params)
        new_params, new_opt_state = optimizer.update(grads, opt_state, params)
        norm = _norm(grads)
        out = StepOutput(loss=loss, loss_perturbed=loss,
                         grad_client_norm=norm, grad_server_norm=norm)
        return new_params, new_opt_state, out
    return step


def _zoo_grad(raw, loss_of, tree, vfl: VFLConfig):
    """``zoo.zoo_gradient`` with the (1 + q) lanes evaluated one by one
    (the model's kernels cannot be ``vmap``-ed); ``zoo_unrolled_oracle``
    takes the per-query oracle. Returns (grad, clean loss)."""
    q = vfl.zoo_queries
    if vfl.zoo_unrolled_oracle:
        grad, loss, _ = zoo.zoo_gradient(raw, loss_of, tree, vfl.mu,
                                         vfl.zoo_dist, q, unrolled=True)
        return grad, loss
    u_stack, d_eff = zoo.sample_directions(raw, tree, q, vfl.zoo_dist)
    phi = zoo.phi_factor(vfl.zoo_dist, d_eff)
    lanes = zoo.stack_lanes(tree, u_stack, vfl.mu)
    losses = torch.stack([loss_of(tree_map(lambda w: w[i], lanes))
                          for i in range(q + 1)])
    return (zoo.grad_from_losses(u_stack, losses[1:], losses[0], vfl.mu,
                                 phi), losses[0])


def make_full_zoo_step(loss_fn, client_keys, vfl: VFLConfig, optimizer,
                       vocab: int = 0):
    """ZOO on both partitions (ZOO-VFL baseline [42]): the server also
    estimates its gradient with a two-point query on its own parameters,
    from ``draws.server_directions``."""
    q = vfl.zoo_queries

    @torch.no_grad()
    def step(params, opt_state, batch, t, draws):
        client, server = split_params(params, client_keys)
        raw_c = _direction_draws(draws, t, client, q)
        raw_s = draws.server_directions(t, server, q)

        def loss_of_client(c):
            return loss_fn(merge_params(c, server), batch)[0]

        def loss_of_server(s):
            return loss_fn(merge_params(client, s), batch)[0]

        g_client, loss_clean = _zoo_grad(raw_c, loss_of_client, client, vfl)
        g_server, _ = _zoo_grad(raw_s, loss_of_server, server, vfl)
        # drawn as the parameters are placed: placing moves nothing
        g_client = optimizer.place(g_client, client)
        g_server = optimizer.place(g_server, server)

        grads = merge_params(
            tree_map(lambda g: g * (vfl.lr_client / vfl.lr_server),
                     g_client),
            g_server)
        new_params, new_opt_state = optimizer.update(grads, opt_state, params)
        out = StepOutput(loss=loss_clean, loss_perturbed=loss_clean,
                         grad_client_norm=_norm(g_client),
                         grad_server_norm=_norm(g_server))
        return new_params, new_opt_state, out
    return step


def _norm(tree):
    """The f32 L2 norm of a gradient tree. Each leaf's squares are summed
    where the leaf lies, so a placed leaf (a DTensor sharded or
    replicated as its parameter) gives a partial or a local 0-dim sum;
    the sums are added with no 0 to start from (DTensor would reduce
    the first sum to add a number to it), and only their 0-dim total is
    reduced, by the square root. A leaf still ``Partial`` is reduced
    whole by its square: place the tree first (``Optimizer.place``)."""
    return torch.sqrt(functools.reduce(
        operator.add, (torch.sum(torch.square(x.float()))
                       for x in tree_leaves(tree))))
