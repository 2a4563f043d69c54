"""Zeroth-order optimization primitives (paper §III-B-1, Eq. 2/3).

Two-point stochastic gradient estimator over a parameter tree:

    ∇̂ f = φ(d)/μ · [f(w + μu) − f(w)] · u,     u ~ p

* p = N(0, I)                    → φ(d) = 1
* p = U(S(0,1)) unit sphere      → φ(d) = d

Beyond-paper extensions, as in the JAX package:
* ``n_queries`` q-point averaging (variance ∝ 1/q),
* a row mask that perturbs only the rows a batch touches (d shrinks to
  the touched rows),
* vectorized fan-out: all q directions are stacked leaves and the loss
  runs over the (1+q) lanes at once; the unrolled per-query path survives
  behind ``unrolled=True`` as the numerical test oracle.

Randomness is injected: every function takes ``raw``, a tree of N(0, 1)
leaves shaped like ``tree``'s with leading dims prepended (q lanes, and
for the engine a block-row axis before them), from a draw source
(:mod:`repro_torch.core.draws`). Masking, the effective dimension and the
sphere normalisation happen here.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.partition import (tree_dim, tree_leaves, tree_map,
                                        tree_unflatten)


def phi_factor(dist: str, d):
    if dist == "normal":
        return 1.0
    if dist == "sphere":
        return d
    raise ValueError(f"unknown ZOO distribution {dist!r}")


def _trail(t: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """Sum of squares of ``t`` over the leaf's own (trailing) dims (a sum
    over those dims, not over a flattened view: DTensor cannot flatten a
    leaf sharded past its first dim)."""
    lead = t.ndim - leaf.ndim
    if not leaf.ndim:
        return torch.square(t)
    return torch.square(t).sum(dim=tuple(range(lead, t.ndim)))


def sample_direction(raw, tree, dist: str = "sphere",
                     row_mask: Optional[dict] = None):
    """Turn raw N(0, 1) draws into u ~ p matching ``tree``'s structure.

    ``raw`` leaves are shaped (*lead, *leaf.shape); every index of the
    leading dims is one direction. row_mask: optional tree matching
    ``tree``, each leaf a 0/1 mask over the leaf's first axis, shaped
    (*mask_lead, rows) with mask_lead broadcastable to the leading dims.
    Returns (u_tree, effective_dim): the dim is a float without a mask,
    else a tensor over the mask's leading dims."""
    u = raw
    if row_mask is not None:
        u = tree_map(
            lambda uu, leaf, m: uu * m.reshape(m.shape + (1,) * (leaf.ndim - 1)),
            u, tree, row_mask)
        d_eff = sum(m.sum(-1) * (leaf.numel() // leaf.shape[0])
                    for leaf, m in zip(tree_leaves(tree),
                                       tree_leaves(row_mask)))
    else:
        d_eff = float(tree_dim(tree))

    if dist == "sphere":
        sq = sum(_trail(x, leaf)
                 for x, leaf in zip(tree_leaves(u), tree_leaves(tree)))
        inv = torch.rsqrt(torch.clamp(sq, min=1e-30))
        u = tree_map(lambda x, leaf: x * inv.reshape(inv.shape
                                                     + (1,) * leaf.ndim),
                     u, tree)
    return u, d_eff


def sample_directions(raw, tree, n_queries: int, dist: str = "sphere",
                      row_mask: Optional[dict] = None):
    """All q directions at once as stacked leaves.

    ``raw`` leaves are (*batch, q, *leaf.shape). Returns (u_stack, d_eff):
    ``u_stack`` has ``raw``'s shapes; ``d_eff`` is a float32 tensor of
    shape (*batch, q), all entries of a row equal."""
    if n_queries < 1:
        raise ValueError(f"n_queries must be >= 1, got {n_queries} "
                         "(q=0 would silently zero the ZOO gradient)")
    first_raw, first = tree_leaves(raw)[0], tree_leaves(tree)[0]
    lead = tuple(first_raw.shape[:first_raw.ndim - first.ndim])
    if not lead or lead[-1] != n_queries:
        raise ValueError(f"raw draws have leading dims {lead}, expected "
                         f"(..., {n_queries})")
    u_stack, d_eff = sample_direction(raw, tree, dist, row_mask)
    if isinstance(d_eff, torch.Tensor):
        d_eff = d_eff.to(torch.float32)
    else:
        # a fill on the device, not a host-to-device copy: a captured
        # round (a CUDA graph) cannot copy from pageable host memory
        d_eff = torch.full((), d_eff, dtype=torch.float32,
                           device=first_raw.device)
    return u_stack, torch.broadcast_to(d_eff, lead)


def stack_lanes(tree, u_stack, mu: float, batch_dims: int = 0):
    """(1+q)-lane parameter stack: lane 0 clean, lanes 1..q = w + μ·u_i.
    The lane axis sits after ``batch_dims`` leading batch dims."""
    def one(w, u):
        wf = w.float().unsqueeze(batch_dims)
        return torch.cat([wf, wf + mu * u], dim=batch_dims).to(w.dtype)
    return tree_map(one, tree, u_stack)


def grad_from_losses(u_stack, losses_pert, loss_clean, mu: float, phi):
    """Vectorized Eq. 3 with q-point averaging: losses_pert (*batch, q),
    loss_clean (*batch); the per-lane coefficients contract against the
    stacked directions (*batch, q, *leaf)."""
    q = losses_pert.shape[-1]
    coefs = ((phi / mu) * (losses_pert - loss_clean.unsqueeze(-1))
             / q).float()

    def one(u):
        c = coefs.reshape(coefs.shape + (1,) * (u.ndim - coefs.ndim))
        return (c * u).sum(dim=coefs.ndim - 1)
    return tree_map(one, u_stack)


def perturb(tree, u, mu: float):
    return tree_map(lambda w, uu: (w.float() + mu * uu).to(w.dtype), tree, u)


def two_point_grad(u, h_hat, h, mu: float, phi) -> dict:
    """Eq. 3: ∇̂ = φ/μ (ĥ − h) u — built client-side from the two losses."""
    coef = (phi / mu) * (h_hat - h)
    return tree_map(lambda uu: coef * uu, u)


def zoo_gradient(raw, loss_fn, tree, mu: float, dist: str = "sphere",
                 n_queries: int = 1, row_mask=None, unrolled: bool = False,
                 loss_transform=None):
    """Full ZOO gradient of ``loss_fn(tree)`` with q-point averaging.

    ``raw``: tree of (q, *leaf) N(0, 1) draws. The default path evaluates
    the loss over the clean lane plus all q perturbation lanes in one
    batched (``torch.func.vmap``) call; ``unrolled=True`` keeps the
    per-query loop as a test oracle (identical draws).

    ``loss_transform``, when given, is applied to the stacked ``(1+q,)``
    loss vector before the estimator consumes it — the hook the engine
    routes through ``Transport.downlink``. Stacked path only.

    Returns (grad_tree, loss_clean, aux). loss_fn must return a scalar
    (or (scalar, aux))."""
    def eval_loss(t):
        out = loss_fn(t)
        return out if isinstance(out, tuple) else (out, None)

    if unrolled:
        if loss_transform is not None:
            raise ValueError(
                "loss_transform requires the stacked lane path "
                "(unrolled=False); the per-query loop is a test oracle")
        loss_clean, aux = eval_loss(tree)
        grads = []
        for i in range(n_queries):
            u, d_eff = sample_direction(tree_map(lambda r: r[i], raw), tree,
                                        dist, row_mask)
            phi = phi_factor(dist, d_eff)
            loss_pert, _ = eval_loss(perturb(tree, u, mu))
            grads.append(two_point_grad(u, loss_pert, loss_clean, mu, phi))
        grad = tree_map(lambda *gs: sum(gs) / float(n_queries), *grads)
        return grad, loss_clean, aux

    u_stack, d_eff = sample_directions(raw, tree, n_queries, dist, row_mask)
    phi = phi_factor(dist, d_eff)                              # (q,) | 1.0
    lanes = stack_lanes(tree, u_stack, mu)
    leaves = tree_leaves(lanes)

    def lane_loss(*lane_leaves):
        out = loss_fn(tree_unflatten(tree, list(lane_leaves)))
        return out if isinstance(out, tuple) else (out, {})

    losses, auxes = torch.func.vmap(lane_loss)(*leaves)       # (1+q,)
    if loss_transform is not None:
        losses = loss_transform(losses)
    aux = None if auxes == {} else tree_map(lambda a: a[0], auxes)
    grad = grad_from_losses(u_stack, losses[1:], losses[0], mu, phi)
    return grad, losses[0], aux


def embedding_row_mask(tokens, vocab: int):
    """0/1 mask of vocabulary rows present in the batch (active-row mode)."""
    mask = torch.zeros((vocab,), dtype=torch.float32, device=tokens.device)
    mask.index_fill_(0, tokens.reshape(-1).long(), 1.0)
    return mask
