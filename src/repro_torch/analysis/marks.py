"""Graph boundary anchors: the marks the certifier keys on.

The AST taint pass (``repro_torch.analysis.boundary``) trusts source-level
``@tags`` annotations; the graph certifier (``repro_torch.analysis.ifc``)
proves the party boundary on the program PyTorch actually runs, traced
into an FX graph by ``make_fx``. For that it needs anchors in the graph:
nodes that mark where a value legally crosses the wire, where DP noise is
applied, and which values are first-order cotangents of server
parameters.

Outside the certifier's trace every mark returns its operand object
itself (``mark(x) is x``): no op, no launch, no host read, so every
launch count, captured graph and bitwise guarantee of the port is
untouched. Inside the trace (:func:`tracing`, entered by the certifier
through :func:`trace_context`) each mark dispatches a
``torch.library.custom_op`` (``repro_torch::wire_boundary``,
``::dp_noise``, ``::grad_mark``) that records one node carrying the
mark's attributes. Each op has a fake implementation, an identity
backward and a vmap rule, and is called through an autograd Function
with ``setup_context``, so the mark composes with ``torch.autograd.grad``
(the engine's ``_value_and_grad``), ``torch.func.grad_and_value`` (the
Split-Learning step) and ``torch.func.vmap`` (the ZOO lane fan-out).

Anchors
-------
* :func:`wire_boundary` — the value crosses the party boundary here.
  ``kind`` names the payload (``"emb"``/``"loss"``/``"token"``, matching
  the wire plane's frame tags), ``direction`` is ``"up"`` (client ->
  server) or ``"down"`` (server -> client). Emitted by
  ``Transport.downlink`` (the ONE legal loss downlink), the engine's
  client-lane fan-outs, and the serve plane's embed/token hops.
* :func:`dp_noise` — the operand has just been Gaussian-noised by a
  configured ``GaussianLossChannel`` (inside ``Transport.downlink``,
  between the noise add and the wire mark: IF303).
* :func:`grad_mark` — the operand is (derived from) a first-order
  cotangent of server parameters, at the engine's server-FOO point and
  the declared-leaky baselines' gradient downlinks (IF301).
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Iterator, Tuple

import torch

from repro_torch.tree import tree_map

# Payload kinds a wire_boundary mark may carry. "emb" and "loss" mirror
# repro_torch.wire.codec.DATA_TAGS (training-plane frames); "token" is the
# serve plane's per-step token downlink (metered by
# Transport.account_serve, not framed by the wire codec).
WIRE_KINDS: Tuple[str, ...] = ("emb", "loss", "token")
DIRECTIONS: Tuple[str, ...] = ("up", "down")

_TRACING = contextvars.ContextVar("repro_torch_marks_tracing", default=False)


def tracing() -> bool:
    """True inside the certifier's trace (:func:`trace_context`)."""
    return _TRACING.get()


@contextlib.contextmanager
def trace_context() -> Iterator[None]:
    """Turn the marks (and the kernels' graph nodes) on for a trace."""
    token = _TRACING.set(True)
    try:
        yield
    finally:
        _TRACING.reset(token)


_CARD_ROUTE = contextvars.ContextVar("repro_torch_card_route",
                                     default=False)


def on_card(x) -> bool:
    """True for a CUDA tensor, and for any tensor inside
    :func:`card_route`: the models and the kernels' wrappers take the
    kernel route (under :func:`trace_context`, the custom-op nodes) where
    this holds."""
    return x.is_cuda or _CARD_ROUTE.get()


@contextlib.contextmanager
def card_route() -> Iterator[None]:
    """Route CPU tensors as CUDA ones: the dry run's fake tensors live on
    the CPU (a CPU build of torch refuses to index a ``cuda`` tensor, a
    fake one too) and stand for the card's. Only with
    :func:`trace_context` and fake tensors: a real CPU tensor on this
    route would reach a CUDA launch."""
    token = _CARD_ROUTE.set(True)
    try:
        yield
    finally:
        _CARD_ROUTE.reset(token)


# ------------------------------------------------------------- the ops ----

@torch.library.custom_op("repro_torch::wire_boundary", mutates_args=())
def _wire_boundary_op(x: torch.Tensor, kind: str,
                      direction: str) -> torch.Tensor:
    return x.clone()


@torch.library.custom_op("repro_torch::dp_noise", mutates_args=())
def _dp_noise_op(x: torch.Tensor) -> torch.Tensor:
    return x.clone()


@torch.library.custom_op("repro_torch::grad_mark", mutates_args=())
def _grad_mark_op(x: torch.Tensor) -> torch.Tensor:
    return x.clone()


def _register(op, n_attrs: int) -> None:
    """Fake implementation, identity backward and vmap rule of a mark."""
    op.register_fake(lambda x, *attrs: torch.empty_like(x))
    op.register_autograd(lambda ctx, g: (g,) + (None,) * n_attrs,
                         setup_context=lambda ctx, inputs, output: None)
    op.register_vmap(lambda info, in_dims, x, *attrs:
                     (op(x, *attrs), in_dims[0]))


_register(_wire_boundary_op, 2)
_register(_dp_noise_op, 0)
_register(_grad_mark_op, 0)


class _Mark(torch.autograd.Function):
    """A mark op under autograd and the ``torch.func`` transforms (a
    custom op's own autograd registration does not compose with
    ``torch.func.grad``): forward is the op, backward the identity."""

    @staticmethod
    def forward(op, x, *attrs):
        return op(x, *attrs)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.n_attrs = len(inputs) - 2

    @staticmethod
    def backward(ctx, g):
        return (None, g) + (None,) * ctx.n_attrs

    @staticmethod
    def vmap(info, in_dims, op, x, *attrs):
        return _Mark.apply(op, x, *attrs), in_dims[1]


def _mark(x: Any, op, *attrs) -> Any:
    if not tracing():
        return x
    return tree_map(lambda leaf: _Mark.apply(op, leaf, *attrs), x)


# ------------------------------------------------------------- anchors ----

def wire_boundary(x: Any, *, kind: str, direction: str) -> Any:
    """Mark ``x`` (a tensor or a tree) as crossing the party boundary."""
    if kind not in WIRE_KINDS:
        raise ValueError(f"unknown wire kind {kind!r}; expected {WIRE_KINDS}")
    if direction not in DIRECTIONS:
        raise ValueError(
            f"unknown direction {direction!r}; expected {DIRECTIONS}")
    return _mark(x, _wire_boundary_op, kind, direction)


def dp_noise(x: Any) -> Any:
    """Mark ``x`` as the output of a configured DP noise channel."""
    return _mark(x, _dp_noise_op)


def grad_mark(x: Any) -> Any:
    """Mark ``x`` as derived from server-parameter cotangents."""
    return _mark(x, _grad_mark_op)
