"""The backward of the port's forward kernels: autograd through their plain
versions.

The JAX package has no backward kernel: its training differentiates the
plain functions (``jax.grad`` through ``mha_chunked``, ``apply_norm`` and
``_ssd_chunked``), never a Pallas kernel. So each kernel wrapper, when an
operand on the card requires grad and grad mode is on, runs its forward
kernel inside a ``torch.autograd.Function`` whose backward recomputes the
plain version from the saved inputs and differentiates it. Hand-written
backward kernels are later work (ROADMAP.md, Queue 1 item 3(b)).
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch
from torch.profiler import record_function


def needs_grad(*tensors) -> bool:
    """True when grad mode is on and any given tensor requires grad."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def plain_backward(name: str, plain: Callable, inputs: Sequence,
                   needs: Sequence[bool], grad_outputs: Sequence) -> Tuple:
    """Gradients of ``plain(*inputs)`` (a tensor or a tuple of tensors)
    against ``grad_outputs``, for the inputs whose ``needs`` is True
    (None for the rest and for inputs that are None). Outputs whose
    gradient is None (unused downstream) are left out. The work runs in
    a profiler range "plain backward (<name>)"."""
    with torch.enable_grad(), record_function(f"plain backward ({name})"):
        xs = [None if x is None else x.detach().requires_grad_(bool(n))
              for x, n in zip(inputs, needs)]
        outs = plain(*xs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, g) for o, g in zip(outs, grad_outputs) if g is not None]
        wanted = [x for x, n in zip(xs, needs) if n and x is not None]
        grads = iter(torch.autograd.grad(
            [o for o, _ in pairs], wanted, [g for _, g in pairs],
            allow_unused=True) if pairs and wanted else ())
    return tuple(next(grads, None) if n and x is not None else None
                 for x, n in zip(xs, needs))
