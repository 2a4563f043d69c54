"""Public wrappers: the CUDA kernel for CUDA tensors, the plain version
(``ref.py``) for CPU tensors.

A CUDA tensor always goes to the kernel or raises: there is no fallback
when ``nvcc`` or the library is missing. ``launches`` counts kernel
launches (the CPU path launches nothing and counts nothing), so a run can
show that its main path went through the kernel.

Training: when grad mode is on and an operand requires grad, the call
goes through :class:`SSDChunkFn`, whose forward is the same kernel launch
and whose backward is autograd through the plain chunked form
(``ref.py::ssd_chunked_ref``, the JAX package's ``_ssd_chunked``, which
it differentiates) at the same chunk, recomputed from the saved inputs
(``kernels/_plain_grad.py``). Backward kernels are later work (ROADMAP.md,
Queue 1 item 3(b)). With grad off the call launches the kernel and
nothing else.

Inside the certifier's trace (``repro_torch.analysis.marks.tracing()``)
a CUDA call launches through a custom op (``repro_torch::ssd_chunk``,
``repro_torch::ssd_chunk_flat`` for the TPU contract's entry point) whose
implementation is the same launch: one graph node a launch."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.analysis import marks
from repro_torch.kernels._plain_grad import needs_grad, plain_backward
from repro_torch.kernels.ssd_chunk import kernel
from repro_torch.kernels.ssd_chunk.ref import (ssd_chunk_ref,
                                               ssd_chunked_ref,
                                               ssd_states_ref)

KERNEL_DTYPES = (torch.float32, torch.bfloat16)
MAX_CHUNK = 128
MAX_PN = 64          # the largest head dim P and state size N

launches: Dict[str, int] = {"ssd_chunk": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _scratch(xh, B: int, S: int, H: int, chunk: int):
    """The launch's device scratch (uint8), as many bytes as the library
    asks for, or None when it needs none."""
    n = kernel.scratch_bytes(xh.dtype, B, S, H, chunk)
    return torch.empty(n, dtype=torch.uint8, device=xh.device) if n else None


def _validate(xh, a, dt, bm, cm, chunk: int, state0) -> bool:
    """Check a model-layout call; True for CUDA tensors, False for CPU."""
    if xh.ndim != 4 or a.ndim != 3 or dt.ndim != 3 or bm.ndim != 3 \
            or cm.ndim != 3:
        raise ValueError(
            f"expected xh (B, S, H, P), a/dt (B, S, H), bm/cm (B, S, N); got "
            f"{tuple(xh.shape)}, {tuple(a.shape)}, {tuple(dt.shape)}, "
            f"{tuple(bm.shape)}, {tuple(cm.shape)}")
    B, S, H, P = xh.shape
    N = bm.shape[-1]
    if min(B, S, H, P, N) < 1:
        raise ValueError(f"empty operand: xh {tuple(xh.shape)}, bm "
                         f"{tuple(bm.shape)}")
    if (tuple(a.shape) != (B, S, H) or tuple(dt.shape) != (B, S, H)
            or tuple(bm.shape) != (B, S, N) or tuple(cm.shape) != (B, S, N)):
        raise ValueError(
            f"shape mismatch: xh {tuple(xh.shape)}, a {tuple(a.shape)}, dt "
            f"{tuple(dt.shape)}, bm {tuple(bm.shape)}, cm {tuple(cm.shape)}")
    if state0 is not None and tuple(state0.shape) != (B, H, P, N):
        raise ValueError(f"state0 {tuple(state0.shape)}, want "
                         f"{(B, H, P, N)}")
    if P > MAX_PN or N > MAX_PN:
        raise ValueError(f"head dim {P} and state {N}: the kernel takes up "
                         f"to {MAX_PN}")
    if not 1 <= chunk <= MAX_CHUNK or S % chunk:
        raise ValueError(f"chunk {chunk} must lie in [1, {MAX_CHUNK}] and "
                         f"divide S = {S}")
    if xh.dtype not in KERNEL_DTYPES:
        raise ValueError(f"xh dtype {xh.dtype} not in {KERNEL_DTYPES}")
    if bm.dtype != xh.dtype or cm.dtype != xh.dtype:
        raise ValueError(f"bm and cm must share xh's dtype {xh.dtype}, got "
                         f"{bm.dtype}, {cm.dtype}")
    floats = [a, dt] + ([] if state0 is None else [state0])
    if any(t.dtype != torch.float32 for t in floats):
        raise ValueError("a, dt and state0 must be float32")
    operands = [xh, bm, cm] + floats
    if not all(t.is_contiguous() for t in operands):
        raise ValueError("every operand must be contiguous")
    devices = {t.device for t in operands}
    if len(devices) != 1:
        raise ValueError(
            f"operands on several devices: {sorted(map(str, devices))}")
    if xh.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {xh.device}")
    return marks.on_card(xh)


def ssd_chunk_bshp(xh, a, dt, bm, cm, *, chunk: int, state0=None):
    """The SSD scan in the model's layout: xh (B, S, H, P) f32/bf16, a/dt
    (B, S, H) f32, bm/cm (B, S, N) in xh's dtype and shared by the heads,
    state0 (B, H, P, N) f32 or None (zeros) -> (y (B, S, H, P) f32, final
    state (B, H, P, N) f32). ``chunk`` is taken as min(chunk, S) and must
    divide S."""
    chunk = min(chunk, xh.shape[1]) if xh.ndim == 4 else chunk
    if not _validate(xh, a, dt, bm, cm, chunk, state0):
        return ssd_states_ref(xh, a, dt, bm, cm, state0)
    if needs_grad(xh, a, dt, bm, cm, state0):
        return SSDChunkFn.apply(xh, a, dt, bm, cm, state0, chunk)
    return _call(xh, a, dt, bm, cm, state0, chunk)


def _launch(xh, a, dt, bm, cm, state0, chunk: int):
    B, S, H, P = xh.shape
    y = torch.empty((B, S, H, P), dtype=torch.float32, device=xh.device)
    state = torch.empty((B, H, P, bm.shape[-1]), dtype=torch.float32,
                        device=xh.device)
    kernel.launch(xh, a, dt, bm, cm, state0, y, state,
                  _scratch(xh, B, S, H, chunk), chunk)
    launches["ssd_chunk"] += 1
    return y, state


def _launch_flat(xh, a, dt, bm, cm, chunk: int):
    """The TPU contract's launch: y (BH, S, P) in xh's dtype, no state."""
    y = torch.empty_like(xh)
    kernel.launch(xh.unsqueeze(2), a.unsqueeze(2), dt.unsqueeze(2), bm, cm,
                  None, y, None,
                  _scratch(xh, xh.shape[0], xh.shape[1], 1, chunk), chunk)
    launches["ssd_chunk"] += 1
    return y


@torch.library.custom_op("repro_torch::ssd_chunk", mutates_args=())
def _ssd_node(xh: torch.Tensor, a: torch.Tensor, dt: torch.Tensor,
              bm: torch.Tensor, cm: torch.Tensor,
              state0: Optional[torch.Tensor],
              chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    return _launch(xh, a, dt, bm, cm, state0, chunk)


@_ssd_node.register_fake
def _(xh, a, dt, bm, cm, state0, chunk):
    B, S, H, P = xh.shape
    f32 = torch.float32
    return (xh.new_empty((B, S, H, P), dtype=f32),
            xh.new_empty((B, H, P, bm.shape[-1]), dtype=f32))


@torch.library.custom_op("repro_torch::ssd_chunk_flat", mutates_args=())
def _ssd_flat_node(xh: torch.Tensor, a: torch.Tensor, dt: torch.Tensor,
                   bm: torch.Tensor, cm: torch.Tensor,
                   chunk: int) -> torch.Tensor:
    return _launch_flat(xh, a, dt, bm, cm, chunk)


@_ssd_flat_node.register_fake
def _(xh, a, dt, bm, cm, chunk):
    return torch.empty_like(xh)


def _call(xh, a, dt, bm, cm, state0, chunk: int):
    """Launch on the card: one graph node under the certifier's trace."""
    if marks.tracing():
        return _ssd_node(xh, a, dt, bm, cm, state0, int(chunk))
    return _launch(xh, a, dt, bm, cm, state0, chunk)


def ssd_chunk(xh, a, dt, bm, cm, *, chunk: int = 128):
    """The TPU kernel's contract: xh (BH, S, P), a/dt (BH, S) f32, bm/cm
    (BH, S, N) (batch and heads pre-flattened, B/C broadcast by the caller)
    -> y (BH, S, P) in xh's dtype, from a zero state. One launch, as the
    H = 1 case of :func:`ssd_chunk_bshp` with no final state."""
    if xh.ndim != 3 or a.ndim != 2 or dt.ndim != 2:
        raise ValueError(f"expected xh (BH, S, P), a/dt (BH, S); got "
                         f"{tuple(xh.shape)}, {tuple(a.shape)}, "
                         f"{tuple(dt.shape)}")
    chunk = min(chunk, xh.shape[1])
    x4, a3, dt3 = xh.unsqueeze(2), a.unsqueeze(2), dt.unsqueeze(2)
    if not _validate(x4, a3, dt3, bm, cm, chunk, None):
        return ssd_chunk_ref(xh, a, dt, bm, cm)
    if needs_grad(xh, a, dt, bm, cm):
        y, _ = SSDChunkFn.apply(x4, a3, dt3, bm, cm, None, chunk)
        return y.squeeze(2).to(xh.dtype)
    if marks.tracing():
        return _ssd_flat_node(xh, a, dt, bm, cm, chunk)
    return _launch_flat(xh, a, dt, bm, cm, chunk)


class SSDChunkFn(torch.autograd.Function):
    """The kernel's forward -> (y f32, final state f32); the backward
    differentiates the plain chunked form at the same chunk, recomputed
    from the saved inputs."""

    @staticmethod
    def forward(ctx, xh, a, dt, bm, cm, state0, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(xh, a, dt, bm, cm, state0)
        ctx.chunk = chunk
        return _call(xh, a, dt, bm, cm, state0, chunk)

    @staticmethod
    def backward(ctx, grad_y, grad_state):
        chunk = ctx.chunk

        def plain(xh, a, dt, bm, cm, state0):
            return ssd_chunked_ref(xh, a, dt, bm, cm, chunk, state0)
        return plain_backward("SSD", plain, ctx.saved_tensors,
                              ctx.needs_input_grad[:6],
                              (grad_y, grad_state)) + (None,)
