"""Public wrapper: the CUDA kernels for CUDA tensors, the plain version
(``ref.py``) for CPU tensors.

A CUDA tensor always goes to a kernel or raises: there is no fallback
when ``nvcc`` or the library is missing. :func:`route` picks the kernel:
the one-pass vector kernel wherever it can take the call, else the
general one. ``launches`` counts kernel launches and ``route_launches``
the same launches by route (the CPU path launches nothing and counts
nothing), so a run can show that its main path went through the vector
kernel.

Training: when grad mode is on and x or scale requires grad, the call
goes through :class:`RMSNormFn`, whose forward is the same kernel launch
and whose backward is autograd through the plain version (``ref.py``),
recomputed from the saved x and scale (``kernels/_plain_grad.py``), the
function the JAX package differentiates. Backward kernels are later work
(ROADMAP.md, Queue 1 item 3(b)). With grad off the call launches the
kernel and nothing else.

Inside the certifier's trace (``repro_torch.analysis.marks.tracing()``)
a CUDA call launches through the ``repro_torch::rmsnorm`` custom op,
whose implementation is the same launch: one graph node a launch."""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch

from repro_torch.analysis import marks
from repro_torch.kernels._plain_grad import needs_grad, plain_backward
from repro_torch.kernels.rmsnorm import kernel
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

KERNEL_DTYPES = (torch.float32, torch.bfloat16)
VEC_BYTES = 16          # the vector kernel's loads and stores
MAX_VECTOR_D = 8192     # the vector kernel keeps a row in registers
MAX_VECS = 8            # 16-byte vectors a thread keeps
MAX_THREADS = 1024
MIN_ROW_THREADS = 128   # a block's threads for rows of fewer vectors

launches: Dict[str, int] = {"rmsnorm": 0}
route_launches: Dict[str, int] = {"vector": 0, "general": 0}


def reset_launches() -> None:
    for counts in (launches, route_launches):
        for name in counts:
            counts[name] = 0


def _validate(x, scale) -> bool:
    """Check a call; True for CUDA tensors, False for CPU."""
    if x.ndim != 2 or scale.ndim != 1 or scale.shape[0] != x.shape[1]:
        raise ValueError(f"expected x (M, d) and scale (d,); got "
                         f"{tuple(x.shape)}, {tuple(scale.shape)}")
    if x.numel() == 0:
        raise ValueError(f"empty operand: x {tuple(x.shape)}")
    if x.dtype not in KERNEL_DTYPES:
        raise ValueError(f"x dtype {x.dtype} not in {KERNEL_DTYPES}")
    if scale.dtype != torch.float32:
        raise ValueError(f"scale must be float32, got {scale.dtype}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("x and scale must be contiguous")
    device = x.device
    if device != scale.device:
        raise ValueError(f"operands on several devices: {device}, "
                         f"{scale.device}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return marks.on_card(x)


def route(x, scale=None) -> str:
    """The kernel a contiguous (M, d) x takes: ``"vector"`` where its rows
    split into 16-byte vectors (d a multiple of 16 bytes of x's type), x
    (and scale, where given) lies at a 16-byte-aligned address and
    d <= MAX_VECTOR_D; else ``"general"``. The wrapper's y comes from the
    allocator and is aligned."""
    d = x.shape[-1]
    if d > MAX_VECTOR_D or d * x.element_size() % VEC_BYTES:
        return "general"
    if x.data_ptr() % VEC_BYTES or (scale is not None
                                    and scale.data_ptr() % VEC_BYTES):
        return "general"
    return "vector"


@functools.lru_cache(maxsize=None)
def vector_shape(d: int, element_size: int,
                 few_rows: bool = False) -> Tuple[int, int, int]:
    """(threads a row, vectors a thread, rows a block) of the vector
    kernel for rows of d elements. Where the call has rows enough to share
    the SMs (prefill), device memory bounds it: the most vectors a thread
    that leave no thread idle with at least MIN_ROW_THREADS threads a row
    (d = 3072 bf16: 128 x 3; d = 2560: 160 x 2). With ``few_rows`` (fewer
    rows than the card has SMs: decode), each row's latency bounds it: the
    fewest vectors a thread that leave no thread idle (384 x 1 and
    320 x 1). Where no shape leaves every thread working, the fewest idle
    vector slots. Rows of fewer threads share a block of MIN_ROW_THREADS."""
    nvec = d * element_size // VEC_BYTES
    shapes = []
    for k in range(1, MAX_VECS + 1):
        threads = 32 * -(-nvec // (32 * k))      # whole warps
        idle = threads * k - nvec
        if threads <= MAX_THREADS:
            order = k if few_rows else -k
            shapes.append(((idle > 0, threads < MIN_ROW_THREADS, idle,
                            order), threads, k))
    _, threads, k = min(shapes)
    return threads, k, max(1, MIN_ROW_THREADS // threads)


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    props = torch.cuda.get_device_properties(device_index)
    return props.multi_processor_count


def launch_shape(x) -> Tuple[int, int, int]:
    """The vector kernel's launch shape for a CUDA x (M, d)."""
    M, d = x.shape
    return vector_shape(d, x.element_size(),
                        M < _sm_count(x.device.index))


def rmsnorm(x, scale, *, eps: float = 1e-6):
    """Fused RMSNorm over the last dim of a (M, d) tensor: x (M, d) in f32
    or bf16, scale (d,) f32 -> (M, d) in x's dtype, f32 math."""
    if not _validate(x, scale):
        return rmsnorm_ref(x, scale, eps)
    if needs_grad(x, scale):
        return RMSNormFn.apply(x, scale, eps)
    return _call(x, scale, eps)


def _launch(x, scale, eps: float):
    way = route(x, scale)
    y = torch.empty_like(x)
    if way == "vector":
        kernel.launch(x, scale, y, eps, way, launch_shape(x))
    else:
        kernel.launch(x, scale, y, eps, way)
    launches["rmsnorm"] += 1
    route_launches[way] += 1
    return y


@torch.library.custom_op("repro_torch::rmsnorm", mutates_args=())
def _rmsnorm_node(x: torch.Tensor, scale: torch.Tensor,
                  eps: float) -> torch.Tensor:
    return _launch(x, scale, eps)


@_rmsnorm_node.register_fake
def _(x, scale, eps):
    return torch.empty_like(x)


def _call(x, scale, eps: float):
    """Launch on the card: one graph node under the certifier's trace."""
    if marks.tracing():
        return _rmsnorm_node(x, scale, float(eps))
    return _launch(x, scale, eps)


class RMSNormFn(torch.autograd.Function):
    """The kernel's forward; the backward differentiates the plain version
    recomputed from the saved x and scale."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _call(x, scale, eps)

    @staticmethod
    def backward(ctx, grad_y):
        eps = ctx.eps
        return plain_backward("RMSNorm", lambda x, s: rmsnorm_ref(x, s, eps),
                              ctx.saved_tensors, ctx.needs_input_grad[:2],
                              (grad_y,)) + (None,)
