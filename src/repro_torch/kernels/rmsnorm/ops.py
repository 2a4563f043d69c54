"""Public wrapper: the CUDA kernel for CUDA tensors, the plain version
(``ref.py``) for CPU tensors.

A CUDA tensor always goes to the kernel or raises: there is no fallback
when ``nvcc`` or the library is missing. ``launches`` counts kernel
launches (the CPU path launches nothing and counts nothing), so a run can
show that its main path went through the kernel."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels.rmsnorm import kernel
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

KERNEL_DTYPES = (torch.float32, torch.bfloat16)

launches: Dict[str, int] = {"rmsnorm": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _validate(x, scale) -> bool:
    """Check a call; True for CUDA tensors, False for CPU."""
    if x.ndim != 2 or scale.ndim != 1 or scale.shape[0] != x.shape[1]:
        raise ValueError(f"expected x (M, d) and scale (d,); got "
                         f"{tuple(x.shape)}, {tuple(scale.shape)}")
    if min(x.shape) < 1:
        raise ValueError(f"empty operand: x {tuple(x.shape)}")
    if x.dtype not in KERNEL_DTYPES:
        raise ValueError(f"x dtype {x.dtype} not in {KERNEL_DTYPES}")
    if scale.dtype != torch.float32:
        raise ValueError(f"scale must be float32, got {scale.dtype}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("x and scale must be contiguous")
    if x.device != scale.device:
        raise ValueError(f"operands on several devices: {x.device}, "
                         f"{scale.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type == "cuda"


def rmsnorm(x, scale, *, eps: float = 1e-6):
    """Fused RMSNorm over the last dim of a (M, d) tensor: x (M, d) in f32
    or bf16, scale (d,) f32 -> (M, d) in x's dtype, f32 math."""
    if not _validate(x, scale):
        return rmsnorm_ref(x, scale, eps)
    y = torch.empty_like(x)
    kernel.launch(x, scale, y, eps)
    launches["rmsnorm"] += 1
    return y
