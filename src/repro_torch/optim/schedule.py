"""Learning-rate schedules: fn(step) -> lr, a 0-dim float32 tensor on the
step's device (the step is the optimizer state's 0-dim int32 clock), in
the JAX package's f32 arithmetic."""
from __future__ import annotations

import math

import torch


def _f32(value, step: torch.Tensor) -> torch.Tensor:
    return torch.full((), value, dtype=torch.float32, device=step.device)


def constant(lr: float):
    return lambda step: _f32(lr, step)


def cosine(lr: float, total_steps: int, final_frac: float = 0.1):
    def fn(step):
        t = torch.clamp(step / max(total_steps, 1), 0.0, 1.0)
        return _f32(lr, step) * (final_frac + (1 - final_frac)
                                 * 0.5 * (1 + torch.cos(math.pi * t)))
    return fn


def warmup_cosine(lr: float, warmup: int, total_steps: int,
                  final_frac: float = 0.1):
    cos = cosine(lr, max(total_steps - warmup, 1), final_frac)

    def fn(step):
        warm = _f32(lr, step) * torch.clamp(step / max(warmup, 1), 0.0, 1.0)
        return torch.where(step < warmup, warm, cos(step - warmup))
    return fn


def inv_sqrt(lr: float, warmup: int = 100):
    """η = lr/√t — the paper's Corollary IV.10 choice (η = 1/√T)."""
    def fn(step):
        t = torch.clamp(step.float(), min=1.0)
        return _f32(lr, step) * torch.minimum(t / warmup,
                                              torch.sqrt(warmup / t))
    return fn


def make_schedule(name: str, lr: float, *, warmup: int = 0,
                  total_steps: int = 0):
    if name == "constant":
        return constant(lr)
    if name == "cosine":
        return warmup_cosine(lr, warmup, total_steps) if warmup else \
            cosine(lr, total_steps)
    if name == "inv_sqrt":
        return inv_sqrt(lr, max(warmup, 1))
    raise ValueError(f"unknown schedule {name!r}")
