"""Parameter machinery: abstract param specs, init, and carrying weights
across from numpy.

A model is described by a tree of :class:`ParamSpec` leaves, the same
specs as the JAX package's, so both packages agree on every shape, dtype
and key path. Weights keep the ``(in, out)`` layout used as ``x @ w``;
weights from the JAX package load with :func:`params_from_numpy` and no
transposes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.partition import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    dtype: str = "bfloat16"
    logical: Tuple[Optional[str], ...] = ()
    init: str = "normal"          # normal | zeros | ones | scaled
    scale: float = 0.02

    def __post_init__(self):
        if len(self.logical) not in (0, len(self.shape)):
            raise ValueError(f"logical axes {self.logical} do not match "
                             f"shape {self.shape}")


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def materialize(tree, generator: torch.Generator, *,
                device=None, dtype_override: Optional[str] = None):
    """Concrete init, drawn from ``generator`` leaf by leaf in sorted-key
    order (it need not match the JAX package's threefry draws; tests that
    compare the two carry weights across with :func:`params_from_numpy`).
    The draws happen on the generator's device and land on ``device``."""
    def init_one(s: ParamSpec):
        dt = torch_dtype(dtype_override or s.dtype)
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=dt, device=device)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=dt, device=device)
        draw = torch.randn(s.shape, generator=generator,
                           device=generator.device, dtype=torch.float32)
        if s.init == "scaled":          # fan-in scaled
            fan_in = s.shape[0] if s.shape else 1
            draw = draw * (1.0 / math.sqrt(max(fan_in, 1)))
        else:
            draw = draw * s.scale
        return draw.to(device=device, dtype=dt)

    return tree_map(init_one, tree)


def param_count(tree) -> int:
    return int(sum(math.prod(s.shape) for s in tree_leaves(tree)))


def params_from_numpy(tree, device=None):
    """numpy (or any ``np.asarray``-able) leaves -> tensors on ``device``.
    bfloat16 arrays (ml_dtypes) cross as their 16-bit pattern."""
    def one(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a, copy=True))
        return t.to(device)
    return tree_map(one, tree)


def params_to_numpy(tree):
    """Tensors -> numpy arrays on the host (same dtype, same layout)."""
    def one(t):
        if t.dtype == torch.bfloat16:
            raise ValueError("numpy has no bfloat16; cast the tree to "
                             "float32 before params_to_numpy")
        return t.detach().cpu().numpy()
    return tree_map(one, tree)
