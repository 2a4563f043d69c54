"""ctypes binding of the CUDA kernel in ``csrc/rmsnorm.cu``.

One launch covers all M rows. The library is built and loaded at the
first launch, never at import. Callers go through ``ops.py``, which
validates shapes, dtypes, devices and contiguity before a pointer is
taken here."""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _launcher():
    fn = _build.load("rmsnorm").rmsnorm_launch
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i32, ptr, ptr, ptr, i32, i32, ctypes.c_float, ptr]
    fn.restype = i32
    return fn


def launch(x, scale, y, eps: float) -> None:
    """x (M, d), scale (d,) f32 -> writes y (M, d) on the current stream.
    Raises if the launch is refused."""
    M, d = x.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _launcher()(_DTYPE_CODES[x.dtype], x.data_ptr(),
                          scale.data_ptr(), y.data_ptr(), M, d, float(eps),
                          stream)
    if err != 0:
        raise RuntimeError(
            f"rmsnorm kernel launch failed with CUDA error {err} "
            f"(M={M}, d={d}, dtype={x.dtype})")
