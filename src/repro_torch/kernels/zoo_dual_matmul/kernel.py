"""ctypes binding of the CUDA kernel in ``csrc/zoo_dual_matmul.cu``.

One launch covers the whole client block (R) and all q lanes, with or
without the bias+ReLU epilogue. The library is built and loaded at the
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
    fn = _build.load("zoo_dual_matmul").zoo_dual_matmul_launch
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i32, i32, ptr, ptr, ptr, ptr, ptr, ctypes.c_float,
                   ptr, ptr, i32, i32, i32, i32, i32, ptr]
    fn.restype = i32
    return fn


def launch(x, w, us, b, ub, mu: float, y, y_hat) -> None:
    """x (R, M, K), w (R, K, N), us (R, q, K, N), b (R, N) | None,
    ub (R, q, N) | None -> writes y (R, M, N) and y_hat (R, q, M, N) on the
    current stream. Raises if the launch is refused."""
    R, M, K = x.shape
    N = w.shape[-1]
    q = us.shape[1]
    epilogue = b is not None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _launcher()(
            _DTYPE_CODES[x.dtype], int(epilogue), x.data_ptr(), w.data_ptr(),
            us.data_ptr(), b.data_ptr() if epilogue else None,
            ub.data_ptr() if epilogue else None, float(mu), y.data_ptr(),
            y_hat.data_ptr(), R, M, K, N, q, stream)
    if err != 0:
        raise RuntimeError(
            f"zoo_dual_matmul kernel launch failed with CUDA error {err} "
            f"(R={R}, M={M}, K={K}, N={N}, q={q}, dtype={x.dtype})")
