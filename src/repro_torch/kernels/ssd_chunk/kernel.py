"""ctypes binding of the CUDA kernel in ``csrc/ssd_chunk.cu``.

One launch covers every (batch, head) pair. The library is built and
loaded at the first launch, never at import. Callers go through
``ops.py``, which validates shapes, dtypes, devices and contiguity before
a pointer is taken here."""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _launcher():
    fn = _build.load("ssd_chunk").ssd_chunk_launch
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i32, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
                   i32, i32, i32, i32, i32, i32, ptr]
    fn.restype = i32
    return fn


def launch(xh, a, dt, bm, cm, state0, y, state_out, chunk: int) -> None:
    """xh (B, S, H, P), a/dt (B, S, H) f32, bm/cm (B, S, N), state0 (B, H,
    P, N) f32 or None -> writes y (B, S, H, P) and, unless ``state_out`` is
    None, the final state (B, H, P, N) on the current stream. Raises if the
    launch is refused."""
    B, S, H, P = xh.shape
    N = bm.shape[-1]
    with torch.cuda.device(xh.device):
        stream = torch.cuda.current_stream(xh.device).cuda_stream
        err = _launcher()(
            _DTYPE_CODES[xh.dtype], _DTYPE_CODES[y.dtype], xh.data_ptr(),
            a.data_ptr(), dt.data_ptr(), bm.data_ptr(), cm.data_ptr(),
            None if state0 is None else state0.data_ptr(), y.data_ptr(),
            None if state_out is None else state_out.data_ptr(),
            B, S, H, P, N, int(chunk), stream)
    if err != 0:
        raise RuntimeError(
            f"ssd_chunk kernel launch failed with CUDA error {err} (B={B}, "
            f"S={S}, H={H}, P={P}, N={N}, chunk={chunk}, dtype={xh.dtype})")
