"""ctypes binding of the CUDA kernels in ``csrc/flash_attention.cu``: the
f32 kernel on the CUDA cores (dtype code 0) and the bf16 kernel on the
tensor cores (dtype code 1), behind one C function.

One launch covers every batch row, query head and query tile. The library
is built and loaded at the first launch, never at import. Callers go
through ``ops.py``, which validates shapes, dtypes, devices, contiguity
and (for bf16) alignment before a pointer is taken here."""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _launcher():
    fn = _build.load("flash_attention").flash_attention_launch
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i32, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32,
                   i32, i32, i32, i32, ctypes.c_float, ptr]
    fn.restype = i32
    return fn


def launch(q, k, v, o, *, causal: bool, window: int, q_offset: int) -> None:
    """q (B, Sq, Hq, d), k (B, Skv, Hkv, d), v (B, Skv, Hkv, d_v) -> writes
    o (B, Sq, Hq, d_v) on the current stream, scale d^-1/2. Raises if the
    launch is refused."""
    B, Sq, Hq, d = q.shape
    Skv, Hkv, d_v = k.shape[1], k.shape[2], v.shape[3]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _launcher()(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), B, Hq, Hkv, Sq, Skv, d, d_v, int(causal),
            int(window), int(q_offset), float(d ** -0.5), stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed with CUDA error {err} "
            f"(B={B}, Sq={Sq}, Skv={Skv}, Hq={Hq}, Hkv={Hkv}, d={d}, "
            f"d_v={d_v}, dtype={q.dtype})")
