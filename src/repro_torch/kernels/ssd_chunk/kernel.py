"""ctypes binding of the CUDA kernels in ``csrc/ssd_chunk.cu``.

One launch covers every (batch, head) pair: float32 inputs on the CUDA
cores, bfloat16 inputs on the tensor cores (the library picks the kernels
by type). The library is built and loaded at the first launch, never at
import. Callers go through ``ops.py``, which validates shapes, dtypes,
devices and contiguity before a pointer is taken here."""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _launcher():
    """The built library, its functions' argument and result types set."""
    lib = _build.load("ssd_chunk")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ssd_chunk_launch.argtypes = ([i32, i32] + [ptr] * 9
                                     + [i64] + [i32] * 6 + [ptr])
    lib.ssd_chunk_scratch_bytes.argtypes = [i32] * 5
    lib.ssd_chunk_scratch_bytes.restype = i64
    lib.ssd_chunk_occupancy.argtypes = [i32] * 5 + [ctypes.POINTER(i32)]
    for fn in (lib.ssd_chunk_launch, lib.ssd_chunk_occupancy):
        fn.restype = i32
    return lib


def scratch_bytes(dtype, B: int, S: int, H: int, chunk: int) -> int:
    """Bytes of device scratch one launch needs, as the library counts
    them: none for float32 inputs; for bfloat16 inputs the pre-pass's
    C.B^T per (batch, chunk) and its vectors per (batch, head, chunk)."""
    return int(_launcher().ssd_chunk_scratch_bytes(_DTYPE_CODES[dtype], B,
                                                   S, H, chunk))


def occupancy(dtype, B: int, H: int, chunk: int,
              out_dtype=torch.float32) -> dict:
    """The scan kernel's launch shape for a call, without launching: grid,
    threads and dynamic shared memory a block, and resident blocks an SM
    (CUDA's occupancy calculator)."""
    out = (ctypes.c_int * 4)()
    err = _launcher().ssd_chunk_occupancy(_DTYPE_CODES[dtype],
                                          _DTYPE_CODES[out_dtype], B, H,
                                          chunk, out)
    if err != 0:
        raise RuntimeError(f"ssd_chunk occupancy query failed with CUDA "
                           f"error {err}")
    return dict(zip(("grid", "threads", "smem_bytes", "blocks_per_sm"), out))


def launch(xh, a, dt, bm, cm, state0, y, state_out, scratch,
           chunk: int) -> None:
    """xh (B, S, H, P), a/dt (B, S, H) f32, bm/cm (B, S, N), state0 (B, H,
    P, N) f32 or None, scratch a uint8 tensor of at least
    :func:`scratch_bytes` bytes (None when that is 0) -> writes y (B, S,
    H, P) and, unless ``state_out`` is None, the final state (B, H, P, N)
    on the current stream. Raises if the launch is refused."""
    B, S, H, P = xh.shape
    N = bm.shape[-1]
    with torch.cuda.device(xh.device):
        stream = torch.cuda.current_stream(xh.device).cuda_stream
        err = _launcher().ssd_chunk_launch(
            _DTYPE_CODES[xh.dtype], _DTYPE_CODES[y.dtype], xh.data_ptr(),
            a.data_ptr(), dt.data_ptr(), bm.data_ptr(), cm.data_ptr(),
            None if state0 is None else state0.data_ptr(), y.data_ptr(),
            None if state_out is None else state_out.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            0 if scratch is None else scratch.numel(),
            B, S, H, P, N, int(chunk), stream)
    if err != 0:
        raise RuntimeError(
            f"ssd_chunk kernel launch failed with CUDA error {err} (B={B}, "
            f"S={S}, H={H}, P={P}, N={N}, chunk={chunk}, dtype={xh.dtype})")
