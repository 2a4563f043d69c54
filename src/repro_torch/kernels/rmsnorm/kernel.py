"""ctypes binding of the CUDA kernels in ``csrc/rmsnorm.cu``.

One launch covers all M rows. The library is built and loaded at the
first launch, never at import. Callers go through ``ops.py``, which
validates shapes, dtypes, devices and contiguity and picks the route and
launch shape before a pointer is taken here."""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the C function's routes: the general kernel, and the one-pass vector
# kernel (x loaded with the streaming hint, ld.global.cs)
ROUTE_CODES = {"general": 0, "vector": 1}


@functools.cache
def _launcher():
    """The library, built and loaded at first use, with its C functions'
    signatures set."""
    lib = _build.load("rmsnorm")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.rmsnorm_launch.argtypes = [i32, i32, ptr, ptr, ptr, i32, i32,
                                   ctypes.c_float, i32, i32, i32, ptr]
    lib.rmsnorm_occupancy.argtypes = [i32, i32, i32, i32, i32,
                                      ctypes.POINTER(i32)]
    lib.rmsnorm_empty_launch.argtypes = [i32, i32, ptr]
    for fn in (lib.rmsnorm_launch, lib.rmsnorm_occupancy,
               lib.rmsnorm_empty_launch):
        fn.restype = i32
    return lib


def launch(x, scale, y, eps: float, route: str,
           shape: tuple = (0, 0, 0)) -> None:
    """x (M, d), scale (d,) f32 -> writes y (M, d) on torch's current
    stream of x's device, through ``route`` with ``shape`` = (threads a
    row, vectors a thread, rows a block) for the vector route. Raises if
    the launch is refused."""
    fn = _launcher().rmsnorm_launch
    M, d = x.shape
    dev = x.device.index
    args = (_DTYPE_CODES[x.dtype], ROUTE_CODES[route], x.data_ptr(),
            scale.data_ptr(), y.data_ptr(), M, d, eps, *shape)
    if dev == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(dev))
    else:
        with torch.cuda.device(dev):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError(
            f"rmsnorm kernel launch failed with CUDA error {err} "
            f"(route {route}, M={M}, d={d}, dtype={x.dtype}, "
            f"launch shape {shape})")


def occupancy(dtype, d: int, shape: tuple) -> int:
    """Resident blocks an SM of the vector kernel at ``shape``."""
    blocks = ctypes.c_int(0)
    err = _launcher().rmsnorm_occupancy(
        _DTYPE_CODES[dtype], d, *shape, ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"rmsnorm occupancy query failed with CUDA error "
                           f"{err} (d={d}, shape {shape})")
    return blocks.value


def launch_empty(blocks: int, threads: int) -> None:
    """The library's empty kernel on the current stream: the launch floor
    that a decode-sized call is timed against. Not counted as a launch."""
    err = _launcher().rmsnorm_empty_launch(
        blocks, threads, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"empty kernel launch failed with CUDA error {err}")
