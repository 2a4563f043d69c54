"""Hand-written Hopper (sm_90a) kernels for the port's hot spots.

Each kernel package ships:
* ``csrc/*.cu`` — the CUDA C++ source with a plain C interface, built by
  ``nvcc`` at first use (``_build.py``) and loaded with ``ctypes``
* ``kernel.py`` — the ctypes binding (one launch on the current stream)
* ``ops.py``    — the public wrapper: validates, launches on CUDA tensors,
  takes the plain version for CPU tensors, counts launches
* ``ref.py``    — the plain PyTorch version of the same function
"""
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_attention_bshd)
from repro_torch.kernels.rmsnorm.ops import rmsnorm
from repro_torch.kernels.ssd_chunk.ops import ssd_chunk, ssd_chunk_bshp
from repro_torch.kernels.zoo_dual_matmul.ops import (
    zoo_dual_matmul, zoo_dual_matmul_stacked)

__all__ = ["flash_attention", "flash_attention_bshd", "rmsnorm",
           "ssd_chunk", "ssd_chunk_bshp", "zoo_dual_matmul",
           "zoo_dual_matmul_stacked"]
