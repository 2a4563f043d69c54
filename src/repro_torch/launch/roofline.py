"""Roofline terms of the dry run, per device, from the H100's spec sheet.

The JAX package's ``launch/roofline.py`` reads a TPU v5e's terms off
XLA's compiled artifact. The port's dry run (``launch/dryrun.py``) runs
the step eagerly on fake tensors instead, and :class:`StepCounter` counts
what one rank runs: every local aten op, every kernel's custom-op node
and every collective DTensor issues. Per device:

    compute_s    = flops / PEAK_FLOPS
    memory_s     = bytes_accessed / HBM_BW
    collective_s = Σ_axis collective_bytes[axis] / link rate of the axis

``bytes_accessed`` is the sum, over the non-view ops the rank runs, of
the bytes of the tensors each reads and writes: an eager upper bound that
assumes no fusion (the JAX package's is XLA's count after fusion). Fake
tensors keep bf16, so no legalization correction applies (the JAX
package halves its CPU-lowered byte counts).

None of the rates below is measured: they are the H100 SXM's spec-sheet
figures, and each term is spec-peak arithmetic, not a measurement.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch
from torch.distributed.tensor import DTensor
from torch.utils.flop_counter import flop_registry, register_flop_formula

from repro_torch.utils.comms import CommRecorder

# NVIDIA H100 SXM5 datasheet: 989.4 TFLOP/s dense BF16 tensor-core peak
# (1,979 with sparsity), 3.35 TB/s HBM3
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
# NVLink 4: 900 GB/s bidirectional per GPU, 450 GB/s a direction, between
# the 8 GPUs of one HGX H100 node (NVSwitch)
NVLINK_BW = 450e9
# across nodes: one 400 Gb/s ConnectX-7 NIC per GPU (the DGX H100 layout),
# 50 GB/s a direction
NIC_BW = 50e9
GPUS_PER_NODE = 8


def axis_bandwidth(mesh_shape: Dict[str, int], axis: str) -> float:
    """The link rate of one mesh axis: NVLink where the axis's group fits
    in one 8-GPU node (the minor axes, in row-major rank order), else one
    NIC a GPU."""
    names = list(mesh_shape)
    if axis not in mesh_shape:
        return NIC_BW
    span = math.prod(mesh_shape[n] for n in names[names.index(axis):])
    return NVLINK_BW if span <= GPUS_PER_NODE else NIC_BW


@dataclasses.dataclass
class Roofline:
    flops: float                   # per-device FLOPs
    bytes_accessed: float          # per-device bytes read + written
    coll_bytes: float              # per-device collective bytes
    coll_by_kind: Dict[str, int]
    n_devices: int
    model_flops: float             # analytic 6·N·D (or 2·N·D inference)
    coll_by_axis: Dict[str, int] = dataclasses.field(default_factory=dict)
    mesh_shape: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def compute_s(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.bytes_accessed / HBM_BW

    @property
    def collective_s(self) -> float:
        if not self.coll_by_axis:
            return self.coll_bytes / NIC_BW
        return sum(b / axis_bandwidth(self.mesh_shape, a)
                   for a, b in self.coll_by_axis.items())

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline lower bound on step latency (the three terms
        perfectly overlapped: the largest)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / total counted FLOPs: remat and dispatch waste."""
        total = self.flops * self.n_devices
        return self.model_flops / total if total else 0.0

    @property
    def mfu(self) -> float:
        """Model FLOPs utilisation at the roofline bound."""
        t = self.step_time_s
        if t <= 0:
            return 0.0
        return self.model_flops / (t * self.n_devices * PEAK_FLOPS)

    def as_dict(self) -> dict:
        return {
            "flops_per_dev": self.flops,
            "bytes_per_dev": self.bytes_accessed,
            "coll_bytes_per_dev": self.coll_bytes,
            "coll_by_kind": dict(self.coll_by_kind),
            "coll_by_axis": dict(self.coll_by_axis),
            "n_devices": self.n_devices,
            "model_flops": self.model_flops,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "step_time_s": self.step_time_s,
            "useful_flops_ratio": self.useful_flops_ratio,
            "mfu": self.mfu,
        }


def model_flops_for(cfg, shape, *, backward: bool) -> float:
    """Analytic MODEL_FLOPS: 6·N_active·tokens (train) / 2·N_active·tokens
    (inference); decode processes 1 token per sequence."""
    n_active = cfg.active_param_count()
    if shape.is_decode:
        tokens = shape.global_batch
    else:
        tokens = shape.global_batch * shape.seq_len
    mult = 6.0 if backward else 2.0
    return mult * n_active * tokens


# ----------------------------------------------------- kernels' FLOPs ---

def attention_pairs(sq: int, skv: int, causal: bool, window: int,
                    q_offset: int) -> int:
    """The (query, key) pairs the flash kernel's masks leave: query row i
    at position q_offset + i sees keys up to it (causal) and, with a
    window, the last ``window`` of them."""
    total = 0
    for i in range(sq):
        hi = min(skv, q_offset + i + 1) if causal else skv
        lo = max(0, q_offset + i + 1 - window) if window else 0
        total += max(hi - lo, 0)
    return total


def flash_flops(q_shape, k_shape, v_shape, causal, window, q_offset) -> int:
    """QKᵀ and PV over the unmasked pairs: 2·B·Hq·pairs·(d + d_v)."""
    B, Sq, Hq, d = q_shape
    pairs = attention_pairs(Sq, k_shape[1], causal, window, q_offset)
    return 2 * B * Hq * pairs * (d + v_shape[3])


def rmsnorm_flops(x_shape) -> int:
    """x², the row sum, x·r and ·scale: 4 an element."""
    return 4 * math.prod(x_shape)


def ssd_flops(xh_shape, bm_shape, chunk: int) -> int:
    """The chunked scan's products for each (batch, chunk) of length Q:
    CBᵀ once (B and C are shared by the heads, 2Q²N), and per head the
    masked (CBᵀ)X (2Q²P), the chunk state BᵀX and the inter-chunk output
    C·state (2QNP each)."""
    B, S, H, P = xh_shape
    N = bm_shape[-1]
    Q = min(chunk, S)
    n_chunks = S // Q
    return B * n_chunks * (2 * Q * Q * N + H * (2 * Q * Q * P
                                                 + 4 * Q * N * P))


def _register_kernel_formulas() -> None:
    """FLOP formulas for the kernels' custom-op nodes, so that
    ``FlopCounterMode`` and :class:`StepCounter` count their work."""
    ops = torch.ops.repro_torch

    @register_flop_formula(ops.flash_attention)
    def _(q, k, v, causal, window, q_offset, *a, out_shape=None, **kw):
        return flash_flops(q, k, v, causal, window, q_offset)

    @register_flop_formula(ops.rmsnorm)
    def _(x, scale, eps, *a, out_shape=None, **kw):
        return rmsnorm_flops(x)

    @register_flop_formula(ops.ssd_chunk)
    def _(xh, a_, dt, bm, cm, state0, chunk, *a, out_shape=None, **kw):
        return ssd_flops(xh, bm, chunk)

    @register_flop_formula(ops.ssd_chunk_flat)
    def _(xh, a_, dt, bm, cm, chunk, *a, out_shape=None, **kw):
        return ssd_flops((xh[0], xh[1], 1, xh[2]), bm, chunk)


def _ensure_formulas() -> None:
    # the custom ops exist once the kernels' wrappers are imported
    import repro_torch.kernels.flash_attention.ops  # noqa: F401
    import repro_torch.kernels.rmsnorm.ops  # noqa: F401
    import repro_torch.kernels.ssd_chunk.ops  # noqa: F401
    if torch.ops.repro_torch.flash_attention not in flop_registry:
        _register_kernel_formulas()


class StepCounter(CommRecorder):
    """What one rank runs in a step: its FLOPs (the registered formulas of
    ``torch.utils.flop_counter``, the kernels' included, on local
    shapes), its bytes read and written (every non-view op's tensor
    operands and results), and its collectives (:class:`CommRecorder`). ``fake`` is the fake mode the
    step's tensors come from: only ops that make its tensors are counted
    (another mode's fake tensors are DTensor's shape propagation, real
    ones its host-side layout arithmetic and the few small tensors the
    step makes from Python values before they meet a DTensor)."""

    def __init__(self, mesh, fake):
        super().__init__(mesh)
        self.fake = fake
        _ensure_formulas()
        self.flops = 0
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is NotImplemented or any(t == DTensor for t in types):
            return out
        packet = getattr(func, "_overloadpacket", None)
        if packet is None or packet.__name__ in ("wait_tensor",):
            return out
        outs = [t for t in torch.utils._pytree.tree_leaves(out)
                if isinstance(t, torch.Tensor)]
        if not any(getattr(t, "fake_mode", None) is self.fake for t in outs):
            # not the step's tensors: DTensor's sharding propagation runs
            # an op once on global shapes in a fake mode of its own, and
            # its layout arithmetic (index tensors) on real host tensors
            return out
        if packet in flop_registry:
            self.flops += flop_registry[packet](
                *args, **(kwargs or {}), out_val=out)
        if not func.is_view:
            ins = [t for t in torch.utils._pytree.tree_leaves(
                (args, kwargs or {})) if isinstance(t, torch.Tensor)]
            self.bytes += sum(t.numel() * t.element_size()
                              for t in ins + outs)
        return out
