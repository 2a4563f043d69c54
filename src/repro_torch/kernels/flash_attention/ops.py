"""Public wrappers: the CUDA kernel for CUDA tensors, the plain version
(``ref.py``) for CPU tensors.

Each dtype has one route on the card: float32 goes to the CUDA-core
kernel (f32 FMA, to hold the plain version to 1e-4), bfloat16 to the
tensor-core kernel (wgmma fed by TMA), which needs 16-byte-aligned
operands; a bf16 CUDA tensor it cannot take raises, it never goes
elsewhere.

A CUDA tensor always goes to the kernel or raises: there is no fallback
when ``nvcc`` or the library is missing. ``launches`` counts kernel
launches (the CPU path launches nothing and counts nothing), so a run can
show that its main path went through the kernel.

Training: when grad mode is on and q, k or v requires grad, the call goes
through :class:`FlashAttentionFn`, whose forward is the same kernel launch
and whose backward is autograd through the plain version (``ref.py``),
recomputed from the saved q, k and v (``kernels/_plain_grad.py``): the
JAX package differentiates its plain attention too. Backward kernels are
later work (ROADMAP.md, Queue 1 item 3(b)). With grad off the call
launches the kernel and nothing else.

Inside the certifier's trace (``repro_torch.analysis.marks.tracing()``)
a CUDA call launches through the ``repro_torch::flash_attention`` custom
op, whose implementation is the same launch: one graph node a launch."""
from __future__ import annotations

from typing import Dict

import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.analysis import marks
from repro_torch.kernels._plain_grad import needs_grad, plain_backward
from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ref import flash_attention_bshd_ref

KERNEL_DTYPES = (torch.float32, torch.bfloat16)
# the (d_qk, d_v) head-dim pairs the kernel instantiates: one head dim for
# q, k and v in multiples of 16 up to 128, and MLA's (192, 128)
HEAD_DIMS = frozenset({(d, d) for d in range(16, 129, 16)} | {(192, 128)})

launches: Dict[str, int] = {"flash_attention": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _validate(q, k, v, window: int, q_offset: int) -> bool:
    """Check a model-layout call; True for CUDA tensors, False for CPU."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(
            f"expected q (B, Sq, Hq, d), k (B, Skv, Hkv, d), v (B, Skv, "
            f"Hkv, d_v); got {tuple(q.shape)}, {tuple(k.shape)}, "
            f"{tuple(v.shape)}")
    B, Sq, Hq, d = q.shape
    _, Skv, Hkv, _ = k.shape
    d_v = v.shape[3]
    if min(B, Sq, Hq, d, d_v, Skv, Hkv) < 1:
        raise ValueError(f"empty operand: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if (tuple(v.shape[:3]) != tuple(k.shape[:3]) or k.shape[0] != B
            or k.shape[3] != d):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if Hq % Hkv:
        raise ValueError(f"query heads {Hq} are not a multiple of KV "
                         f"heads {Hkv}")
    if (d, d_v) not in HEAD_DIMS:
        raise ValueError(
            f"head dims (q/k {d}, v {d_v}): the kernel takes one head dim in "
            f"multiples of 16 up to 128, or the pair (192, 128)")
    if window < 0 or q_offset < 0:
        raise ValueError(f"window {window} and q_offset {q_offset} must be "
                         ">= 0")
    if q.dtype not in KERNEL_DTYPES:
        raise ValueError(f"q dtype {q.dtype} not in {KERNEL_DTYPES}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"k and v must share q's dtype {q.dtype}, got "
                         f"{k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    devices = {q.device, k.device, v.device}
    if len(devices) != 1:
        raise ValueError(
            f"operands on several devices: {sorted(map(str, devices))}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    if not marks.on_card(q):
        return False
    if q.dtype == torch.float32 and (Sq + 63) // 64 > 65535:
        raise ValueError(f"grid too large for the f32 kernel: Sq={Sq}")
    if q.dtype == torch.bfloat16:
        check_tma_alignment(q, k, v)
    return True


def check_tma_alignment(q, k, v) -> None:
    """The tensor-core route reads q, k and v through TMA, which needs
    16-byte-aligned base addresses (the strides are multiples of 32 bytes
    for every head dim the kernel takes). Raises for any that is not; a
    fake tensor (the dry run's: shapes, no storage) has no address to
    check and is passed."""
    misaligned = [name for name, t in (("q", q), ("k", k), ("v", v))
                  if not is_fake(t) and t.data_ptr() % 16]
    if misaligned:
        raise ValueError(
            f"the bf16 tensor-core kernel reads through TMA and needs "
            f"16-byte-aligned operands; {', '.join(misaligned)} are not")


def flash_attention_bshd(q, k, v, *, causal: bool = True, window: int = 0,
                         q_offset: int = 0):
    """Attention in the model's layout: q (B, Sq, Hq, d), k (B, Skv, Hkv,
    d), v (B, Skv, Hkv, d_v) -> (B, Sq, Hq, d_v), scale d^-1/2 (q's head
    dim: MLA's v head dim 128 differs from its q/k head dim 192, and the
    scale never takes v's). GQA reads KV head h // (Hq / Hkv) in place;
    query row i sits at position ``q_offset`` + i for the causal and
    sliding-window masks (the chunked-prefill form)."""
    if not _validate(q, k, v, window, q_offset):
        return flash_attention_bshd_ref(q, k, v, causal=causal,
                                        window=window, q_offset=q_offset)
    if needs_grad(q, k, v):
        return FlashAttentionFn.apply(q, k, v, causal, window, q_offset)
    return _call(q, k, v, causal, window, q_offset)


def _launch(q, k, v, causal, window, q_offset):
    o = q.new_empty(q.shape[:3] + v.shape[3:])
    kernel.launch(q, k, v, o, causal=causal, window=window,
                  q_offset=q_offset)
    launches["flash_attention"] += 1
    return o


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_node(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool, window: int, q_offset: int) -> torch.Tensor:
    return _launch(q, k, v, causal, window, q_offset)


@_flash_node.register_fake
def _(q, k, v, causal, window, q_offset):
    return q.new_empty(q.shape[:3] + v.shape[3:])


def _call(q, k, v, causal, window, q_offset):
    """Launch on the card: one graph node under the certifier's trace."""
    if marks.tracing():
        return _flash_node(q, k, v, bool(causal), int(window), int(q_offset))
    return _launch(q, k, v, causal, window, q_offset)


class FlashAttentionFn(torch.autograd.Function):
    """The kernel's forward; the backward differentiates the plain version
    recomputed from the saved q, k and v (one materialized score tensor
    (B, Hq, Sq, Skv) f32 a call)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        ctx.save_for_backward(q, k, v)
        ctx.mask = (causal, window, q_offset)
        return _call(q, k, v, causal, window, q_offset)

    @staticmethod
    def backward(ctx, grad_o):
        causal, window, q_offset = ctx.mask

        def plain(q, k, v):
            return flash_attention_bshd_ref(q, k, v, causal=causal,
                                            window=window, q_offset=q_offset)
        return plain_backward("flash attention", plain, ctx.saved_tensors,
                              ctx.needs_input_grad[:3], (grad_o,)) + (
                                  None, None, None)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0):
    """The TPU kernel's layout: q (BH, Sq, d), k/v (BH, Skv, d), heads
    pre-flattened -> (BH, Sq, d). One launch, as the Hq = Hkv = 1 case of
    :func:`flash_attention_bshd`."""
    if q.ndim != 3 or k.ndim != 3 or v.ndim != 3:
        raise ValueError(f"expected (BH, S, d) operands; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    return flash_attention_bshd(
        q.unsqueeze(2), k.unsqueeze(2), v.unsqueeze(2), causal=causal,
        window=window, q_offset=q_offset).squeeze(2)
