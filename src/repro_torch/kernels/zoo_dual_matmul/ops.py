"""Public wrappers: the CUDA kernel for CUDA tensors, the plain version
(``ref.py``) for CPU tensors.

A CUDA tensor always goes to the kernel or raises: there is no fallback
when ``nvcc`` or the library is missing. ``launches`` counts kernel
launches per entry point (the CPU path launches nothing and counts
nothing), so a run can show that its main path went through the kernel.

The kernel computes the clients' zeroth-order lanes, which need no
gradient, and has no backward: a CUDA call with grad mode on and an
operand that requires grad raises rather than return an output that
would drop the gradient.

Inside the certifier's trace (``repro_torch.analysis.marks.tracing()``)
a CUDA call launches through a ``torch.library.custom_op`` of the entry
point's name (``repro_torch::zoo_dual_matmul_stacked_bias_relu``, ...)
whose implementation is the same launch, so each launch is one graph
node whose outputs depend on its inputs."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.analysis import marks
from repro_torch.kernels._plain_grad import needs_grad
from repro_torch.kernels.zoo_dual_matmul import kernel
from repro_torch.kernels.zoo_dual_matmul.ref import (
    zoo_dual_matmul_ref, zoo_dual_matmul_stacked_bias_relu_ref,
    zoo_dual_matmul_stacked_ref)

KERNEL_DTYPES = (torch.float32, torch.bfloat16)

launches: Dict[str, int] = {
    "zoo_dual_matmul": 0,
    "zoo_dual_matmul_stacked": 0,
    "zoo_dual_matmul_stacked_bias_relu": 0,
}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _validate(x, w, us, b, ub) -> bool:
    """Check a batched call (x (R,M,K), w (R,K,N), us (R,q,K,N), optional
    b (R,N) / ub (R,q,N)); returns True for CUDA tensors, False for CPU."""
    if x.ndim != 3 or w.ndim != 3 or us.ndim != 4:
        raise ValueError(
            f"expected x (R, M, K), w (R, K, N), us (R, q, K, N); got "
            f"{tuple(x.shape)}, {tuple(w.shape)}, {tuple(us.shape)}")
    R, M, K = x.shape
    N = w.shape[-1]
    q = us.shape[1]
    if min(R, M, K, N, q) < 1:
        raise ValueError(f"empty operand: R={R}, M={M}, K={K}, N={N}, q={q}")
    if tuple(w.shape) != (R, K, N) or tuple(us.shape) != (R, q, K, N):
        raise ValueError(
            f"shape mismatch: x {tuple(x.shape)}, w {tuple(w.shape)}, "
            f"us {tuple(us.shape)}")
    tensors = [x, w, us]
    if b is not None:
        if tuple(b.shape) != (R, N) or tuple(ub.shape) != (R, q, N):
            raise ValueError(
                f"epilogue shapes: b {tuple(b.shape)} (want {(R, N)}), "
                f"ub {tuple(ub.shape)} (want {(R, q, N)})")
        if b.dtype != torch.float32 or ub.dtype != torch.float32:
            raise ValueError(f"b and ub must be float32, got {b.dtype}, "
                             f"{ub.dtype}")
        tensors += [b, ub]
    if x.dtype not in KERNEL_DTYPES:
        raise ValueError(f"x dtype {x.dtype} not in {KERNEL_DTYPES}")
    if w.dtype != x.dtype or us.dtype != x.dtype:
        raise ValueError(f"w and us must share x's dtype {x.dtype}, got "
                         f"{w.dtype}, {us.dtype}")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("every operand must be contiguous")
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(
            f"operands on several devices: {sorted(map(str, devices))}")
    device = x.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    if device.type == "cuda" and (R > 65535 or (M + 7) // 8 > 65535):
        raise ValueError(f"grid too large for the kernel: R={R}, M={M}")
    return device.type == "cuda"


def _launch(name: str, x, w, us, b, ub, mu):
    if needs_grad(x, w, us, b, ub):
        raise ValueError(
            "the ZOO fan-out kernel has no backward (its lanes are the "
            "clients' zeroth-order queries); an operand requires grad: "
            "detach it or call under torch.no_grad()")
    R, M, _ = x.shape
    N, q = w.shape[-1], us.shape[1]
    y = torch.empty((R, M, N), dtype=x.dtype, device=x.device)
    y_hat = torch.empty((R, q, M, N), dtype=x.dtype, device=x.device)
    kernel.launch(x, w, us, b, ub, float(mu), y, y_hat)
    launches[name] += 1
    return y, y_hat


def _graph_node(name: str):
    """The entry point's launch as one custom op (the certifier's node)."""
    @torch.library.custom_op(f"repro_torch::{name}", mutates_args=())
    def node(x: torch.Tensor, w: torch.Tensor, us: torch.Tensor,
             b: Optional[torch.Tensor], ub: Optional[torch.Tensor],
             mu: float) -> Tuple[torch.Tensor, torch.Tensor]:
        return _launch(name, x, w, us, b, ub, mu)

    @node.register_fake
    def _(x, w, us, b, ub, mu):
        R, M, _ = x.shape
        N, q = w.shape[-1], us.shape[1]
        return x.new_empty((R, M, N)), x.new_empty((R, q, M, N))
    return node


_NODES = {name: _graph_node(name) for name in launches}


def _call(name: str, x, w, us, b, ub, mu):
    """Launch on the card: one graph node under the certifier's trace."""
    if marks.tracing():
        return _NODES[name](x, w, us, b, ub, float(mu))
    return _launch(name, x, w, us, b, ub, mu)


def zoo_dual_matmul(x, w, u, mu):
    """x (M, K), w/u (K, N) -> (y = xW, ŷ = x(W + μU)), both (M, N)."""
    if x.ndim != 2 or w.ndim != 2 or u.ndim != 2:
        raise ValueError(f"expected x (M, K), w (K, N), u (K, N); got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(u.shape)}")
    if tuple(u.shape) != tuple(w.shape):
        raise ValueError(f"u {tuple(u.shape)} must match w {tuple(w.shape)}")
    xb, wb, ubat = x[None], w[None], u[None, None]
    if not _validate(xb, wb, ubat, None, None):
        return zoo_dual_matmul_ref(x, w, u, mu)
    y, y_hat = _call("zoo_dual_matmul", xb, wb, ubat, None, None, mu)
    return y[0], y_hat[0, 0]


def zoo_dual_matmul_stacked(x, w, us, mu, *, b=None, ub=None):
    """y = xW ; ŷ_l = x(W + μU_l) for all q lanes, the xW product formed
    once and shared across lanes.

    Unbatched: x (M, K), w (K, N), us (q, K, N) -> (y (M, N), ŷ (q, M, N)).
    Batched over the client block: x (R, M, K), w (R, K, N),
    us (R, q, K, N) -> (y (R, M, N), ŷ (R, q, M, N)) in one launch.
    Passing ``b`` ((N,) or (R, N)) and ``ub`` ((q, N) or (R, q, N)), both
    float32, fuses the tabular client's bias+ReLU epilogue:
    (relu(xW + b), relu(x(W + μU_l) + b + μu_b_l))."""
    if (b is None) != (ub is None):
        raise ValueError("pass both b and ub for the fused epilogue, "
                         "or neither")
    batched = x.ndim == 3
    if not batched:
        x, w, us = x[None], w[None], us[None]
        if b is not None:
            b, ub = b[None], ub[None]
    if not _validate(x, w, us, b, ub):
        out = (zoo_dual_matmul_stacked_ref(x, w, us, mu) if b is None else
               zoo_dual_matmul_stacked_bias_relu_ref(x, w, us, b, ub, mu))
    else:
        name = ("zoo_dual_matmul_stacked" if b is None
                else "zoo_dual_matmul_stacked_bias_relu")
        out = _call(name, x, w, us, b, ub, mu)
    return out if batched else (out[0][0], out[1][0])
