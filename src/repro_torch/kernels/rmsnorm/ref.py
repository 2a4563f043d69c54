"""Plain PyTorch version of RMSNorm: the CPU path of ``ops.py`` and the
oracle the CUDA kernel is held against on the card."""
import torch


def rmsnorm_ref(x, scale, eps: float = 1e-6):
    """x (..., d), scale (d,) -> x * rsqrt(mean(x^2) + eps) * scale in
    f32, returned in x's dtype."""
    xf = x.float()
    ms = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)
