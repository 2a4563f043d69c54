"""Primitive layers: norms, activations, RoPE, embeddings.

Ported from the JAX package's ``models/layers.py`` with the same math and
dtypes. On a CUDA tensor, :func:`apply_norm` of an RMSNorm config runs the
hand-written RMSNorm kernel over the (M, d) view; everything else is plain
PyTorch.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops
from repro_torch.models.common import ParamSpec


# ---------------------------------------------------------------- norms ----

def norm_specs(cfg, d: int):
    if cfg.norm == "layernorm":
        return {"scale": ParamSpec((d,), "float32", (None,), "ones"),
                "bias": ParamSpec((d,), "float32", (None,), "zeros")}
    return {"scale": ParamSpec((d,), "float32", (None,), "ones")}


def apply_norm(cfg, p, x, eps: float = 1e-6):
    if cfg.norm != "layernorm" and x.is_cuda:
        d = x.shape[-1]
        return rmsnorm_ops.rmsnorm(x.reshape(-1, d), p["scale"],
                                   eps=eps).reshape(x.shape)
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"] + p["bias"]
    else:  # rmsnorm
        ms = torch.mean(torch.square(xf), dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"]
    return y.to(x.dtype)


def rms_norm_simple(x, scale, eps: float = 1e-6):
    xf = x.float()
    ms = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale).to(x.dtype)


# ----------------------------------------------------------- activations ---

def activation(name: str, x, gate=None):
    if name == "swiglu":
        if gate is None:
            raise ValueError("swiglu needs its gate")
        return F.silu(gate) * x
    if name == "gelu":
        return F.gelu(x, approximate="tanh")
    if name == "relu2":
        r = torch.relu(x)
        return r * r
    raise ValueError(f"unknown activation {name!r}")


# ------------------------------------------------------------------ RoPE ---

def rope_freqs(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x, positions, theta: float, has_heads: bool = True):
    """x: (..., S, H, hd) if has_heads else (..., S, hd); positions: (S,)
    (or (1,) for decode — broadcasts)."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, x.device)                     # (hd/2,)
    ang = positions[..., :, None].float() * inv               # (S, hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    if has_heads:                                      # align with (S, H, hd)
        cos, sin = cos[..., :, None, :], sin[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------- embedding ---

def embed_lookup(p, tokens, *, iota: bool = False):
    """Token embedding: a row gather, or (``iota=True``) the one-hot
    matmul form the JAX package uses on a vocab-sharded table; both give
    the same rows."""
    table = p["table"]
    if not iota:
        return table[tokens.long()]
    onehot = F.one_hot(tokens.long(), table.shape[0]).to(table.dtype)
    return onehot @ table


def unembed(p, x):
    """x (..., d) -> logits (..., padded_vocab)."""
    return x @ p["table"].transpose(0, 1)
