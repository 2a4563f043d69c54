"""Primitive layers: norms, activations, RoPE, embeddings.

Ported from the JAX package's ``models/layers.py`` with the same math and
dtypes. On a CUDA tensor, :func:`apply_norm` of an RMSNorm config runs the
hand-written RMSNorm kernel over the (M, d) view; everything else is plain
PyTorch. A DTensor operand of an RMSNorm (under a mesh) runs through
``local_map`` on each rank's rows (:func:`_norm_sharded`): the kernel
never sees a DTensor.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.analysis import marks
from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops
from repro_torch.models.common import ParamSpec


# ---------------------------------------------------------------- norms ----

def norm_specs(cfg, d: int):
    if cfg.norm == "layernorm":
        return {"scale": ParamSpec((d,), "float32", (None,), "ones"),
                "bias": ParamSpec((d,), "float32", (None,), "zeros")}
    return {"scale": ParamSpec((d,), "float32", (None,), "ones")}


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward makes its gradient contiguous. A local
    function under ``local_map`` may hand back a strided gradient (the
    plain attention's einsums do), and DTensor then ``view``s that local
    shard in the matmul backward before it, which a strided tensor
    refuses."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def contiguous_grads(*xs):
    """Each of ``xs`` through :class:`_ContiguousGrad` where it needs a
    gradient (a local shard inside ``local_map``)."""
    return tuple(_ContiguousGrad.apply(x) if x.requires_grad else x
                 for x in xs)


def grad_placements(ins, out):
    """``local_map``'s ``in_grad_placements`` for inputs placed ``ins``
    (one placement list each) of a function whose output is placed
    ``out``: an input replicated on a mesh dim the output is sharded on
    is read by every shard, so its gradient there is a partial sum."""
    return tuple([Partial() if (i.is_replicate() and o.is_shard()) else i
                  for i, o in zip(pl, out)] for pl in ins)


def _whole_groups(x, groups: int):
    """A DTensor ``x`` whose last dim is sharded over ways that do not
    divide ``groups`` (4 heads over a model axis of 16), with that dim
    gathered; else ``x``. DTensor cannot unflatten a shard that cuts a
    head."""
    if not isinstance(x, DTensor):
        return x
    last = x.ndim - 1
    ways = 1
    for i, q in enumerate(x.placements):
        if q.is_shard(last):
            ways *= x.device_mesh.size(i)
    if groups % ways == 0:
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if q.is_shard(last) else q for q in x.placements])


class _WholeGroupsGrad(torch.autograd.Function):
    """The identity, whose backward gives its gradient whole groups
    (:func:`_whole_groups`) before the backward of a merge splits it."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _whole_groups(g, ctx.groups), None


def split_last(x, *sizes):
    """``x`` with its last dim split into ``sizes`` (heads, head dim); a
    DTensor is first given whole heads (:func:`_whole_groups`)."""
    x = _whole_groups(x, sizes[0])
    return x.reshape(*x.shape[:-1], *sizes)


def merge_last(x):
    """``x`` (..., H, d) -> (..., H·d); a DTensor's gradient is given
    whole heads before the merge's backward splits it."""
    flat = x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])
    if isinstance(flat, DTensor) and flat.requires_grad:
        flat = _WholeGroupsGrad.apply(flat, x.shape[-2])
    return flat


def _norm_sharded(cfg, p, x, eps: float):
    """RMSNorm of a DTensor ``x`` on each rank's rows: x keeps its
    placements except a shard of its last (normalized) dim or a partial
    sum, which become replicated; the scale is gathered whole."""
    from torch.distributed.tensor.experimental import local_map
    last = x.ndim - 1
    pl = [Replicate() if (q.is_partial() or (q.is_shard() and q.dim == last))
          else q for q in x.placements]
    rep = [Replicate()] * len(pl)

    def local(x, scale):
        x, scale = contiguous_grads(x, scale)
        return apply_norm(cfg, {"scale": scale}, x, eps)
    return local_map(local, out_placements=pl, in_placements=(pl, rep),
                     in_grad_placements=grad_placements((pl, rep), pl),
                     device_mesh=x.device_mesh,
                     redistribute_inputs=True)(x, p["scale"])


def gather_inner(x):
    """A DTensor ``x`` with its inner dims (neither the first nor the
    last) gathered whole; a plain tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    last = x.ndim - 1
    pl = [Replicate() if (q.is_shard() and 0 < q.dim < last) else q
          for q in x.placements]
    if pl == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, pl)


def apply_norm(cfg, p, x, eps: float = 1e-6):
    if cfg.norm != "layernorm" and isinstance(x, DTensor):
        return _norm_sharded(cfg, p, x, eps)
    if cfg.norm != "layernorm" and marks.on_card(x):
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
