"""Mamba2 (SSD) layer: chunked scan for prefill, state step for decode.

Ported from the JAX package's ``models/ssm.py`` with the same math and
dtypes. Recurrence per head h (state N = cfg.ssm_state, head dim P =
ssm_head_dim):

    a_t    = exp(-softplus(dt_t) * exp(A_log_h))            scalar per head
    S_t    = a_t * S_{t-1} + softplus(dt_t) * (x_t ⊗ B_t)   (P, N)
    y_t    = S_t @ C_t + D_h * x_t                           (P,)

The chunked (SSD) form scans over chunks of length ``ssm_chunk``: within a
chunk the contribution is an attention-like (c×c) masked matrix; across
chunks only the (P×N) state is carried. On a CUDA tensor
:func:`_ssd_chunked` runs the hand-written SSD kernel
(``repro_torch.kernels.ssd_chunk``); on the CPU it runs the plain chunked
form (``ssd_chunk/ref.py::ssd_chunked_ref``), which is also what the
kernel's backward differentiates. The one-token decode step (S == 1) is
a rank-1 state update in plain PyTorch on both, as in the JAX package.

A short causal depthwise conv (width 4) precedes the SSM; its tail is
carried as decode state.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.analysis import marks
from repro_torch.kernels.ssd_chunk import ops as ssd_ops
from repro_torch.kernels.ssd_chunk.ref import (ssd_chunked_ref,
                                               ssd_states_ref)
from repro_torch.models.common import ParamSpec, chunk_divisor
from repro_torch.models.layers import (contiguous_grads, grad_placements,
                                       merge_last, split_last)
from repro_torch.sharding.rules import (ACT_RULES, placements, resolve_spec,
                                        shard_constraint)

CONV_W = 4


def ssm_specs(cfg, d: int):
    pd = cfg.param_dtype
    d_in = cfg.ssm_expand * d
    H = d_in // cfg.ssm_head_dim
    N = cfg.ssm_state
    return {
        "w_in": ParamSpec((d, 2 * d_in), pd, ("embed", "ssm_inner"), "scaled"),
        "w_bc": ParamSpec((d, 2 * N), pd, ("embed", None), "scaled"),
        "w_dt": ParamSpec((d, H), pd, ("embed", None), "scaled"),
        "dt_bias": ParamSpec((H,), "float32", (None,), "zeros"),
        "A_log": ParamSpec((H,), "float32", (None,), "zeros"),
        "D": ParamSpec((H,), "float32", (None,), "ones"),
        "conv_w": ParamSpec((CONV_W, d_in), pd, (None, "ssm_inner"), "scaled"),
        "w_out": ParamSpec((d_in, d), pd, ("ssm_inner", "embed"), "scaled"),
    }


def ssm_state_specs(cfg, batch: int, d: int, dtype="float32"):
    """Recurrent decode state, stacked over layers (the JAX package's
    logical axis names kept)."""
    d_in = cfg.ssm_expand * d
    H = d_in // cfg.ssm_head_dim
    return {
        "ssm": ParamSpec((cfg.n_layers, batch, H, cfg.ssm_head_dim, cfg.ssm_state),
                         dtype, ("layers", "cache_batch", "cache_heads", None, None)),
        "conv": ParamSpec((cfg.n_layers, batch, CONV_W - 1, d_in), dtype,
                          ("layers", "cache_batch", None, "ssm_inner")),
    }


def _causal_conv(x, w, tail=None):
    """Depthwise causal conv. x (B,S,D), w (W,D), tail (B,W-1,D) or None."""
    B, S, D = x.shape
    pad = (torch.zeros((B, CONV_W - 1, D), dtype=x.dtype, device=x.device)
           if tail is None else tail.to(x.dtype))
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i:i + S] * w[i] for i in range(CONV_W))
    new_tail = xp[:, S:]                                  # last W-1 inputs
    if tail is not None:
        # keep the carried state in its spec dtype: the values are already
        # rounded to x.dtype, so the widening store is exact, and an f32
        # tail stays f32 after a bf16 step
        new_tail = new_tail.to(tail.dtype)
    return out, new_tail


def _ssd_chunked(xh, a, dt, Bm, Cm, chunk, state0=None):
    """Chunked SSD scan.

    xh (B,S,H,P), a (B,S,H) decay in (0,1], dt (B,S,H), Bm/Cm (B,S,N),
    state0 (B,H,P,N) f32 or None. Returns (y (B,S,H,P) f32, final_state
    (B,H,P,N) f32). A CUDA tensor goes to the SSD kernel (one launch); a
    CPU tensor to the plain chunked form (``ssd_chunk/ref.py``). DTensor
    operands (under a mesh) run on each rank's local shards
    (:func:`_ssd_sharded`)."""
    if isinstance(xh, DTensor):
        return _ssd_sharded(xh, a, dt, Bm, Cm, chunk, state0)
    if marks.on_card(xh):
        return ssd_ops.ssd_chunk_bshp(xh, a, dt, Bm.contiguous(),
                                      Cm.contiguous(), chunk=chunk,
                                      state0=state0)
    return ssd_chunked_ref(xh, a, dt, Bm, Cm, chunk, state0)


def _ssd_sharded(xh, a, dt, Bm, Cm, chunk, state0):
    """:func:`_ssd_chunked` of DTensor operands through ``local_map``: the
    batch over the data axes and the heads over ``"model"`` (the
    ``ssm_inner`` split of ``w_in``), B and C whole on every head shard;
    the final state takes the heads' placement too."""
    from torch.distributed.tensor.experimental import local_map
    mesh = xh.device_mesh

    def pl(shape, logical):
        return placements(mesh, resolve_spec(mesh, shape, logical,
                                             ACT_RULES))
    heads = pl(xh.shape, ("batch", None, "heads_act", None))
    ins = [heads, pl(a.shape, ("batch", None, "heads_act")),
           pl(dt.shape, ("batch", None, "heads_act")),
           pl(Bm.shape, ("batch", None, None)),
           pl(Cm.shape, ("batch", None, None))]
    B, _, H, P = xh.shape
    state = pl((B, H, P, Bm.shape[-1]), ("batch", "heads_act", None, None))
    args = (xh, a, dt, Bm, Cm)
    if state0 is not None:
        ins.append(state)
        args += (state0,)

    def local(xh, a, dt, Bm, Cm, state0=None):
        xh, a, dt, Bm, Cm = contiguous_grads(xh, a, dt, Bm, Cm)
        return _ssd_chunked(xh, a, dt, Bm, Cm, chunk, state0)
    return local_map(local, out_placements=(heads, state),
                     in_placements=tuple(ins),
                     in_grad_placements=grad_placements(ins, heads),
                     device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def ssd_recurrent_ref(xh, a, dt, Bm, Cm):
    """Naive per-token recurrence — oracle for the chunked form (tests)."""
    return ssd_states_ref(xh, a, dt, Bm, Cm)[0]


def ssm_apply(cfg, p, x, *, state=None):
    """Mamba2 mixer. x (B,S,d). state: dict(ssm, conv) for decode or None.

    Returns (out (B,S,d), new_state); the caller stores new_state."""
    B, S, d = x.shape
    d_in = cfg.ssm_expand * d
    H = d_in // cfg.ssm_head_dim
    P = cfg.ssm_head_dim
    dt_ = x.dtype

    zx = x @ p["w_in"]
    z, xin = torch.chunk(zx, 2, dim=-1)                   # gate, stream
    xin = shard_constraint(xin, ("batch", None, "ffn_act"))

    conv_tail = None if state is None else state["conv"]
    xin, new_tail = _causal_conv(xin, p["conv_w"], conv_tail)
    xin = F.silu(xin)

    bc = x @ p["w_bc"]
    Bm, Cm = torch.chunk(bc, 2, dim=-1)                   # (B,S,N)
    dt_raw = (x @ p["w_dt"]).float()
    dt = F.softplus(dt_raw + p["dt_bias"])                # (B,S,H)
    a = torch.exp(-dt * torch.exp(p["A_log"]))            # (B,S,H)

    xh = split_last(xin, H, P)

    if state is None:
        y, _ = _ssd_chunked(xh, a, dt, Bm, Cm, cfg.ssm_chunk)
        new_state = None
    elif S > 1:
        # chunked prefill with carried state: the SSD form seeded from the
        # decode state
        c = chunk_divisor(S, cfg.ssm_chunk)
        y, s1 = _ssd_chunked(xh, a, dt, Bm, Cm, c,
                             state0=state["ssm"].float())
        new_state = {"ssm": s1.to(state["ssm"].dtype), "conv": new_tail}
    else:
        s0 = state["ssm"].float()                         # (B,H,P,N)
        upd = ((xh[:, 0].float() * dt[:, 0, :, None])[..., None]
               * Bm[:, 0].float()[:, None, None, :])
        s1 = s0 * a[:, 0, :, None, None] + upd
        y = torch.einsum("bhpn,bn->bhp", s1, Cm[:, 0].float())[:, None]
        new_state = {"ssm": s1.to(state["ssm"].dtype), "conv": new_tail}

    y = y + p["D"][None, None, :, None] * xh.float()
    y = merge_last(y) * F.silu(z.float())
    out = y.to(dt_) @ p["w_out"]
    return out, new_state
