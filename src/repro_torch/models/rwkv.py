"""RWKV6 (Finch) — time-mix with data-dependent per-channel decay.

Ported from the JAX package's ``models/rwkv.py`` with the same math and
dtypes. Per head (key dim K = value dim V = rwkv_head_dim):

    S_t   = diag(w_t) S_{t-1} + k_t v_t^T            (K, V) state
    y_t   = r_t @ (S_{t-1} + diag(u) k_t v_t^T)

with w_t ∈ (0,1)^K *data-dependent* (the Finch contribution) via a small
lora: w_t = exp(-exp(w0 + tanh(x_t A) B)). Train/prefill use a chunked
form (a loop over chunks, (c×c) intra matrices, (K,V) carried state);
decode updates the state directly. Channel-mix is the squared-relu FFN.

The JAX package has no Pallas kernel here, so this module is plain
PyTorch on the CPU and on the card alike. Sharding constraints have no
meaning on one device and are left out.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamSpec, chunk_divisor
from repro_torch.models.layers import merge_last, split_last
from repro_torch.sharding.rules import shard_constraint

W_LORA = 64


def rwkv_specs(cfg, d: int):
    pd = cfg.param_dtype
    return {
        "w_r": ParamSpec((d, d), pd, ("embed", "heads_out"), "scaled"),
        "w_k": ParamSpec((d, d), pd, ("embed", "heads_out"), "scaled"),
        "w_v": ParamSpec((d, d), pd, ("embed", "heads_out"), "scaled"),
        "w_g": ParamSpec((d, d), pd, ("embed", "heads_out"), "scaled"),
        "w_o": ParamSpec((d, d), pd, ("heads_out", "embed"), "scaled"),
        "decay_base": ParamSpec((d,), "float32", (None,), "zeros"),
        "decay_lora_a": ParamSpec((d, W_LORA), pd, ("embed", None), "scaled"),
        "decay_lora_b": ParamSpec((W_LORA, d), pd, (None, None), "scaled"),
        "bonus_u": ParamSpec((d,), "float32", (None,), "zeros"),
        "mix_r": ParamSpec((d,), "float32", (None,), "zeros"),
        "mix_k": ParamSpec((d,), "float32", (None,), "zeros"),
        "mix_v": ParamSpec((d,), "float32", (None,), "zeros"),
        "ln_x": ParamSpec((d,), "float32", (None,), "ones"),
    }


def rwkv_state_specs(cfg, batch: int, d: int, dtype="float32"):
    """Recurrent decode state (wkv matrix + token-shift tails). As in
    ``ssm_state_specs``, "cache_batch" with no "cache_seq" axis tells the
    paged serve plane these leaves are sequence-independent: the
    continuous scheduler slot-stacks them and freezes inactive rows
    (``common.freeze_state``) rather than paging them."""
    H = cfg.n_rwkv_heads
    K = cfg.rwkv_head_dim
    return {
        "wkv": ParamSpec((cfg.n_layers, batch, H, K, K), dtype,
                         ("layers", "cache_batch", "cache_heads", None, None)),
        "shift": ParamSpec((cfg.n_layers, batch, d), dtype,
                           ("layers", "cache_batch", None)),
        "shift_c": ParamSpec((cfg.n_layers, batch, d), dtype,
                             ("layers", "cache_batch", None)),
    }


def _token_shift(x, mix, prev=None):
    """lerp(x_t, x_{t-1}, mix). prev: (B,d) last token of previous step."""
    B, S, d = x.shape
    if prev is None:
        prev = torch.zeros((B, d), dtype=x.dtype, device=x.device)
    xs = torch.cat([prev[:, None], x[:, :-1]], dim=1)
    m = torch.sigmoid(mix).to(x.dtype)
    return x * (1 - m) + xs * m


def wkv6_recurrent_ref(r, k, v, w, u):
    """Naive token scan — oracle. r,k,v,w: (B,S,H,K); u: (H,K)."""
    B, S, H, K = r.shape
    r, k, v, w = (a.float() for a in (r, k, v, w))
    S_ = torch.zeros((B, H, K, K), dtype=torch.float32, device=r.device)
    ys = []
    for t in range(S):
        kv = torch.einsum("bhk,bhv->bhkv", k[:, t], v[:, t])
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                               S_ + u[None, :, :, None] * kv))
        S_ = S_ * w[:, t][..., None] + kv
    return torch.stack(ys, dim=1)


def wkv6_chunked(r, k, v, w, u, chunk, state0=None):
    """Chunked wkv6. r,k,v,w (B,S,H,K); u (H,K). Returns (y, final_state).

    Derivation: with cw_t = sum_{s<=t} log w_s, S_{i-1} contains k_j
    scaled by prod_{s=j+1..i-1} w_s = exp(cw_{i-1} - cw_j). Within a
    chunk both exp() factors are taken around the chunk-midpoint
    cumulative decay, so they stay in f32 range (the per-token log-decay
    is clamped in :func:`rwkv_time_mix`)."""
    B, S, H, K = r.shape
    c = min(chunk, S)
    if S % c:
        raise ValueError(f"chunk {c} does not tile S={S}")
    nc = S // c
    f32 = torch.float32

    def chunks(a):
        return a.reshape(B, nc, c, H, K).float().unbind(1)

    rr, kk, vv, ww = chunks(r), chunks(k), chunks(v), chunks(w)
    S_ = (torch.zeros((B, H, K, K), dtype=f32, device=r.device)
          if state0 is None else state0.float())

    ii = torch.arange(c, device=r.device)
    strict = (ii[:, None] > ii[None, :])                  # j < i
    u = u.float()
    ys = []
    for r_c, k_c, v_c, w_c in zip(rr, kk, vv, ww):        # (B,c,H,K)
        lw = torch.log(torch.clamp(w_c, min=1e-20))
        cw = torch.cumsum(lw, dim=1)                      # (B,c,H,K)
        # intra: coeff(i,j) = exp(cw_{i-1} - cw_j) for j<i ; u·k_i on diag
        ref = cw[:, c // 2][:, None]                      # (B,1,H,K)
        ri = r_c * torch.exp(cw - lw - ref)               # r_i e^{cw_{i-1}-ref}
        kj = k_c * torch.exp(ref - cw)                    # k_j e^{ref-cw_j}
        A = torch.einsum("bihk,bjhk->bijh", ri, kj)
        A = torch.where(strict[None, :, :, None], A, 0.0)
        Adiag = torch.einsum("bihk,hk,bihk->bih", r_c, u, k_c)
        y = torch.einsum("bijh,bjhv->bihv", A, v_c)
        y = y + Adiag[..., None] * v_c
        # inter: r_i e^{cw_{i-1}} @ S_prev (exponent <= 0: stable)
        ri0 = r_c * torch.exp(cw - lw)
        y = y + torch.einsum("bihk,bhkv->bihv", ri0, S_)
        # state: S' = e^{cw_last} S + sum_j e^{cw_last - cw_j} k_j v_j^T
        # (both exponents <= 0: stable)
        wtot = torch.exp(cw[:, -1])                       # (B,H,K)
        kj2 = k_c * torch.exp(cw[:, -1][:, None] - cw)
        S_ = (S_ * wtot[..., None]
              + torch.einsum("bjhk,bjhv->bhkv", kj2, v_c))
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(B, S, H, K)
    return y, S_


def rwkv_time_mix(cfg, p, x, *, state=None):
    """x (B,S,d) -> (out, new_state). state: dict(wkv (B,H,K,K), shift
    (B,d)) or None. Three branches: no state (training, and the forward
    without caches); a chunked prefill seeded from the carried state
    (S > 1); the one-token decode step."""
    B, S, d = x.shape
    H, K = cfg.n_rwkv_heads, cfg.rwkv_head_dim
    dt_ = x.dtype

    prev = None if state is None else state["shift"].to(dt_)
    xr = _token_shift(x, p["mix_r"], prev)
    xk = _token_shift(x, p["mix_k"], prev)
    xv = _token_shift(x, p["mix_v"], prev)

    r = split_last(xr @ p["w_r"], H, K)
    k = split_last(xk @ p["w_k"], H, K)
    v = split_last(xv @ p["w_v"], H, K)
    g = F.silu(x @ p["w_g"])

    # data-dependent decay (the Finch contribution)
    lora = torch.tanh(x @ p["decay_lora_a"]) @ p["decay_lora_b"]
    # clamp per-token log-decay to [-4, -1e-3]: keeps the chunked form's
    # exp() factors in fp32 range (chunk 32 -> max half-range exponent 64)
    log_w = -torch.exp(p["decay_base"] + lora.float())
    w = torch.exp(torch.clamp(log_w, -4.0, -1e-3))
    w = split_last(w, H, K)
    u = p["bonus_u"].reshape(H, K)

    r = shard_constraint(r, ("batch", None, "heads_act", None))
    if state is None:
        y, _ = wkv6_chunked(r, k, v, w, u, cfg.rwkv_chunk)
        new_state = None
    elif S > 1:
        # chunked prefill with carried state: the same chunked form as
        # training, seeded from the decode state. The chunk length must
        # tile S and stay small enough for the mid-point exp factoring.
        c = chunk_divisor(S, cfg.rwkv_chunk)
        y, S1 = wkv6_chunked(r, k, v, w, u, c, state0=state["wkv"].float())
        new_state = {"wkv": S1.to(state["wkv"].dtype),
                     "shift": x[:, -1].to(state["shift"].dtype)}
    else:
        S0 = state["wkv"].float()
        k0, v0, r0 = k[:, 0].float(), v[:, 0].float(), r[:, 0].float()
        kv = torch.einsum("bhk,bhv->bhkv", k0, v0)
        y = torch.einsum("bhk,bhkv->bhv", r0,
                         S0 + u[None, :, :, None] * kv)[:, None]
        S1 = S0 * w[:, 0][..., None] + kv
        new_state = {"wkv": S1.to(state["wkv"].dtype),
                     "shift": x[:, -1].to(state["shift"].dtype)}

    # group-norm-ish per head (population variance) then output gate
    y = y.reshape(B, S, H, K).float()
    mu = torch.mean(y, -1, keepdim=True)
    var = torch.var(y, -1, keepdim=True, correction=0)
    y = merge_last((y - mu) * torch.rsqrt(var + 1e-5))
    y = y * p["ln_x"]
    out = (y.to(dt_) * g.to(dt_)) @ p["w_o"]
    return out, new_state


def rwkv_channel_mix_specs(cfg, d: int):
    pd = cfg.param_dtype
    return {
        "w_k": ParamSpec((d, cfg.d_ff), pd, ("embed", "ffn"), "scaled"),
        "w_v": ParamSpec((cfg.d_ff, d), pd, ("ffn", "embed"), "scaled"),
        "w_r": ParamSpec((d, d), pd, ("embed", None), "scaled"),
        "mix_k": ParamSpec((d,), "float32", (None,), "zeros"),
        "mix_r": ParamSpec((d,), "float32", (None,), "zeros"),
    }


def rwkv_channel_mix(cfg, p, x, *, prev=None):
    xk = _token_shift(x, p["mix_k"], prev)
    xr = _token_shift(x, p["mix_r"], prev)
    k = torch.square(torch.relu(xk @ p["w_k"]))
    k = shard_constraint(k, ("batch", None, "ffn_act"))
    kv = k @ p["w_v"]
    r = torch.sigmoid(xr @ p["w_r"])
    return (r * kv).to(x.dtype)
