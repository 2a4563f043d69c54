"""Mixture-of-Experts: router, capacity dispatch, dense and gather paths.

Ported from the JAX package's ``models/moe.py`` with the same math,
dtypes and path choice (:func:`moe_apply`):

* ``train/prefill without caches`` — grouped sort-based **capacity
  dispatch** (:func:`moe_apply_dispatch`): each batch row's sequence is
  split into ``moe_groups`` groups; within a group the (Sg·k)
  token-expert pairs are stably sorted by expert id, ranked within their
  expert, and gathered into an (E, C, d) buffer with capacity
  C = max(⌈Sg·k/E · capacity_factor⌉, 4); pairs past the capacity are
  dropped. The expert matmuls are batched GEMMs against the stacked
  (E, d, f) weights.
* ``decode`` (any call with caches, so a cached prefill chunk too) — the
  **dense** form (:func:`moe_apply_dense`): every expert runs every
  token, contributions gated by the router mask, summed in f32. It
  computes the expert MLPs over blocks of experts, so the transients of a
  long prefill chunk stay within ``DENSE_BLOCK_BYTES`` (the JAX package's
  one einsum over all experts would hold a (B, S, E, d) tensor); on the
  card the block's GEMMs read the weights where they lie.
* ``decode, tiny batch`` with ``gather_experts=True`` and B·k <= E — the
  **gather** form (:func:`moe_apply_gather`): only the routed experts'
  weights are read.

Every path has static shapes and reads nothing back to the host, so the
decode step runs under CUDA-graph capture. Sharding constraints (expert
parallelism over a mesh) have no meaning on one device and are left out.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.common import ParamSpec
from repro_torch.models.layers import activation
from repro_torch.sharding.rules import current_mesh, shard_constraint

EXPERTS = ("batch", None, "experts", None, None)

# the largest transient (bytes) one block of the dense form may hold
DENSE_BLOCK_BYTES = 1 << 29


def moe_specs(cfg, d: int):
    pd = cfg.param_dtype
    E, f = cfg.n_experts, cfg.moe_d_ff
    sp = {
        "router": ParamSpec((d, E), "float32", (None, None), "scaled"),
        "w_up": ParamSpec((E, d, f), pd, ("experts", "expert_d", None), "scaled"),
        "w_down": ParamSpec((E, f, d), pd, ("experts", None, "expert_d"), "scaled"),
    }
    if cfg.act == "swiglu":
        sp["w_gate"] = ParamSpec((E, d, f), pd, ("experts", "expert_d", None), "scaled")
    if cfg.n_shared_experts:
        fs = cfg.n_shared_experts * f
        sp["shared_up"] = ParamSpec((d, fs), pd, ("embed", "ffn"), "scaled")
        sp["shared_down"] = ParamSpec((fs, d), pd, ("ffn", "embed"), "scaled")
        if cfg.act == "swiglu":
            sp["shared_gate"] = ParamSpec((d, fs), pd, ("embed", "ffn"), "scaled")
    return sp


def _one_hot(idx, n: int):
    """f32 one-hot by comparison: ``F.one_hot`` checks its input's range
    on the host, which a captured step cannot do."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _router(cfg, p, x):
    """x (B,S,d) -> (gates (B,S,k) fp32 normalized, idx (B,S,k), aux loss).

    The router dot keeps x in its dtype and accumulates in f32 (the
    router weights cast to x's dtype, the product taken in f32 from
    those values)."""
    logits = x.float() @ p["router"].to(x.dtype).float()
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, cfg.top_k, dim=-1)
    gates = gates / torch.clamp(torch.sum(gates, -1, keepdim=True), min=1e-9)
    # switch-style load-balance loss
    E = cfg.n_experts
    me = torch.mean(probs, dim=(0, 1))                             # (E,)
    ce = torch.mean(torch.sum(_one_hot(idx, E), dim=2),
                    dim=(0, 1)) / cfg.top_k                        # (E,)
    aux = E * torch.sum(me * ce) * cfg.load_balance_coef
    return gates, idx, aux


def _expert_ffn(cfg, w_up, w_gate, w_down, xe):
    """xe (E', T, d) -> (E', T, d): expert e's MLP on its T rows, one
    batched GEMM per weight over the experts."""
    h = torch.bmm(xe, w_up)
    g = torch.bmm(xe, w_gate) if cfg.act == "swiglu" else None
    return torch.bmm(activation(cfg.act, h, g), w_down)


def _expert_ffn_grouped(cfg, p, xb):
    """xb (B,G,E,C,d) -> same, through the per-expert MLP. Under a mesh
    the activated hidden and the output are held expert-parallel in the
    (B,G,E,C,·) layout, the JAX package's two constraints."""
    B, G, E, C, d = xb.shape

    def flat(t):                          # (B,G,E,C,n) -> (E, B·G·C, n)
        return t.permute(2, 0, 1, 3, 4).reshape(E, B * G * C, t.shape[-1])

    def grouped(t):                       # the inverse
        return t.reshape(E, B, G, C, t.shape[-1]).permute(1, 2, 0, 3, 4)
    xe = flat(xb)
    h = torch.bmm(xe, p["w_up"])
    g = torch.bmm(xe, p["w_gate"]) if cfg.act == "swiglu" else None
    h = activation(cfg.act, h, g)
    if current_mesh() is not None:
        h = flat(shard_constraint(grouped(h), EXPERTS))
    return shard_constraint(grouped(torch.bmm(h, p["w_down"])), EXPERTS)


def moe_apply_dispatch(cfg, p, x):
    """Grouped sort-based capacity dispatch (train & prefill without
    caches): gather-only and group-local, as in the JAX package."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    G = min(cfg.moe_groups, S)
    while S % G:                                         # smoke-size guard
        G -= 1
    Sg = S // G
    N = Sg * k                                           # pairs per group
    C = max(int(math.ceil(N / E * cfg.capacity_factor)), 4)
    dev = x.device

    gates, idx, aux = _router(cfg, p, x)                 # (B,S,k)
    xg = shard_constraint(x.reshape(B, G, Sg, d),
                          ("batch", "seq_act", None, None))
    flat_e = idx.reshape(B, G, N)                        # expert id per pair
    flat_g = gates.reshape(B, G, N)
    tok_of_pair = torch.arange(Sg, device=dev).repeat_interleave(k)
    tok_of_pair = tok_of_pair[None, None].expand(B, G, N)

    order = torch.argsort(flat_e, dim=-1, stable=True)   # sort pairs by expert
    inv_order = torch.argsort(order, dim=-1)
    se = torch.gather(flat_e, -1, order)
    st = torch.gather(tok_of_pair, -1, order)

    counts = torch.sum(_one_hot(flat_e, E), dim=2).long()          # (B,G,E)
    starts = torch.cumsum(counts, dim=-1) - counts       # exclusive
    rank = torch.arange(N, device=dev)[None, None] - torch.gather(starts, -1,
                                                                  se)
    keep = rank < C

    # dispatch: gather the c-th pair of each expert from the sorted stream
    xs = torch.gather(xg, 2, st[..., None].expand(B, G, N, d))     # (B,G,N,d)
    cs = torch.arange(C, device=dev)
    idx_ec = starts[..., None] + cs[None, None, None]               # (B,G,E,C)
    valid = cs[None, None, None] < torch.clamp(counts, max=C)[..., None]
    idx_flat = torch.clamp(idx_ec.reshape(B, G, E * C), 0, N - 1)
    xb = torch.gather(xs, 2, idx_flat[..., None].expand(B, G, E * C, d))
    xb = xb * valid.reshape(B, G, E * C, 1).to(xb.dtype)
    # the reshard below IS the all-to-all: groups -> experts
    xb = shard_constraint(xb.reshape(B, G, E, C, d), EXPERTS)

    yb = shard_constraint(_expert_ffn_grouped(cfg, p, xb),
                          ("batch", "seq_act", None, None, None)
                          ).reshape(B, G, E * C, d)

    # return path: pair n reads slot (se[n], rank[n]) — another gather
    slot = torch.clamp(se * C + torch.clamp(rank, 0, C - 1), 0, E * C - 1)
    ys = torch.gather(yb, 2, slot[..., None].expand(B, G, N, d))   # (B,G,N,d)
    sg = torch.gather(flat_g, -1, order)
    ys = ys * (sg * keep)[..., None]

    # unsort (gather via inverse permutation), pairs -> (Sg, k), sum
    ys = torch.gather(ys, 2, inv_order[..., None].expand(B, G, N, d))
    out = torch.sum(ys.reshape(B, G, Sg, k, d).float(), dim=3)
    out = out.reshape(B, S, d)

    if cfg.n_shared_experts:
        out = out + _shared(cfg, p, x)
    return out.to(x.dtype), aux


def dense_block(cfg, tokens: int) -> int:
    """Experts a block of the dense form takes: the largest divisor of
    E whose f32 (block, tokens, d) transient fits ``DENSE_BLOCK_BYTES``."""
    E = cfg.n_experts
    per_expert = tokens * cfg.d_model * 4
    best = 1
    for eb in range(1, E + 1):
        if E % eb == 0 and eb * per_expert <= DENSE_BLOCK_BYTES:
            best = eb
    return best


def moe_apply_dense(cfg, p, x):
    """Masked dense form (decode, and a cached prefill chunk): every
    expert runs every token; contributions are gated by the router mask
    and summed in f32. The experts are taken ``dense_block`` at a time;
    each block's gate-weighted f32 sum is added to the total."""
    B, S, d = x.shape
    E = cfg.n_experts
    gates, idx, aux = _router(cfg, p, x)
    comb = torch.sum(_one_hot(idx, E) * gates[..., None], dim=2)   # (B,S,E)

    T = B * S
    xt = x.reshape(1, T, d)
    combt = comb.reshape(T, E).transpose(0, 1)                      # (E,T)
    eb = dense_block(cfg, T)
    out = None
    for e0 in range(0, E, eb):
        sl = slice(e0, e0 + eb)
        y = _expert_ffn(cfg, p["w_up"][sl],
                        None if cfg.act != "swiglu" else p["w_gate"][sl],
                        p["w_down"][sl], xt.expand(eb, T, d))       # (eb,T,d)
        part = torch.einsum("etd,et->td", y.float(), combt[sl])
        out = part if out is None else out + part
    out = out.reshape(B, S, d)

    if cfg.n_shared_experts:
        out = out + _shared(cfg, p, x)
    return out.to(x.dtype), aux


def moe_apply_gather(cfg, p, x):
    """Tiny-batch decode: gather the k routed experts' weights per token.
    Reads B·k expert weight sets instead of E."""
    B, S, d = x.shape
    if S != 1:
        raise ValueError(f"the gather form decodes one token, got S={S}")
    gates, idx, aux = _router(cfg, p, x)                  # (B,1,k)
    idxf = idx[:, 0]                                      # (B,k)
    k = idxf.shape[1]
    flat = idxf.reshape(-1)

    def take(w):
        return w.index_select(0, flat).reshape((B, k) + tuple(w.shape[1:]))
    up, down = take(p["w_up"]), take(p["w_down"])         # (B,k,d,f) (B,k,f,d)
    h = torch.einsum("bd,bkdf->bkf", x[:, 0], up)
    g = (torch.einsum("bd,bkdf->bkf", x[:, 0], take(p["w_gate"]))
         if cfg.act == "swiglu" else None)
    h = activation(cfg.act, h, g)
    y = torch.einsum("bkf,bkfd->bkd", h, down)
    out = torch.einsum("bkd,bk->bd", y.float(), gates[:, 0])[:, None]
    if cfg.n_shared_experts:
        out = out + _shared(cfg, p, x)
    return out.to(x.dtype), aux


def _shared(cfg, p, x):
    h = x @ p["shared_up"]
    g = x @ p["shared_gate"] if cfg.act == "swiglu" else None
    h = activation(cfg.act, h, g)
    return (h @ p["shared_down"]).float()


def moe_apply(cfg, p, x, *, decode: bool = False,
              gather_experts: bool = False):
    if decode and gather_experts and x.shape[0] * cfg.top_k <= cfg.n_experts:
        return moe_apply_gather(cfg, p, x)
    if decode:
        return moe_apply_dense(cfg, p, x)
    return moe_apply_dispatch(cfg, p, x)
