"""Attention: GQA/MQA/MHA + MLA, causal/sliding-window, KV-cache decode.

Ported from the JAX package's ``models/attention.py``:

* :func:`mha_chunked` — plain attention over query chunks (a full
  softmax per chunk), the JAX package's XLA path;
* :func:`decode_attend` — one new token against the cache, a masked
  einsum over the full cache (plain PyTorch, as the JAX package has no
  kernel for it), at one shared position (a Python int, the solo path)
  or at a per-row ``(B,)`` position tensor (the continuous scheduler);
* :func:`paged_update_gather` — the paged pool's in-place row write and
  the gather of each slot's whole masked extent;
* :func:`attention_apply` — the sub-layer, with its no-cache, decode
  (S = 1), chunked-prefill (S > 1 with a cache), paged-decode
  (``paging=``) and cross-attention (``kv_override=``: K and V projected
  from an encoder's output, no RoPE, no cache, never causal) branches. On
  a CUDA tensor the no-cache, chunked-prefill and cross branches run the
  hand-written flash-attention kernel
  (``repro_torch.kernels.flash_attention``); on the CPU they run
  :func:`mha_chunked`;
* :func:`mla_apply` — DeepSeek-V3's multi-head latent attention, with the
  same four branches. Its cache holds the normed latent and the shared
  rope key, ``kv_lora_rank + qk_rope_dim`` values a token
  (:func:`cache_specs`); :func:`_mla_expand` re-expands it to per-head k
  (``qk_nope_dim + qk_rope_dim`` = 192 at full width) and v
  (``v_head_dim`` = 128), which the flash kernel takes as its (192, 128)
  pair on the card; a one-token decode attends over the expanded cache
  (:func:`decode_attend`) or, with ``cfg.mla_absorb``, scores in latent
  space (:func:`_mla_absorbed_decode`).

The KV cache, the latent cache and the page pool are updated in place (the
JAX package returns new ones through ``dynamic_update_slice`` and
``.at[].set`` with donation). A cross call recomputes K and V from its
source at every decode step, as the JAX package does.

Under a mesh (``sharding.rules.use_mesh``) q, k, v and the attention
output are constrained at the JAX package's sites, and a DTensor call of
:func:`_attend` runs through ``local_map`` on each rank's heads shard
(:func:`_attend_sharded`), so the kernel only ever sees local tensors.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.analysis import marks
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.common import ParamSpec
from repro_torch.models.layers import (apply_rope, contiguous_grads,
                                       merge_last, rms_norm_simple,
                                       split_last)
from repro_torch.sharding.rules import (ACT_RULES, placements, resolve_spec,
                                        shard_constraint)

NEG_INF = -1e30


# ------------------------------------------------------------ param specs --

def attention_specs(cfg, d: Optional[int] = None):
    d = d or cfg.d_model
    hd = cfg.resolved_head_dim
    pd = cfg.param_dtype
    if cfg.use_mla:
        return {
            "wq_a": ParamSpec((d, cfg.q_lora_rank), pd, ("embed", "latent"),
                              "scaled"),
            "q_norm": ParamSpec((cfg.q_lora_rank,), "float32", (None,),
                                "ones"),
            "wq_b": ParamSpec((cfg.q_lora_rank,
                               cfg.n_heads * (cfg.qk_nope_dim
                                              + cfg.qk_rope_dim)),
                              pd, ("latent", "heads_out"), "scaled"),
            "wkv_a": ParamSpec((d, cfg.kv_lora_rank + cfg.qk_rope_dim), pd,
                               ("embed", None), "scaled"),
            "kv_norm": ParamSpec((cfg.kv_lora_rank,), "float32", (None,),
                                 "ones"),
            "wkv_b": ParamSpec((cfg.kv_lora_rank,
                                cfg.n_heads * (cfg.qk_nope_dim
                                               + cfg.v_head_dim)),
                               pd, ("latent", "heads_out"), "scaled"),
            "wo": ParamSpec((cfg.n_heads * cfg.v_head_dim, d), pd,
                            ("heads_out", "embed"), "scaled"),
        }
    sp = {
        "wq": ParamSpec((d, cfg.n_heads * hd), pd, ("embed", "heads_out"), "scaled"),
        "wk": ParamSpec((d, cfg.n_kv_heads * hd), pd, ("embed", "kv_out"), "scaled"),
        "wv": ParamSpec((d, cfg.n_kv_heads * hd), pd, ("embed", "kv_out"), "scaled"),
        "wo": ParamSpec((cfg.n_heads * hd, d), pd, ("heads_out", "embed"), "scaled"),
    }
    if cfg.qk_norm:
        sp["q_norm"] = ParamSpec((hd,), "float32", (None,), "ones")
        sp["k_norm"] = ParamSpec((hd,), "float32", (None,), "ones")
    return sp


def cache_specs(cfg, batch: int, seq: int, dtype="bfloat16"):
    """Abstract KV-cache layout for decode shapes."""
    if cfg.use_mla:
        # MLA caches the compressed latent + shared rope key only
        width = cfg.kv_lora_rank + cfg.qk_rope_dim
        return {"latent": ParamSpec((cfg.n_layers, batch, seq, width), dtype,
                                    ("layers", "cache_batch", "cache_seq",
                                     None))}
    hd = cfg.resolved_head_dim
    return {
        "k": ParamSpec((cfg.n_layers, batch, seq, cfg.n_kv_heads, hd), dtype,
                       ("layers", "cache_batch", "cache_seq", "cache_heads", None)),
        "v": ParamSpec((cfg.n_layers, batch, seq, cfg.n_kv_heads, hd), dtype,
                       ("layers", "cache_batch", "cache_seq", "cache_heads", None)),
    }


# ------------------------------------------------- chunked full attention --

def mha_chunked(q, k, v, *, causal: bool = True, window: int = 0,
                q_chunk: int = 512, logit_softcap: float = 0.0,
                q_offset: int = 0, scale: Optional[float] = None):
    """q: (B, Sq, Hq, hd), k/v: (B, Skv, Hkv, hd). GQA via head grouping.

    Loops over query chunks; each chunk materializes (B, H, qc, Skv) f32
    scores. ``window`` > 0 enables sliding-window masking (keys older than
    ``window`` are masked out); query row i sits at ``q_offset`` + i.
    """
    B, Sq, Hq, hd = q.shape
    _, Skv, Hkv, _ = k.shape
    vd = v.shape[-1]
    G = Hq // Hkv
    scale = hd ** -0.5 if scale is None else scale
    qc = min(q_chunk, Sq)
    kpos = torch.arange(Skv, device=q.device)
    kf, vf = k.float(), v.float()
    outs = []
    for c0 in range(0, Sq, qc):
        qch = q[:, c0:c0 + qc]
        n = qch.shape[1]
        qpos = q_offset + c0 + torch.arange(n, device=q.device)
        s = torch.einsum("bqhgd,bkhd->bhgqk",
                         qch.float().reshape(B, n, Hkv, G, hd) * scale, kf)
        if logit_softcap > 0.0:
            s = logit_softcap * torch.tanh(s / logit_softcap)
        mask = torch.ones((n, Skv), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window > 0:
            mask &= kpos[None, :] > (qpos[:, None] - window)
        s = s.masked_fill(~mask, NEG_INF)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhgqk,bkhd->bqhgd", p, vf)
        outs.append(o.to(q.dtype))
    return torch.cat(outs, dim=1).reshape(B, Sq, Hq, vd)


def _attend(cfg, q, k, v, *, causal: bool, window: int, q_offset: int = 0):
    """Full (or chunk-against-cache) attention: the flash kernel on a CUDA
    tensor, :func:`mha_chunked` on the CPU. The scale is q's head dim's
    (MLA's (nope + rope) ** -0.5 included). Eager only: the bf16 kernel's
    launcher encodes TMA maps of the operands' addresses on the host, so a
    CUDA graph that captured this call would replay them as they were
    (``repro_torch/graphs.py``)."""
    if isinstance(q, DTensor):
        return _attend_sharded(cfg, q, k, v, causal=causal, window=window,
                               q_offset=q_offset)
    if not marks.on_card(q):
        return mha_chunked(q, k, v, causal=causal, window=window,
                           logit_softcap=cfg.attn_logit_softcap,
                           q_offset=q_offset)
    if cfg.attn_logit_softcap > 0.0:
        raise NotImplementedError(
            "the flash-attention kernel has no logit softcap (no registered "
            "config uses one)")
    if k.dtype != q.dtype:           # an f32 model over the bf16 cache: the
        k, v = k.to(q.dtype), v.to(q.dtype)   # exact widening mha_chunked does
    # MLA's v is a strided view of the expanded latent; the kernel reads
    # contiguous operands
    v = v.contiguous()
    return flash_ops.flash_attention_bshd(q, k, v, causal=causal,
                                          window=window, q_offset=q_offset)


HEADS = ("batch", None, "heads_act", None)


def _attend_sharded(cfg, q, k, v, *, causal: bool, window: int,
                    q_offset: int):
    """:func:`_attend` of DTensor operands, on each rank's local shards
    (``local_map``): batch over the data axes and heads over ``"model"``
    (``heads_act``), as q's placements resolve. The GQA ratio must be the
    same on every shard, so where the divisibility rule leaves the KV
    heads unsharded but shards q's (fewer KV heads than the model axis),
    k and v are repeated to q's head count first (each query head then
    reads its own copy of its KV head: the same attention)."""
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh

    def spec(t):
        return resolve_spec(mesh, t.shape, HEADS, ACT_RULES)
    q_spec = spec(q)
    if spec(k) != q_spec:
        r = q.shape[2] // k.shape[2]
        k, v = k.repeat_interleave(r, dim=2), v.repeat_interleave(r, dim=2)
    pl = placements(mesh, q_spec)

    def local(q, k, v):
        q, k, v = contiguous_grads(q, k, v)
        return _attend(cfg, q, k, v, causal=causal, window=window,
                       q_offset=q_offset)
    return local_map(local, out_placements=pl, in_placements=(pl, pl, pl),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)


# ------------------------------------------------------------ decode path --

def decode_attend(q, k_cache, v_cache, cur_pos, *, window: int = 0,
                  logit_softcap: float = 0.0, window_gather: bool = False,
                  scale: Optional[float] = None):
    """One-token decode. q: (B, 1, Hq, hd); caches: (B, S, Hkv, hd).

    ``cur_pos`` is a Python int shared by the batch (the eager solo
    path), a 0-d or (1,) device tensor shared by the batch (the captured
    solo step), or a (B,) tensor of per-row positions (the continuous
    scheduler's batched step). A tensor position stays on the device (no
    host sync). Reads the full cache with a position mask; a shared
    position's mask holds the same entries whatever its form, so the
    three forms compute the same result. With ``window_gather`` and
    window > 0, a Python-int position slices only the live window (same
    result, fewer bytes).
    """
    B, _, Hq, hd = q.shape
    _, S, Hkv, _ = k_cache.shape
    vd = v_cache.shape[-1]
    G = Hq // Hkv
    scale = hd ** -0.5 if scale is None else scale
    on_device = isinstance(cur_pos, torch.Tensor)
    if not on_device:
        cur_pos = int(cur_pos)
    qr = q.reshape(B, Hkv, G, hd).float() * scale

    if window_gather and 0 < window < S and not on_device:
        start = min(max(cur_pos + 1 - window, 0), S - window)
        k_cache = k_cache[:, start:start + window]
        v_cache = v_cache[:, start:start + window]
        kpos = start + torch.arange(window, device=q.device)
    else:
        kpos = torch.arange(S, device=q.device)

    s = torch.einsum("bhgd,bkhd->bhgk", qr, k_cache.float())
    if logit_softcap > 0.0:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    s = s.masked_fill(~_position_mask(kpos, cur_pos, window), NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    return o.reshape(B, 1, Hq, vd).to(q.dtype)


def _position_mask(kpos, cur_pos, window: int):
    """The decode mask over key positions ``kpos`` (S,), broadcastable
    against (B, ·, ·, S) scores: keys at or before ``cur_pos`` (a Python
    int, or a device tensor of one shared or (B,) per-row positions), and
    within ``window`` of it when window > 0."""
    if isinstance(cur_pos, torch.Tensor):
        cur = cur_pos.reshape(-1, 1)                # (B, 1) or (1, 1)
        mask = kpos[None, :] <= cur
        if window > 0:
            mask &= kpos[None, :] > (cur - window)
        return mask[:, None, None, :]
    mask = kpos <= cur_pos
    if window > 0:
        mask &= kpos > (cur_pos - window)
    return mask


# ------------------------------------------------------- paged cache ops --

def paged_update_gather(pool, row, dest_page, in_page, gather_rows):
    """Write one row per batch element into the page pool IN PLACE, then
    gather each element's full (masked) sequence extent back out.

    pool: (n_pages, page_size, *tail); row: (B, *tail) the new entry;
    dest_page/in_page: (B,) write coordinates (inactive rows land on the
    trash page, never read); gather_rows: (B, S_pad) flat pool rows.
    Returns (pool, gathered (B, S_pad, *tail)). Several inactive rows may
    write the trash page's same row: which one lands is unspecified on the
    card (an ``index_put_`` with duplicate indices), and nothing reads it.
    """
    P, pg = pool.shape[:2]
    flat = pool.view((P * pg,) + tuple(pool.shape[2:]))
    flat[dest_page * pg + in_page] = row.to(pool.dtype)
    return pool, flat[gather_rows]


# -------------------------------------------------------------- GQA block --

def attention_apply(cfg, p, x, *, positions, cache=None, cur_pos=None,
                    window: int = 0, kv_override=None, causal=True,
                    paging=None):
    """Full attention sub-layer. Returns (out, cache).

    cache: dict(k=(B, S, Hkv, hd), v=...) for this layer, or None; this
    step's k/v are written into it in place at ``cur_pos`` (a Python int,
    or for a one-token step a 0-d or (1,) int64 device tensor: the
    captured decode step writes at a device index) and the same dict is
    returned. With ``paging`` (a
    :class:`repro_torch.models.common.PageContext`: the continuous
    scheduler's batched decode step) the cache leaves are shared page
    pools (n_pages, page_size, Hkv, hd) instead, ``cur_pos`` is a per-row
    (B,) tensor, and the new k/v row goes through the slot's block table.

    kv_override: (B, Se, d) source of K and V for cross-attention (the
    whisper decoder attending over the encoder's output): no RoPE, no
    cache and no paging, never causal (``window`` keeps its meaning:
    keys at or before query position - window are masked).
    """
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    dt = x.dtype
    cross = kv_override is not None
    src = kv_override if cross else x
    Se = src.shape[1]

    q = split_last(x @ p["wq"], cfg.n_heads, hd)
    k = split_last(src @ p["wk"], cfg.n_kv_heads, hd)
    v = split_last(src @ p["wv"], cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm_simple(q, p["q_norm"])
        k = rms_norm_simple(k, p["k_norm"])
    if cfg.pos == "rope" and not cross:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    q = shard_constraint(q, HEADS)

    if cross:
        o = _attend(cfg, q, k, v, causal=False, window=window)
    elif paging is not None:
        # paged decode: one token per slot. Write the new k/v row into the
        # shared pool through the slot's block table, gather the slot's
        # full seq_len extent back, and attend with the per-row position
        # mask: masked positions (stale page contents, the zero page)
        # contribute exactly 0.0, as over the dense slot cache
        if S != 1:
            raise ValueError(f"paged attention decodes one token per slot, "
                             f"got S={S}")
        _, k_cache = paged_update_gather(cache["k"], k[:, 0],
                                         paging.dest_page, paging.in_page,
                                         paging.gather_rows)
        _, v_cache = paged_update_gather(cache["v"], v[:, 0],
                                         paging.dest_page, paging.in_page,
                                         paging.gather_rows)
        o = decode_attend(q, k_cache, v_cache, cur_pos, window=window,
                          logit_softcap=cfg.attn_logit_softcap)
    elif cache is not None:
        # write this step's k/v at cur_pos, attend over the cache
        k_cache, v_cache = cache["k"], cache["v"]
        if isinstance(cur_pos, torch.Tensor):
            # a device position (the captured decode step): the row is
            # written at a device index, with no host read
            if S != 1:
                raise ValueError(f"a device position writes one token, got "
                                 f"S={S}")
            at = cur_pos.reshape(1)
            k_cache.index_copy_(1, at, k.to(k_cache.dtype))
            v_cache.index_copy_(1, at, v.to(v_cache.dtype))
        else:
            cur_pos = int(cur_pos)
            k_cache[:, cur_pos:cur_pos + S] = k.to(k_cache.dtype)
            v_cache[:, cur_pos:cur_pos + S] = v.to(v_cache.dtype)
        if S == 1:
            o = decode_attend(q, k_cache, v_cache, cur_pos, window=window,
                              logit_softcap=cfg.attn_logit_softcap)
        else:
            # chunked prefill: the whole S-token chunk attends causally
            # over the updated cache in one pass. The causal mask offset
            # by cur_pos hides both the future and the not-yet-written
            # (zero) cache slots past cur_pos + S.
            o = _attend(cfg, q, k_cache, v_cache, causal=True, window=window,
                        q_offset=cur_pos)
    else:
        o = _attend(cfg, q, k, v, causal=causal, window=window)
    o = shard_constraint(o, HEADS)
    out = (merge_last(o) @ p["wo"]).to(dt)
    return out, cache


# -------------------------------------------------------------- MLA block --

def _mla_absorbed_decode(cfg, p, q_nope, q_rope, lat, kr, cur_pos, *,
                         window: int, scale: float):
    """Weight-absorbed MLA decode: fold W_uk into the query and W_uv into
    the output so attention runs directly against the latent cache; a
    step reads S·(r + rd) cache values instead of the expanded
    S·H·(nd + vd). In f32, as the JAX package computes it."""
    B, S1, H, nd = q_nope.shape
    r = cfg.kv_lora_rank
    vd = cfg.v_head_dim
    wkv_b = p["wkv_b"].reshape(r, H, nd + vd)
    w_uk, w_uv = wkv_b[..., :nd], wkv_b[..., nd:]

    q_lat = torch.einsum("bshn,rhn->bshr", q_nope.float(),
                         w_uk.float())                    # (B, 1, H, r)
    s = (torch.einsum("bshr,bkr->bhsk", q_lat, lat.float())
         + torch.einsum("bshd,bkd->bhsk", q_rope.float(),
                        kr.float())) * scale
    kpos = torch.arange(lat.shape[1], device=lat.device)
    s = s.masked_fill(~_position_mask(kpos, cur_pos, window), NEG_INF)
    pattn = torch.softmax(s, dim=-1)                      # (B, H, 1, S)
    ctx = torch.einsum("bhsk,bkr->bshr", pattn, lat.float())
    o = torch.einsum("bshr,rhv->bshv", ctx, w_uv.float())
    return o.to(q_nope.dtype)                             # (B, 1, H, vd)


def _mla_expand(cfg, p, latent, k_rope, dtype):
    """Expand latent -> per-head (k, v); k = [k_nope | k_rope(bcast)]. v is
    a strided view of the expanded latent (``_attend`` makes it contiguous
    for the kernel)."""
    B, S, _ = latent.shape
    H, nd, vd, rd = (cfg.n_heads, cfg.qk_nope_dim, cfg.v_head_dim,
                     cfg.qk_rope_dim)
    kv = split_last(latent @ p["wkv_b"], H, nd + vd)
    kv = shard_constraint(kv, HEADS)
    k_nope, v = kv[..., :nd], kv[..., nd:]
    k_rope_b = k_rope[:, :, None, :].expand(B, S, H, rd)
    k = torch.cat([k_nope, k_rope_b], dim=-1)
    k = shard_constraint(k, HEADS)
    return k.to(dtype), v.to(dtype)


def mla_apply(cfg, p, x, *, positions, cache=None, cur_pos=None,
              window: int = 0, paging=None):
    """DeepSeek-V3 Multi-head Latent Attention. Returns (out, cache).

    The cache {"latent": (B, S, kv_lora_rank + qk_rope_dim)} stores only
    the normed latent and the shared rope key of each token, written in
    place at ``cur_pos`` as :func:`attention_apply` writes k and v (a
    Python int; a 0-d or (1,) device tensor for the captured one-token
    step); k and v are re-expanded from it on use. With ``paging`` the
    latent leaf is the shared page pool (n_pages, page_size, width) and
    ``cur_pos`` a per-row (B,) tensor. Query and key are concatenated
    [nope | rope], so the scale (nd + rd) ** -0.5 is the attention's own
    head-dim scale (the flash kernel's at d = 192). A chunk (S > 1 with a
    cache) expands the whole cache and attends causally from ``cur_pos``;
    a one-token step expands it for :func:`decode_attend` or, with
    ``cfg.mla_absorb``, scores in latent space.
    """
    B, S, _ = x.shape
    H = cfg.n_heads
    nd, rd, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    r = cfg.kv_lora_rank
    dt = x.dtype
    scale = (nd + rd) ** -0.5

    qa = rms_norm_simple(x @ p["wq_a"], p["q_norm"])
    q = split_last(qa @ p["wq_b"], H, nd + rd)
    q_nope, q_rope = q[..., :nd], q[..., nd:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    q = torch.cat([q_nope, q_rope], dim=-1)
    q = shard_constraint(q, HEADS)

    kv_a = x @ p["wkv_a"]                                 # (B, S, r + rd)
    latent = rms_norm_simple(kv_a[..., :r], p["kv_norm"])
    k_rope = apply_rope(kv_a[..., r:], positions, cfg.rope_theta,
                        has_heads=False)                  # (B, S, rd) shared

    if paging is not None:
        # paged decode over the latent pool: the same write through the
        # block table and full-extent gather as the GQA path
        if S != 1:
            raise ValueError(f"paged MLA decodes one token per slot, got "
                             f"S={S}")
        packed = torch.cat([latent, k_rope], dim=-1)
        _, lat_cache = paged_update_gather(cache["latent"], packed[:, 0],
                                           paging.dest_page, paging.in_page,
                                           paging.gather_rows)
        o = _mla_decode(cfg, p, q, q_nope, q_rope, lat_cache, cur_pos,
                        window=window, scale=scale, dt=dt)
    elif cache is not None:
        lat_cache = cache["latent"]
        packed = torch.cat([latent, k_rope], dim=-1).to(lat_cache.dtype)
        if isinstance(cur_pos, torch.Tensor):
            # a device position (the captured decode step)
            if S != 1:
                raise ValueError(f"a device position writes one token, got "
                                 f"S={S}")
            lat_cache.index_copy_(1, cur_pos.reshape(1), packed)
        else:
            cur_pos = int(cur_pos)
            lat_cache[:, cur_pos:cur_pos + S] = packed
        if S > 1:
            # chunked prefill: expand the latent cache once and run the
            # whole chunk causally against it
            k, v = _mla_expand(cfg, p, lat_cache[..., :r].to(dt),
                               lat_cache[..., r:].to(dt), dt)
            o = _attend(cfg, q, k, v, causal=True, window=window,
                        q_offset=cur_pos)
            del k, v
        else:
            o = _mla_decode(cfg, p, q, q_nope, q_rope, lat_cache, cur_pos,
                            window=window, scale=scale, dt=dt)
    else:
        k, v = _mla_expand(cfg, p, latent, k_rope, dt)
        o = _attend(cfg, q, k, v, causal=True, window=window)
        del k, v
    o = shard_constraint(o, HEADS)
    out = (merge_last(o) @ p["wo"]).to(dt)
    return out, cache


def _mla_decode(cfg, p, q, q_nope, q_rope, lat_cache, cur_pos, *,
                window: int, scale: float, dt):
    """One-token MLA attention over a latent cache extent (B, S, r + rd):
    absorbed (``cfg.mla_absorb``) or over the expanded per-head k/v."""
    r = cfg.kv_lora_rank
    lat = lat_cache[..., :r].to(dt)
    kr = lat_cache[..., r:].to(dt)
    if cfg.mla_absorb:
        return _mla_absorbed_decode(cfg, p, q_nope, q_rope, lat, kr, cur_pos,
                                    window=window, scale=scale)
    k, v = _mla_expand(cfg, p, lat, kr, dt)
    return decode_attend(q, k, v, cur_pos, window=window, scale=scale)
