"""Attention: GQA/MQA/MHA, causal/sliding-window, KV-cache decode.

Ported from the JAX package's ``models/attention.py`` (the non-MLA part):

* :func:`mha_chunked` — plain attention over query chunks (a full
  softmax per chunk), the JAX package's XLA path;
* :func:`decode_attend` — one new token against the cache, a masked
  einsum over the full cache (plain PyTorch, as the JAX package has no
  kernel for it), at one shared position (a Python int, the solo path)
  or at a per-row ``(B,)`` position tensor (the continuous scheduler);
* :func:`paged_update_gather` — the paged pool's in-place row write and
  the gather of each slot's whole masked extent;
* :func:`attention_apply` — the sub-layer, with its no-cache, decode
  (S = 1), chunked-prefill (S > 1 with a cache) and paged-decode
  (``paging=``) branches. On a CUDA tensor the no-cache and
  chunked-prefill branches run the hand-written flash-attention kernel
  (``repro_torch.kernels.flash_attention``); on the CPU they run
  :func:`mha_chunked`.

The KV cache and the page pool are updated in place (the JAX package
returns new ones through ``dynamic_update_slice`` and ``.at[].set`` with
donation). MLA and cross-attention (``kv_override``) belong to later
slices (``ROADMAP.md``) and raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.common import ParamSpec
from repro_torch.models.layers import apply_rope, rms_norm_simple

NEG_INF = -1e30


def _later_slice(what: str):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, Queue 1: the model-family "
        "slices)")


# ------------------------------------------------------------ param specs --

def attention_specs(cfg, d: Optional[int] = None):
    if cfg.use_mla:
        raise _later_slice("MLA attention")
    d = d or cfg.d_model
    hd = cfg.resolved_head_dim
    pd = cfg.param_dtype
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
        raise _later_slice("the MLA latent cache")
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
    tensor, :func:`mha_chunked` on the CPU. Eager only: the bf16 kernel's
    launcher encodes TMA maps of the operands' addresses on the host, so a
    CUDA graph that captured this call would replay them as they were
    (``repro_torch/graphs.py``)."""
    if not q.is_cuda:
        return mha_chunked(q, k, v, causal=causal, window=window,
                           logit_softcap=cfg.attn_logit_softcap,
                           q_offset=q_offset)
    if cfg.attn_logit_softcap > 0.0:
        raise NotImplementedError(
            "the flash-attention kernel has no logit softcap (no registered "
            "config uses one)")
    if k.dtype != q.dtype:           # an f32 model over the bf16 cache: the
        k, v = k.to(q.dtype), v.to(q.dtype)   # exact widening mha_chunked does
    return flash_ops.flash_attention_bshd(q, k, v, causal=causal,
                                          window=window, q_offset=q_offset)


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
    if on_device:
        cur = cur_pos.reshape(-1, 1)                # (B, 1) or (1, 1)
        mask = kpos[None, :] <= cur
        if window > 0:
            mask &= kpos[None, :] > (cur - window)
        mask = mask[:, None, None, :]
    else:
        mask = kpos <= cur_pos
        if window > 0:
            mask &= kpos > (cur_pos - window)
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    return o.reshape(B, 1, Hq, vd).to(q.dtype)


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
    """
    if kv_override is not None:
        raise _later_slice("cross-attention (kv_override)")
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    dt = x.dtype

    q = (x @ p["wq"]).reshape(B, S, cfg.n_heads, hd)
    k = (x @ p["wk"]).reshape(B, S, cfg.n_kv_heads, hd)
    v = (x @ p["wv"]).reshape(B, S, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm_simple(q, p["q_norm"])
        k = rms_norm_simple(k, p["k_norm"])
    if cfg.pos == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    if paging is not None:
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
    out = (o.reshape(B, S, cfg.n_heads * hd) @ p["wo"]).to(dt)
    return out, cache
