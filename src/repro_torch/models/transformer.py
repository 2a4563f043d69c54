"""Decoder-only transformer assembly: the dense attention family
(internlm2 / granite / phi3 / nemotron) and the hybrid family (zamba2: a
Mamba2 trunk with a shared attention block every ``attn_every`` layers).

Ported from the JAX package's ``models/transformer.py``. Layers are
stacked params (a leading layer axis on every block leaf, the JAX
package's layout; the hybrid trunk is stacked (n_super, attn_every, ...));
its ``lax.scan`` over them becomes a Python loop over that axis, and the
per-layer KV caches and SSM states are views into the stacked caches,
updated in place. The continuous scheduler's batched decode step passes
a ``paging`` context (``models/common.PageContext``): the KV leaves are
then shared page pools, and the Mamba2 states of inactive slots stay
frozen (``freeze_state``). With ``cfg.remat``, a training forward (no caches,
grad on) recomputes each block (a hybrid super-block) in the backward,
as the JAX package's ``jax.checkpoint`` over the scan body does.
Sharding constraints have no meaning on one device and are left out.
``lm_loss`` is the training loss. The RWKV, MoE, MLA, MTP, multimodal and
encoder-decoder families belong to later slices and raise
``NotImplementedError``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.utils.checkpoint

from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (ParamSpec, freeze_state,
                                       stack_layer_specs)
from repro_torch.models.layers import (apply_norm, embed_lookup, norm_specs,
                                       unembed)
from repro_torch.models.mlp import mlp_apply, mlp_specs


def check_family(cfg) -> None:
    """Raise for the families this slice does not run."""
    if (cfg.family in ("ssm", "vlm", "audio") or cfg.n_experts
            or cfg.use_mla or cfg.first_k_dense or cfg.is_encoder_decoder
            or cfg.frontend_dim):
        raise NotImplementedError(
            f"{cfg.arch_id!r} (family {cfg.family!r}) is not ported yet: "
            "the port runs the dense attention and the hybrid families; "
            "RWKV, MoE, MLA and the multimodal families are later slices "
            "(ROADMAP.md, Queue 1)")


# ============================================================ param specs ==

def _attn_block_specs(cfg, d_ff: Optional[int] = None):
    return {"ln1": norm_specs(cfg, cfg.d_model),
            "ln2": norm_specs(cfg, cfg.d_model),
            "attn": attn.attention_specs(cfg),
            "mlp": mlp_specs(cfg, cfg.d_model, d_ff or cfg.d_ff)}


def _mamba_block_specs(cfg):
    return {"ln1": norm_specs(cfg, cfg.d_model),
            "ssm": ssm_mod.ssm_specs(cfg, cfg.d_model)}


def backbone_specs(cfg, max_seq: int):
    """Full parameter spec tree for a decoder-only config."""
    check_family(cfg)
    sp = {"embed": {"table": ParamSpec((cfg.padded_vocab, cfg.d_model),
                                       cfg.param_dtype, ("vocab", "embed"))},
          "final_norm": norm_specs(cfg, cfg.d_model),
          "lm_head": {"table": ParamSpec((cfg.padded_vocab, cfg.d_model),
                                         cfg.param_dtype, ("vocab", "embed"),
                                         "scaled")}}
    if cfg.pos == "learned":
        sp["pos_embed"] = ParamSpec((max_seq, cfg.d_model), cfg.param_dtype,
                                    ("vocab", "embed"))
    if cfg.family == "hybrid":
        n_super = cfg.n_layers // cfg.attn_every
        inner = stack_layer_specs(_mamba_block_specs(cfg), cfg.attn_every)
        sp["blocks"] = stack_layer_specs(inner, n_super)
        sp["shared_block"] = _attn_block_specs(cfg)
    else:
        sp["blocks"] = stack_layer_specs(_attn_block_specs(cfg),
                                         cfg.n_layers)
    return sp


# ============================================================== blocks =====

def _attn_block_apply(cfg, p, x, *, positions, cache=None, cur_pos=None,
                      window=0, paging=None):
    h = apply_norm(cfg, p["ln1"], x)
    a, new_cache = attn.attention_apply(
        cfg, p["attn"], h, positions=positions, cache=cache,
        cur_pos=cur_pos, window=window, paging=paging)
    x = x + a
    h = apply_norm(cfg, p["ln2"], x)
    return x + mlp_apply(cfg, p["mlp"], h), new_cache


def _mamba_block_apply(cfg, p, x, *, state=None, active=None):
    """A Mamba2 block; ``state`` (views into the stacked SSM state) is
    updated in place. With ``active`` (B,) the rows of inactive slots keep
    their state exactly (``freeze_state``)."""
    h = apply_norm(cfg, p["ln1"], x)
    s, new_state = ssm_mod.ssm_apply(cfg, p["ssm"], h, state=state)
    if state is not None:
        for name, leaf in state.items():
            new = new_state[name]
            if active is not None:
                new = freeze_state(active, new, leaf)
            leaf.copy_(new)
    return x + s


def _maybe_remat(cfg, fn, caches=None):
    """``fn`` recomputed in the backward (``torch.utils.checkpoint``,
    non-reentrant) when ``cfg.remat`` and the call can be differentiated:
    a training forward with grad on and no caches. The JAX package's
    ``"dots"`` policy (keep the weight products, recompute the rest) has
    no checkpoint counterpart in torch, so both policies recompute the
    whole block. A forward that nothing differentiates runs ``fn`` as it
    is."""
    if not cfg.remat or caches is not None or not torch.is_grad_enabled():
        return fn

    def remat(*args, **kwargs):
        return torch.utils.checkpoint.checkpoint(
            fn, *args, use_reentrant=False, **kwargs)
    return remat


def _layer(tree, i: int):
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _layers(tree, n: int):
    """The n per-layer trees of a stacked tree, as views. One ``unbind``
    per leaf: its backward stacks the n layer gradients once, where
    indexing layer by layer would give each index's backward a zero
    tensor of the whole stack to accumulate into."""
    parts = {k: _layers(v, n) if isinstance(v, dict) else v.unbind(0)
             for k, v in tree.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


# ======================================================== backbone passes ==

def backbone_apply(cfg, params, x, *, positions, caches=None, cur_pos=None,
                   window=0, paging=None):
    """Run the stacked blocks. x: (B, S, d) embeddings.

    caches: {"k", "v"} stacked over layers (leading dim), or for the
    hybrid family the tuple (ssm_states, attn_caches), or None; each layer
    writes its slice in place. ``paging`` (a ``PageContext``) switches the
    KV leaves to the paged-pool layout with per-row positions (the
    continuous scheduler's batched decode step); the recurrent state
    leaves are then slot-stacked and frozen on inactive rows. Returns
    (hidden (B, S, d), caches, aux loss 0.0)."""
    check_family(cfg)
    if cfg.family == "hybrid":
        x = _hybrid_apply(cfg, params, x, positions=positions, caches=caches,
                          cur_pos=cur_pos, window=window, paging=paging)
        return x, caches, torch.zeros((), device=x.device)

    def body(h, p_l, c_l):
        return _attn_block_apply(cfg, p_l, h, positions=positions,
                                 cache=c_l, cur_pos=cur_pos,
                                 window=window, paging=paging)[0]
    body = _maybe_remat(cfg, body, caches)
    for i, p_l in enumerate(_layers(params["blocks"], cfg.n_layers)):
        c_l = None if caches is None else _layer(caches, i)
        x = body(x, p_l, c_l)
    return x, caches, torch.zeros((), device=x.device)


def _hybrid_apply(cfg, params, x, *, positions, caches, cur_pos, window,
                  paging=None):
    """The Mamba2 trunk in super-blocks of ``attn_every`` layers, each
    followed by the shared attention block (one set of weights, its own KV
    cache slice per site)."""
    ssm_states, attn_caches = (None, None) if caches is None else caches
    active = None if paging is None else paging.active

    def super_body(h, p_sup, shared, s):
        for j, p_l in enumerate(_layers(p_sup, cfg.attn_every)):
            st = (None if ssm_states is None
                  else {k: v[s, j] for k, v in ssm_states.items()})
            h = _mamba_block_apply(cfg, p_l, h, state=st, active=active)
        h, _ = _attn_block_apply(
            cfg, shared, h, positions=positions,
            cache=None if attn_caches is None else _layer(attn_caches, s),
            cur_pos=cur_pos, window=window, paging=paging)
        return h
    super_body = _maybe_remat(cfg, super_body, caches)
    n_super = cfg.n_layers // cfg.attn_every
    for s, p_sup in enumerate(_layers(params["blocks"], n_super)):
        x = super_body(x, p_sup, params["shared_block"], s)
    return x


# ============================================================== forward ====

def embed_inputs(cfg, params, inputs, *, positions):
    """Map raw tokens -> (B, S, d) embeddings (plus the learned position
    table where the config has one). This is the CLIENT part of the
    cascade partition."""
    x = embed_lookup(params["embed"], inputs["tokens"], iota=cfg.iota_embed)
    if cfg.pos == "learned":
        pos_table = params["pos_embed"]
        pe = pos_table[positions.clamp(0, pos_table.shape[0] - 1)]
        x = x + pe.to(x.dtype)
    return x


def forward(cfg, params, inputs, *, caches=None, cur_pos=None, window=0):
    """Full forward. Training/prefill: inputs over S. Decode: S == 1, or a
    cur_pos-offset chunk (chunked prefill).

    Returns (logits (B, S, vocab), caches, aux)."""
    tokens = inputs["tokens"]
    S = tokens.shape[1]
    positions = torch.arange(S, device=tokens.device)
    if caches is not None:
        positions = positions + int(cur_pos)
    x = embed_inputs(cfg, params, inputs, positions=positions)
    h, new_caches, aux = backbone_apply(
        cfg, params, x, positions=positions, caches=caches, cur_pos=cur_pos,
        window=window)
    h = apply_norm(cfg, params["final_norm"], h)
    logits = unembed(params["lm_head"], h)
    return logits, new_caches, aux


# ================================================================= loss ====

def lm_loss(cfg, params, inputs, *, window=0, label_mask=None):
    """Next-token CE over the text positions. Returns (loss, aux_dict)."""
    logits, _, aux = forward(cfg, params, inputs, window=window)
    labels = inputs["labels"]
    ce = softmax_xent(logits[:, :-1], labels[:, 1:], cfg.padded_vocab)
    mask = (torch.ones(labels[:, 1:].shape, dtype=torch.float32,
                       device=labels.device) if label_mask is None
            else label_mask[:, 1:].float())
    loss = torch.sum(ce * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return loss + aux, {"aux": aux}


def softmax_xent(logits, labels, vocab):
    """Stable CE in the JAX package's masked-reduction form (log-sum-exp
    minus the gold logit picked by an iota compare), in f32."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    vidx = torch.arange(logits.shape[-1], device=logits.device)
    gold = torch.sum(torch.where(vidx == labels[..., None].long(), logits,
                                 0.0), dim=-1)
    return lse - gold
