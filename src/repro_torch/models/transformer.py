"""Decoder-only transformer assembly: the dense attention family
(internlm2 / granite / phi3 / nemotron) and the hybrid family (zamba2: a
Mamba2 trunk with a shared attention block every ``attn_every`` layers).

Ported from the JAX package's ``models/transformer.py``. Layers are
stacked params (a leading layer axis on every block leaf, the JAX
package's layout; the hybrid trunk is stacked (n_super, attn_every, ...));
its ``lax.scan`` over them becomes a Python loop over that axis, and the
per-layer KV caches and SSM states are views into the stacked caches,
updated in place. Remat and sharding constraints have no meaning in a
forward-only port and are left out. The RWKV, MoE, MLA, multimodal and
encoder-decoder families belong to later slices and raise
``NotImplementedError``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import ParamSpec, stack_layer_specs
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
                      window=0):
    h = apply_norm(cfg, p["ln1"], x)
    a, new_cache = attn.attention_apply(
        cfg, p["attn"], h, positions=positions, cache=cache,
        cur_pos=cur_pos, window=window)
    x = x + a
    h = apply_norm(cfg, p["ln2"], x)
    return x + mlp_apply(cfg, p["mlp"], h), new_cache


def _mamba_block_apply(cfg, p, x, *, state=None):
    """A Mamba2 block; ``state`` (views into the stacked SSM state) is
    updated in place."""
    h = apply_norm(cfg, p["ln1"], x)
    s, new_state = ssm_mod.ssm_apply(cfg, p["ssm"], h, state=state)
    if state is not None:
        for name, leaf in state.items():
            leaf.copy_(new_state[name])
    return x + s


def _layer(tree, i: int):
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


# ======================================================== backbone passes ==

def backbone_apply(cfg, params, x, *, positions, caches=None, cur_pos=None,
                   window=0):
    """Run the stacked blocks. x: (B, S, d) embeddings.

    caches: {"k", "v"} stacked over layers (leading dim), or for the
    hybrid family the tuple (ssm_states, attn_caches), or None; each layer
    writes its slice in place. Returns (hidden (B, S, d), caches, aux loss
    0.0)."""
    check_family(cfg)
    if cfg.family == "hybrid":
        x = _hybrid_apply(cfg, params, x, positions=positions, caches=caches,
                          cur_pos=cur_pos, window=window)
        return x, caches, torch.zeros((), device=x.device)
    for i in range(cfg.n_layers):
        c_l = None if caches is None else _layer(caches, i)
        x, _ = _attn_block_apply(
            cfg, _layer(params["blocks"], i), x, positions=positions,
            cache=c_l, cur_pos=cur_pos, window=window)
    return x, caches, torch.zeros((), device=x.device)


def _hybrid_apply(cfg, params, x, *, positions, caches, cur_pos, window):
    """The Mamba2 trunk in super-blocks of ``attn_every`` layers, each
    followed by the shared attention block (one set of weights, its own KV
    cache slice per site)."""
    ssm_states, attn_caches = (None, None) if caches is None else caches
    for s in range(cfg.n_layers // cfg.attn_every):
        p_sup = _layer(params["blocks"], s)
        for j in range(cfg.attn_every):
            st = (None if ssm_states is None
                  else {k: v[s, j] for k, v in ssm_states.items()})
            x = _mamba_block_apply(cfg, _layer(p_sup, j), x, state=st)
        x, _ = _attn_block_apply(
            cfg, params["shared_block"], x, positions=positions,
            cache=None if attn_caches is None else _layer(attn_caches, s),
            cur_pos=cur_pos, window=window)
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
