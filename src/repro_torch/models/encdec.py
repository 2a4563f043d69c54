"""Encoder-decoder (Whisper) assembly.

The mel/conv frontend is a stub, as in the JAX package: inputs carry
precomputed frame embeddings (B, encoder_seq, frontend_dim); the client's
projector ``proj`` maps them to d_model (this projector and the decoder's
token embedding form the ZOO-updated client partition).

Serving: the encoder output is computed once before the prefill and passed
to every decode step (the ``enc_out`` input); each decoder layer's
cross-attention projects K and V from it again at every step, as the JAX
package does.

Ported from the JAX package's ``models/encdec.py`` with the same parameter
tree, in its ``(in, out)`` layout. Its ``lax.scan`` over the stacked
layers becomes a Python loop over the layer axis; with ``cfg.remat`` a
training forward recomputes each block in the backward
(``transformer._maybe_remat``). On a CUDA tensor the encoder's
self-attention (non-causal), the decoder's causal self-attention of a
training or full forward and every cross-attention call run the
hand-written flash-attention kernel; the norms are LayerNorm (plain, as
in the JAX package).
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models.common import ParamSpec, stack_layer_specs
from repro_torch.models.layers import (apply_norm, embed_lookup, norm_specs,
                                       unembed)
from repro_torch.models.mlp import mlp_apply, mlp_specs
from repro_torch.models.transformer import (_boundary, _layer, _layers,
                                            _maybe_remat, softmax_xent)
from repro_torch.sharding.rules import shard_constraint


def _enc_block_specs(cfg):
    return {"ln1": norm_specs(cfg, cfg.d_model),
            "attn": attn.attention_specs(cfg),
            "ln2": norm_specs(cfg, cfg.d_model),
            "mlp": mlp_specs(cfg, cfg.d_model, cfg.d_ff)}


def _dec_block_specs(cfg):
    return {"ln1": norm_specs(cfg, cfg.d_model),
            "attn": attn.attention_specs(cfg),
            "ln_x": norm_specs(cfg, cfg.d_model),
            "xattn": attn.attention_specs(cfg),
            "ln2": norm_specs(cfg, cfg.d_model),
            "mlp": mlp_specs(cfg, cfg.d_model, cfg.d_ff)}


def encdec_specs(cfg, max_seq: int):
    return {
        "proj": {"w": ParamSpec((cfg.frontend_dim, cfg.d_model),
                                cfg.param_dtype, ("frontend", "embed"),
                                "scaled"),
                 "b": ParamSpec((cfg.d_model,), "float32", (None,), "zeros")},
        "embed": {"table": ParamSpec((cfg.padded_vocab, cfg.d_model),
                                     cfg.param_dtype, ("vocab", "embed"))},
        "enc_pos": ParamSpec((cfg.encoder_seq, cfg.d_model), cfg.param_dtype,
                             (None, "embed")),
        "pos_embed": ParamSpec((max_seq, cfg.d_model), cfg.param_dtype,
                               ("vocab", "embed")),
        "enc_blocks": stack_layer_specs(_enc_block_specs(cfg),
                                        cfg.n_encoder_layers),
        "enc_final_norm": norm_specs(cfg, cfg.d_model),
        "blocks": stack_layer_specs(_dec_block_specs(cfg), cfg.n_layers),
        "final_norm": norm_specs(cfg, cfg.d_model),
        "lm_head": {"table": ParamSpec((cfg.padded_vocab, cfg.d_model),
                                       cfg.param_dtype, ("vocab", "embed"),
                                       "scaled")},
    }


def encode(cfg, params, frames):
    """frames (B, Se, frontend_dim) -> enc_out (B, Se, d). The frames and
    the projector's bias are rounded to bf16 first and the sum takes the
    wider of bf16 and the weights' type, as the JAX package's mixed-type
    einsum promotes."""
    w, b = params["proj"]["w"], params["proj"]["b"]
    dt = torch.promote_types(torch.bfloat16, w.dtype)
    x = (frames.to(torch.bfloat16).to(dt) @ w.to(dt)
         + b.to(torch.bfloat16).to(dt))
    x = x + params["enc_pos"][None].to(x.dtype)
    x = shard_constraint(x, ("batch", None, "embed_act"))
    positions = torch.arange(x.shape[1], device=x.device)

    def body(h, p_l):
        h = _boundary(cfg, h)
        a, _ = attn.attention_apply(cfg, p_l["attn"],
                                    apply_norm(cfg, p_l["ln1"], h),
                                    positions=positions, causal=False)
        h = h + a
        return h + mlp_apply(cfg, p_l["mlp"], apply_norm(cfg, p_l["ln2"], h))
    body = _maybe_remat(cfg, body)
    for p_l in _layers(params["enc_blocks"], cfg.n_encoder_layers):
        x = body(x, p_l)
    return apply_norm(cfg, params["enc_final_norm"], x)


def decode_blocks(cfg, params, x, enc_out, *, positions, caches=None,
                  cur_pos=None, window=0):
    """The decoder stack: causal self-attention (over the KV caches where
    given, written in place), cross-attention over ``enc_out``, the MLP.
    Returns (x, caches)."""
    def body(h, p_l, c_l):
        h = _boundary(cfg, h)
        a, _ = attn.attention_apply(
            cfg, p_l["attn"], apply_norm(cfg, p_l["ln1"], h),
            positions=positions, cache=c_l, cur_pos=cur_pos, window=window)
        h = h + a
        xa, _ = attn.attention_apply(
            cfg, p_l["xattn"], apply_norm(cfg, p_l["ln_x"], h),
            positions=positions, kv_override=enc_out)
        h = h + xa
        return h + mlp_apply(cfg, p_l["mlp"], apply_norm(cfg, p_l["ln2"], h))
    body = _maybe_remat(cfg, body, caches)
    for i, p_l in enumerate(_layers(params["blocks"], cfg.n_layers)):
        x = body(x, p_l, None if caches is None else _layer(caches, i))
    return x, caches


def forward(cfg, params, inputs, *, caches=None, cur_pos=None, window=0):
    """Training and prefill: inputs = {frames, tokens}. Decode: {tokens
    (B, 1), enc_out} with the caches, at ``cur_pos``: a Python int, or a
    0-d or (1,) int64 device tensor (the captured global decode step: no
    host read); both forms compute the same. The learned decoder
    positions are clipped to the table. Returns (logits, caches or None,
    aux 0.0)."""
    tokens = inputs["tokens"]
    if caches is None:
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        enc_out = encode(cfg, params, inputs["frames"])
    elif isinstance(cur_pos, torch.Tensor):
        cur_pos = cur_pos.reshape(1)
        positions = cur_pos
        enc_out = inputs["enc_out"]
    else:
        positions = torch.full((1,), int(cur_pos), device=tokens.device)
        enc_out = inputs["enc_out"]
    x = embed_lookup(params["embed"], tokens)
    pos_table = params["pos_embed"]
    x = x + pos_table[positions.clamp(0, pos_table.shape[0] - 1)].to(x.dtype)
    x, new_caches = decode_blocks(cfg, params, x, enc_out,
                                  positions=positions, caches=caches,
                                  cur_pos=cur_pos, window=window)
    x = apply_norm(cfg, params["final_norm"], x)
    logits = unembed(params["lm_head"], x)
    return logits, new_caches, torch.zeros((), device=logits.device)


def seq2seq_loss(cfg, params, inputs, *, window=0):
    logits, _, _ = forward(cfg, params, inputs, window=window)
    ce = softmax_xent(logits[:, :-1], inputs["labels"][:, 1:],
                      cfg.padded_vocab)
    return torch.mean(ce), {}
