"""Unified model API of the port: every registered ``ModelConfig`` becomes
a ``Model`` with

* ``param_specs``            — ParamSpec tree (``common.materialize`` makes
                               tensors of it)
* ``loss_fn(params, batch)`` — global-model training loss -> (loss, aux)
                               (FOO baselines use it directly; the cascade
                               partitions it)
* ``forward_fn(params, inputs)``                 -> logits
* ``decode_fn(params, inputs, caches, cur_pos)`` -> (logits, caches); the
                               caches (KV; the RWKV states of the ssm
                               family; the hybrid family's KV and SSM
                               states) are updated in place and returned
* ``input_specs(shape)``     — ParamSpec stand-ins for the data inputs of
                               a ``ShapeConfig``
* ``client_keys``            — top-level param keys forming the ZOO client
                               partition (the embedding, and the modality
                               projector where the config has a frontend)

Ported from the JAX package's ``models/model_api.py``: the decoder
families go through ``models/transformer.py`` (the multimodal one with
its vision prefix), the encoder-decoder family through
``models/encdec.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import encdec
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer
from repro_torch.models.common import ParamSpec


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    param_specs: Any
    loss_fn: Callable            # (params, batch) -> (loss, aux)
    forward_fn: Callable         # (params, inputs) -> logits
    decode_fn: Callable          # (params, inputs, caches, cur_pos) -> (logits, caches)
    client_keys: Tuple[str, ...]

    def input_specs(self, shape: ShapeConfig):
        return build_input_specs(self.cfg, shape)


def _client_keys(cfg: ModelConfig) -> Tuple[str, ...]:
    keys = ["embed"]
    if cfg.frontend_dim:
        keys.append("proj")
    return tuple(keys)


def build_model(cfg: ModelConfig, *, max_seq: int = 8192,
                window: int = 0, gather_experts: bool = False) -> Model:
    """window > 0 selects the sliding-window attention variant;
    ``gather_experts`` lets a small decode batch read only its routed
    experts' weights (``moe.moe_apply_gather``)."""
    if cfg.is_encoder_decoder:
        specs = encdec.encdec_specs(cfg, max_seq)

        def loss_fn(params, batch):
            return encdec.seq2seq_loss(cfg, params, batch, window=window)

        def forward_fn(params, inputs):
            return encdec.forward(cfg, params, inputs, window=window)[0]

        def decode_fn(params, inputs, caches, cur_pos):
            logits, new_caches, _ = encdec.forward(
                cfg, params, inputs, caches=caches, cur_pos=cur_pos,
                window=window)
            return logits, new_caches
    else:
        specs = transformer.backbone_specs(cfg, max_seq)

        def loss_fn(params, batch):
            return transformer.lm_loss(cfg, params, batch, window=window)

        def forward_fn(params, inputs):
            return transformer.forward(cfg, params, inputs, window=window)[0]

        def decode_fn(params, inputs, caches, cur_pos):
            logits, new_caches, _ = transformer.forward(
                cfg, params, inputs, caches=caches, cur_pos=cur_pos,
                window=window, gather_experts=gather_experts)
            return logits, new_caches

    return Model(cfg=cfg, param_specs=specs, loss_fn=loss_fn,
                 forward_fn=forward_fn, decode_fn=decode_fn,
                 client_keys=_client_keys(cfg))


def build_input_specs(cfg: ModelConfig,
                      shape: ShapeConfig) -> Dict[str, ParamSpec]:
    """ParamSpec dict for the *data* inputs of (cfg, shape): tokens and
    labels (B, S) for training, tokens for prefill, tokens (B, 1) for
    decode (caches come from :func:`build_cache_specs`). A VLM's text
    takes S - n_vision_tokens positions beside its ``patch_embeds``; an
    encoder-decoder's inputs add ``frames``, and at decode ``enc_out``."""
    B, S = shape.global_batch, shape.seq_len
    sp: Dict[str, ParamSpec] = {}
    if shape.is_decode:
        sp["tokens"] = ParamSpec((B, 1), "int32", ("batch", None))
        if cfg.is_encoder_decoder:
            sp["enc_out"] = ParamSpec((B, cfg.encoder_seq, cfg.d_model),
                                      "bfloat16", ("batch", None, "embed_act"))
        return sp
    s_text = S - cfg.n_vision_tokens if cfg.family == "vlm" else S
    sp["tokens"] = ParamSpec((B, s_text), "int32", ("batch", None))
    sp["labels"] = ParamSpec((B, s_text), "int32", ("batch", None))
    if cfg.family == "vlm":
        sp["patch_embeds"] = ParamSpec(
            (B, cfg.n_vision_tokens, cfg.frontend_dim), "bfloat16",
            ("batch", None, None))
    elif cfg.is_encoder_decoder:
        sp["frames"] = ParamSpec((B, cfg.encoder_seq, cfg.frontend_dim),
                                 "bfloat16", ("batch", None, None))
    if shape.kind == "prefill":
        sp.pop("labels")
    return sp


def build_cache_specs(cfg: ModelConfig, batch: int, seq: int):
    """Stacked per-layer decode state: the KV cache spec tree of the
    attention families (for the encoder-decoder family, its decoder's
    self-attention: cross-attention keeps none); for the ssm family the sequence-independent f32
    RWKV states {"wkv", "shift", "shift_c"}; for the hybrid family the
    tuple (ssm_states, attn_caches); for a ``first_k_dense`` MoE config
    {"dense": ..., "main": ...}, the attention cache cut at the first MoE
    layer (MLA's {"latent"} in each): the JAX package's layouts."""
    if cfg.family == "ssm":
        return rwkv_mod.rwkv_state_specs(cfg, batch, cfg.d_model)
    if cfg.family == "hybrid":
        n_super = cfg.n_layers // cfg.attn_every
        d_in = cfg.ssm_expand * cfg.d_model
        H = d_in // cfg.ssm_head_dim
        ssm_states = {
            "ssm": ParamSpec((n_super, cfg.attn_every, batch, H,
                              cfg.ssm_head_dim, cfg.ssm_state), "float32",
                             (None, "layers", "cache_batch", "cache_heads",
                              None, None)),
            "conv": ParamSpec((n_super, cfg.attn_every, batch,
                               ssm_mod.CONV_W - 1, d_in), "float32",
                              (None, "layers", "cache_batch", None,
                               "ssm_inner")),
        }
        hd = cfg.resolved_head_dim
        kv = ParamSpec((n_super, batch, seq, cfg.n_kv_heads, hd), "bfloat16",
                       ("layers", "cache_batch", "cache_seq", "cache_heads",
                        None))
        return (ssm_states, {"k": kv, "v": kv})
    if cfg.first_k_dense and cfg.n_experts:
        full = attn_mod.cache_specs(cfg, batch, seq)

        def split(sp: ParamSpec, n: int) -> ParamSpec:
            return ParamSpec((n,) + sp.shape[1:], sp.dtype, sp.logical,
                             sp.init, sp.scale)
        return {"dense": {k: split(v, cfg.first_k_dense)
                          for k, v in full.items()},
                "main": {k: split(v, cfg.n_layers - cfg.first_k_dense)
                         for k, v in full.items()}}
    return attn_mod.cache_specs(cfg, batch, seq)
