"""Unified model API of the port: a decoder-only ``ModelConfig`` becomes a
``Model`` with

* ``param_specs``            — ParamSpec tree (``common.materialize`` makes
                               tensors of it)
* ``forward_fn(params, inputs)``                 -> logits
* ``decode_fn(params, inputs, caches, cur_pos)`` -> (logits, caches); the
                               caches are updated in place and returned
* ``client_keys``            — top-level param keys forming the ZOO client
                               partition (the embedding)

Ported from the JAX package's ``models/model_api.py`` for the families
``transformer.check_family`` admits; training (``loss_fn``) belongs to the
LM training slice, and the encoder-decoder family to a later one.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import transformer


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    param_specs: Any
    forward_fn: Callable         # (params, inputs) -> logits
    decode_fn: Callable          # (params, inputs, caches, cur_pos) -> (logits, caches)
    client_keys: Tuple[str, ...]


def _client_keys(cfg: ModelConfig) -> Tuple[str, ...]:
    keys = ["embed"]
    if cfg.frontend_dim:
        keys.append("proj")
    return tuple(keys)


def build_model(cfg: ModelConfig, *, max_seq: int = 8192,
                window: int = 0) -> Model:
    """window > 0 selects the sliding-window attention variant."""
    specs = transformer.backbone_specs(cfg, max_seq)

    def forward_fn(params, inputs):
        return transformer.forward(cfg, params, inputs, window=window)[0]

    def decode_fn(params, inputs, caches, cur_pos):
        logits, new_caches, _ = transformer.forward(
            cfg, params, inputs, caches=caches, cur_pos=cur_pos,
            window=window)
        return logits, new_caches

    return Model(cfg=cfg, param_specs=specs, forward_fn=forward_fn,
                 decode_fn=decode_fn, client_keys=_client_keys(cfg))


def build_cache_specs(cfg: ModelConfig, batch: int, seq: int):
    """Stacked per-layer KV cache spec tree (the attention families)."""
    transformer.check_family(cfg)
    return attn_mod.cache_specs(cfg, batch, seq)
