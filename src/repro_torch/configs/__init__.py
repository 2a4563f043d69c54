"""Configs of the port: the paper's tabular MLP, the VFL protocol, and the
registry of LM architectures (``get_config(arch_id)`` / ``--arch``), the
same entries as the JAX package's."""
from __future__ import annotations

import dataclasses

from repro_torch.configs import (
    deepseek_v3_671b,
    granite_20b,
    internlm2_20b,
    internvl2_26b,
    nemotron4_15b,
    paper_mlp,
    phi3_mini_3p8b,
    qwen3_moe_30b_a3b,
    rwkv6_7b,
    whisper_medium,
    zamba2_2p7b,
)
from repro_torch.configs.base import (INPUT_SHAPES, ModelConfig, ShapeConfig,
                                      TrainConfig, VFLConfig, reduced)

ARCH_REGISTRY: dict[str, ModelConfig] = {
    m.CONFIG.arch_id: m.CONFIG
    for m in (
        internvl2_26b,
        zamba2_2p7b,
        qwen3_moe_30b_a3b,
        deepseek_v3_671b,
        internlm2_20b,
        granite_20b,
        rwkv6_7b,
        whisper_medium,
        phi3_mini_3p8b,
        nemotron4_15b,
    )
}

PAPER_MLP = paper_mlp.CONFIG


def list_archs() -> list[str]:
    return sorted(ARCH_REGISTRY)


def get_config(arch_id: str) -> ModelConfig:
    try:
        return ARCH_REGISTRY[arch_id]
    except KeyError:
        raise KeyError(
            f"unknown arch {arch_id!r}; available: {', '.join(list_archs())}"
        ) from None


def cut_depth(cfg: ModelConfig, n_layers: int) -> ModelConfig:
    """``cfg`` cut to ``n_layers`` layers at the same width (0 keeps its
    depth). A ``first_k_dense`` config keeps its dense layers first, as
    many as fit: DeepSeek-V3 cut to 5 layers is 3 dense and 2 MoE."""
    if not n_layers:
        return cfg
    return dataclasses.replace(
        cfg, n_layers=n_layers,
        first_k_dense=min(cfg.first_k_dense, n_layers))


__all__ = ["ARCH_REGISTRY", "INPUT_SHAPES", "ModelConfig", "PAPER_MLP",
           "ShapeConfig", "TrainConfig", "VFLConfig", "cut_depth",
           "get_config", "list_archs", "reduced"]
