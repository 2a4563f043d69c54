"""Granite-20B-Code — [dense] llama-arch-adjacent code model
[arXiv:2405.04324].

52L d_model=6144 48H (MQA kv=1) d_ff=24576 vocab=49152.
gpt-bigcode heritage: MQA, learned absolute positions, GELU, LayerNorm.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="granite-20b",
    family="dense",
    source="arXiv:2405.04324",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    act="gelu",
    norm="layernorm",
    pos="learned",
)
