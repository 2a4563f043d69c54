"""Nemotron-4-15B — [dense] GQA, squared-ReLU MLP [arXiv:2402.16819].

32L d_model=6144 48H (GQA kv=8) d_ff=24576 vocab=256000.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="nemotron-4-15b",
    family="dense",
    source="arXiv:2402.16819",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=256000,
    act="relu2",
    norm="layernorm",
    pos="rope",
)
