"""Zamba2-2.7B — [hybrid] Mamba2 backbone + shared attention blocks
[arXiv:2411.15242].

54L d_model=2560 32H (kv=32) d_ff=10240 vocab=32000, ssm_state=64.
The Mamba2 layers form the trunk; a *shared* attention+MLP block (weights
reused) is applied every ``attn_every`` layers, approximating Zamba2's two
alternating shared blocks (see DESIGN.md §8).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="zamba2-2.7b",
    family="hybrid",
    source="arXiv:2411.15242",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    act="swiglu",
    norm="rmsnorm",
    pos="rope",
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    attn_every=6,
    n_shared_blocks=1,
)
