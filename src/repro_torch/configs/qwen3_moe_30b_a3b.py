"""Qwen3-30B-A3B — [moe] 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B].

48L d_model=2048 32H (GQA kv=4) per-expert d_ff=768 vocab=151936,
MoE 128e top-8, head_dim=128, qk-norm (Qwen3 family).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen3-moe-30b-a3b",
    family="moe",
    source="hf:Qwen/Qwen3-30B-A3B",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,                # unused by MoE layers (all layers are MoE)
    vocab_size=151936,
    act="swiglu",
    norm="rmsnorm",
    pos="rope",
    rope_theta=1_000_000.0,
    qk_norm=True,
    n_experts=128,
    top_k=8,
    moe_d_ff=768,
)
