"""InternVL2-26B — [vlm] InternViT + InternLM2 backbone [arXiv:2404.16821].

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553.
The InternViT-6B vision encoder is a STUB per the assignment carve-out:
``input_specs()`` provides precomputed patch embeddings (n_vision_tokens x
frontend_dim); the client-side projector maps them into the LM space.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="internvl2-26b",
    family="vlm",
    source="arXiv:2404.16821",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    act="swiglu",
    norm="rmsnorm",
    pos="rope",
    n_vision_tokens=256,
    frontend_dim=3200,      # InternViT-6B hidden size
)
