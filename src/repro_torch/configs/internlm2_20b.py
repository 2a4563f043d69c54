"""InternLM2-20B — [dense] GQA [arXiv:2403.17297].

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92544.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="internlm2-20b",
    family="dense",
    source="arXiv:2403.17297",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92544,
    act="swiglu",
    norm="rmsnorm",
    pos="rope",
)
