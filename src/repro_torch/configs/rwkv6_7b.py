"""RWKV6-7B (Finch) — [ssm] data-dependent decay linear attention
[arXiv:2404.05892].

32L d_model=4096 (attention-free) d_ff=14336 vocab=65536.
Time-mix (wkv6 with data-dependent decay w_t) + channel-mix (relu^2).
Natively sub-quadratic: long_500k decode runs on the recurrent state.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="rwkv6-7b",
    family="ssm",
    source="arXiv:2404.05892",
    n_layers=32,
    d_model=4096,
    n_heads=64,              # d_model / rwkv_head_dim
    n_kv_heads=64,
    d_ff=14336,
    vocab_size=65536,
    act="relu2",             # rwkv channel-mix uses squared relu
    norm="layernorm",
    pos="none",
    rwkv_head_dim=64,
    rwkv_chunk=32,           # fp32-safe chunk for the factored decay form
)
