"""DeepSeek-V3 671B — [moe] MLA, 1 shared + 256 routed top-8, MTP
[arXiv:2412.19437].

61L d_model=7168 128H d_ff(dense)=18432 per-expert d_ff=2048 vocab=129280.
First 3 layers are dense; the rest are MoE. Attention is Multi-head Latent
Attention (MLA): the KV cache stores only the compressed latent
(kv_lora_rank + qk_rope_dim per token).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="deepseek-v3-671b",
    family="moe",
    source="arXiv:2412.19437",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,              # dense layers (first_k_dense)
    vocab_size=129280,
    act="swiglu",
    norm="rmsnorm",
    pos="rope",
    n_experts=256,
    top_k=8,
    moe_d_ff=2048,
    n_shared_experts=1,
    first_k_dense=3,
    use_mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    n_mtp=1,
)
