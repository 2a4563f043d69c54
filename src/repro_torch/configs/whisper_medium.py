"""Whisper-medium — [audio] encoder-decoder, conv frontend (STUB)
[arXiv:2212.04356].

24L(enc)+24L(dec) d_model=1024 16H d_ff=4096 vocab=51865.
The mel-spectrogram + conv feature extractor is a STUB per the assignment
carve-out: ``input_specs()`` provides precomputed frame embeddings
(encoder_seq x frontend_dim); the client-side projector maps them to
d_model. long_500k is SKIPPED for this arch (enc-dec; see DESIGN.md).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-medium",
    family="audio",
    source="arXiv:2212.04356",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    act="gelu",
    norm="layernorm",
    pos="learned",
    is_encoder_decoder=True,
    n_encoder_layers=24,
    encoder_seq=1500,
    frontend_dim=1024,       # conv-stub output dim (== d_model for whisper)
)
