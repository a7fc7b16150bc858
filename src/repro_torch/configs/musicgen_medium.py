"""musicgen-medium — decoder-only over EnCodec tokens [arXiv:2306.05284].

48L, d_model=1536, 24 heads (kv=24, MHA), d_ff=6144, vocab=2048 (EnCodec
codebook). The EnCodec conv codec frontend is a STUB per the brief:
input_specs() provides precomputed frame embeddings.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="musicgen-medium",
    arch_type="audio",
    n_layers=48,
    d_model=1536,
    vocab_size=2048,
    n_heads=24,
    n_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    block_pattern=("attn",) * 48,
    ffn_pattern=("dense",) * 48,
    act="gelu",
    frontend="audio",
    n_frontend_tokens=256,
    source="MusicGen [arXiv:2306.05284]",
))
