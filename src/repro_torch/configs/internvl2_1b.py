"""internvl2-1b — VLM: InternViT + Qwen2-0.5B-family LM [arXiv:2404.16821].

LM backbone: 24L, d_model=896, 14 heads (GQA kv=2, head_dim=64),
d_ff=4864, vocab=151655. The InternViT vision encoder + projector is a
STUB per the brief: input_specs() provides precomputed patch embeddings
(n_frontend_tokens x d_model) prepended to the token stream.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="internvl2-1b",
    arch_type="vlm",
    n_layers=24,
    d_model=896,
    vocab_size=151655,
    n_heads=14,
    n_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    block_pattern=("attn",) * 24,
    ffn_pattern=("dense",) * 24,
    rope_theta=1_000_000.0,
    frontend="vision",
    n_frontend_tokens=256,
    tie_embeddings=True,
    source="InternVL2 [arXiv:2404.16821]",
))
