"""internlm2-1.8b — dense GQA [arXiv:2403.17297].

24L, d_model=2048, 16 heads (GQA kv=8, head_dim=128), d_ff=8192,
vocab=92544.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="internlm2-1.8b",
    arch_type="dense",
    n_layers=24,
    d_model=2048,
    vocab_size=92544,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    block_pattern=("attn",) * 24,
    ffn_pattern=("dense",) * 24,
    rope_theta=1_000_000.0,
    source="InternLM2 [arXiv:2403.17297]",
))
