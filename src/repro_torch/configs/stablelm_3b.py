"""stablelm-3b — dense MHA [hf:stabilityai/stablelm-2-1_6b family].

32L, d_model=2560, 32 heads (kv=32 MHA, head_dim=80), d_ff=6912,
vocab=50304.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="stablelm-3b",
    arch_type="dense",
    n_layers=32,
    d_model=2560,
    vocab_size=50304,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=6912,
    block_pattern=("attn",) * 32,
    ffn_pattern=("dense",) * 32,
    source="StableLM [hf:stabilityai/stablelm-2-1_6b]",
))
