"""h2o-danube-3-4b — llama+mistral mix with sliding-window attention
[arXiv:2401.16818].

24L, d_model=3840, 32 heads (GQA kv=8, head_dim=120), d_ff=10240,
vocab=32000, SWA window 4096 (mistral-style) -> eligible for long_500k.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="h2o-danube-3-4b",
    arch_type="dense",
    n_layers=24,
    d_model=3840,
    vocab_size=32000,
    n_heads=32,
    n_kv_heads=8,
    head_dim=120,
    d_ff=10240,
    block_pattern=("swa",) * 24,
    ffn_pattern=("dense",) * 24,
    sliding_window=4096,
    source="H2O-Danube(-3) [arXiv:2401.16818]",
))
