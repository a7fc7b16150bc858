"""zamba2-1.2b — hybrid: Mamba2 backbone + shared attention block
[arXiv:2411.15242].

38 Mamba2 blocks, d_model=2048, ssm_state=64; ONE shared attention+MLP
block (32 heads, kv=32, d_ff=8192) invoked every 6th layer (its params are
shared across invocations and aggregated once, Alg. 1).
"""
from repro_torch.configs.base import ModelConfig, register

_L = 38
_pattern = tuple("shared_attn" if (i % 6) == 5 else "ssm" for i in range(_L))
_ffn = tuple("dense" if k == "shared_attn" else "none" for k in _pattern)

CONFIG = register(ModelConfig(
    name="zamba2-1.2b",
    arch_type="hybrid",
    n_layers=_L,
    d_model=2048,
    vocab_size=32000,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    block_pattern=_pattern,
    ffn_pattern=_ffn,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=128,
    shared_attn_every=6,
    tie_embeddings=True,
    source="Zamba2 [arXiv:2411.15242]",
))
