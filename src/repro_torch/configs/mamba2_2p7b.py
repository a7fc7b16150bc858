"""mamba2-2.7b — SSD (state-space duality) [arXiv:2405.21060].

Attention-free: 64 Mamba2 (SSD) blocks, d_model=2560, ssm_state=128,
expand=2 (d_inner=5120), head_dim=64 -> 80 SSD heads, vocab 50280.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-2.7b",
    arch_type="ssm",
    n_layers=64,
    d_model=2560,
    vocab_size=50280,
    d_ff=0,
    block_pattern=("ssm",) * 64,
    ffn_pattern=("none",) * 64,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=128,
    tie_embeddings=True,
    remat=True,
    source="SSD / Mamba2 [arXiv:2405.21060]",
))
