"""deepseek-v2-lite-16b — MoE with MLA [arXiv:2405.04434].

27L, d_model=2048, 16 heads, MLA kv_lora=512 (rope 64 + nope 128, v 128),
first layer dense (d_ff=10944), 26 MoE layers: 64 routed experts top-6 +
2 shared experts, expert d_ff=1408, vocab=102400.
"""
from repro_torch.configs.base import ModelConfig, register

_L = 27
CONFIG = register(ModelConfig(
    name="deepseek-v2-lite-16b",
    arch_type="moe",
    n_layers=_L,
    d_model=2048,
    vocab_size=102400,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=10944,
    block_pattern=("attn",) * _L,
    ffn_pattern=("dense",) + ("moe",) * (_L - 1),
    mla=True,
    kv_lora_rank=512,
    q_lora_rank=0,
    qk_rope_head_dim=64,
    qk_nope_head_dim=128,
    v_head_dim=128,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    moe_d_ff=1408,
    remat=True,
    source="DeepSeek-V2(-Lite) [arXiv:2405.04434]",
))
