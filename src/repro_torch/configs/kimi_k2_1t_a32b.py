"""kimi-k2-1t-a32b — trillion-parameter MoE (paper-table config)
[arXiv:2501.kimi2].

61L, d_model=7168, 64 heads (GQA kv=8, head_dim=112), MoE 384 routed
experts top-8 + 1 shared, expert d_ff=2048, first layer dense, vocab=163840.
~1T total / ~32B active parameters. bf16 params + plain SGD (the paper's
optimizer) keep the dry-run per-chip footprint feasible; expert FFN dims
additionally shard over the data axis (fsdp_ff).
"""
from repro_torch.configs.base import ModelConfig, register

_L = 61
CONFIG = register(ModelConfig(
    name="kimi-k2-1t-a32b",
    arch_type="moe",
    n_layers=_L,
    d_model=7168,
    vocab_size=163840,
    n_heads=64,
    n_kv_heads=8,
    head_dim=112,
    d_ff=18432,
    block_pattern=("attn",) * _L,
    ffn_pattern=("dense",) + ("moe",) * (_L - 1),
    n_experts=384,
    n_shared_experts=1,
    top_k=8,
    moe_d_ff=2048,
    param_dtype="bfloat16",
    fsdp_ff=True,
    remat=True,
    scan_layers=True,    # 61-layer unrolled train HLO is intractable to
                         # partition at 512 ways; see EXPERIMENTS §Perf

    source="Kimi K2 [arXiv:2501.kimi2]",
))
