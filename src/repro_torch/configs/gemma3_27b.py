"""gemma3-27b — dense, 5:1 local:global attention, 128k context
[hf:google/gemma-3-1b-pt family].

62L, d_model=5376, 32 heads (GQA kv=16, head_dim=128), d_ff=21504,
vocab=262144. Pattern: 5 sliding-window (1024) layers then 1 global layer.
long_500k decode runs via window caches (local) + sequence-sharded global
KV cache.
"""
from repro_torch.configs.base import ModelConfig, register

_L = 62
_pattern = tuple("attn" if (i % 6) == 5 else "swa" for i in range(_L))

CONFIG = register(ModelConfig(
    name="gemma3-27b",
    arch_type="dense",
    n_layers=_L,
    d_model=5376,
    vocab_size=262144,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    block_pattern=_pattern,
    ffn_pattern=("dense",) * _L,
    sliding_window=1024,
    rope_theta=1_000_000.0,
    act="gelu",
    param_dtype="bfloat16",
    remat=True,
    source="Gemma 3 [hf:google/gemma-3-1b-pt family]",
))
