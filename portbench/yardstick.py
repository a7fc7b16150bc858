"""The yardstick: the card's peaks, the analytic operation counts of a
model step, each hand-written kernel's least time, and the kernel-name
groups a trace is read by.

The transformer FLOP formulas are a copy of ``repro_torch/utils/flops.py``
(kept here so that a later change to the port cannot move the yardstick);
the kernel groups are those of ``chip_smoke.py``. Configurations are read
through their fields only (``n_layers``, ``d_model``, ...), never through
the port's code.
"""
from __future__ import annotations

import dataclasses
import math

# NVIDIA H100 SXM data sheet, dense, at its 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

# kernel groups by name, first match wins: the port's hand-written CUDA
# kernels (csrc/*.cu), then cuBLAS / CUTLASS matrix products; whatever no
# group names is glue (elementwise, reductions, copies, indexing)
HAND_WRITTEN = (
    ("flash", ("flash_fwd",)),
    ("moe_gmm", ("::gmm_",)),
    ("int8", ("quantize_segments",)),
    ("ssd_scan", ("ssd_scan",)),
    ("comm_fused", ("roundtrip_kernel", "sparse_combine")),
)
GEMM = ("gemm", "cutlass", "xmma", "nvjet")


def kernel_group(name: str) -> str:
    """'flash' | 'moe_gmm' | 'int8' | 'ssd_scan' | 'comm_fused' | 'gemm'
    | 'glue' of a device kernel's name."""
    for group, keys in HAND_WRITTEN:
        if any(k in name for k in keys):
            return group
    low = name.lower()
    if any(k in low for k in GEMM):
        return "gemm"
    return "glue"


# ---------------------------------------------------------------------------
# copy of repro_torch/utils/flops.py: forward FLOPs per sample of length S
# ---------------------------------------------------------------------------
def _attn_fwd_flops(cfg, S: int) -> float:
    d, H = cfg.d_model, cfg.n_heads
    if cfg.mla:
        Dn, Dr, Dv, R = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                         cfg.v_head_dim, cfg.kv_lora_rank)
        proj = 2 * S * d * (H * (Dn + Dr) + R + Dr) \
            + 2 * S * R * H * (Dn + Dv) + 2 * S * H * Dv * d
        attn = 4 * S * S * H * (Dn + Dr) / 2            # causal half
        return proj + attn
    K, D = cfg.n_kv_heads, cfg.head_dim
    proj = 2 * S * d * D * (H + 2 * K) + 2 * S * H * D * d
    eff = min(S, cfg.sliding_window) if cfg.sliding_window else S
    attn = 4 * S * eff * H * D / (1 if cfg.sliding_window else 2)
    return proj + attn


def _mlp_fwd_flops(cfg, S: int) -> float:
    return 6.0 * S * cfg.d_model * cfg.d_ff


def _moe_fwd_flops(cfg, S: int) -> float:
    routed = 6.0 * S * cfg.d_model * cfg.moe_d_ff * cfg.top_k
    shared = 6.0 * S * cfg.d_model * cfg.moe_d_ff * cfg.n_shared_experts
    router = 2.0 * S * cfg.d_model * cfg.n_experts
    return routed + shared + router


def transformer_unit_flops(cfg, S: int) -> list:
    """Per-block forward FLOPs for one sample of length S (attention and
    MLP / MoE blocks; the benchmark's configurations have no SSM)."""
    out = []
    for mixer, ffn in cfg.pattern():
        if mixer not in ("attn", "swa"):
            raise ValueError(f"no FLOP count for mixer {mixer!r}")
        c = (cfg if mixer == "swa"
             else dataclasses.replace(cfg, sliding_window=0))
        f = _attn_fwd_flops(c, S)
        if ffn == "dense":
            f += _mlp_fwd_flops(cfg, S)
        elif ffn == "moe":
            f += _moe_fwd_flops(cfg, S)
        out.append(f)
    return out


def head_flops(cfg, S: int) -> float:
    return 2.0 * S * cfg.d_model * vocab_padded(cfg)


# ---------------------------------------------------------------------------
# useful work of a step (the numerator of step_mfu)
# ---------------------------------------------------------------------------
def qk_dim(cfg) -> int:
    return (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim if cfg.mla
            else cfg.head_dim)


def v_dim(cfg) -> int:
    return cfg.v_head_dim if cfg.mla else cfg.head_dim


def vocab_padded(cfg) -> int:
    """The vocabulary as the port lays out its embedding and head: rounded
    up to a multiple of 128."""
    return -(-cfg.vocab_size // 128) * 128


def causal_pairs(S: int) -> int:
    """(query, key) pairs a causal mask keeps over S positions."""
    return S * (S + 1) // 2


def attention_core_flops(cfg, batch: int, S: int) -> float:
    """QK^T and PV of one causal forward over all layers: 2·B·H·P·(d_qk +
    d_v) a layer, P the kept pairs."""
    d_qk, d_v = qk_dim(cfg), v_dim(cfg)
    return float(cfg.n_layers * 2 * batch * cfg.n_heads * causal_pairs(S)
                 * (d_qk + d_v))


def body_params(cfg) -> float:
    """Parameters a token's forward multiplies by, outside the embedding
    table and the head: every block's, with each MoE layer's routed
    experts counted at top_k / n_experts."""
    d = cfg.d_model
    total = 0.0
    for _, ffn in cfg.pattern():
        if cfg.mla:
            H, R = cfg.n_heads, cfg.kv_lora_rank
            Dn, Dr, Dv = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                          cfg.v_head_dim)
            attn = (d * H * (Dn + Dr) + d * R + d * Dr + R * H * (Dn + Dv)
                    + H * Dv * d)
        else:
            H, K, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
            attn = d * D * (H + 2 * K) + H * D * d
        if ffn == "dense":
            mlp = 3 * d * cfg.d_ff
        elif ffn == "moe":
            F = cfg.moe_d_ff
            mlp = (d * cfg.n_experts                          # router
                   + 3 * d * F * cfg.n_shared_experts
                   + 3 * d * F * cfg.top_k)
        else:
            mlp = 0
        total += attn + mlp
    return float(total)


def prefill_flops(cfg, batch: int, S: int) -> float:
    """Useful FLOPs of one prefill: 2·N_body a token, the causal attention
    core, and the head at the last position only (as ``prefill`` runs
    it)."""
    return (2.0 * body_params(cfg) * batch * S
            + attention_core_flops(cfg, batch, S)
            + 2.0 * batch * cfg.d_model * vocab_padded(cfg))


def train_flops(cfg, n_seqs: int, S: int) -> float:
    """Useful FLOPs of training on n_seqs sequences of length S, forward
    and backward: 6·N·D over the blocks and the head (the embedding is a
    lookup), and three times the forward attention core."""
    tokens = n_seqs * S
    n = body_params(cfg) + cfg.d_model * vocab_padded(cfg)
    return 6.0 * n * tokens + 3.0 * attention_core_flops(cfg, n_seqs, S)


# ---------------------------------------------------------------------------
# kernels' least times (roofline bounds)
# ---------------------------------------------------------------------------
def least_time(flops: float, nbytes: float) -> float:
    """Seconds: the larger of the operations at the bf16 peak and the
    bytes at the HBM peak."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def flash_least_time(cfg, batch: int, S: int, act_bytes: int = 2) -> float:
    """One causal prefill attention call of one layer: 2·B·H·P·(d_qk +
    d_v) operations; q, k, v read once and o written once in the
    activations' dtype (k, v at the kv heads' count)."""
    H = cfg.n_heads
    d_qk, d_v = qk_dim(cfg), v_dim(cfg)
    kv = H if cfg.mla else cfg.n_kv_heads
    flops = 2.0 * batch * H * causal_pairs(S) * (d_qk + d_v)
    nbytes = act_bytes * batch * S * (H * d_qk + kv * d_qk + kv * d_v
                                      + H * d_v)
    return least_time(flops, nbytes)


def moe_gmm_least_time(cfg, tokens: int, act_bytes: int = 2,
                       weight_bytes: int = 4) -> float:
    """One MoE layer's expert FFN (gate, up, down) over the R = T·top_k
    routed entries: 6·R·d·F operations; the routed rows read once and the
    outputs written once in the activations' dtype, every expert's three
    weights read once in their stored dtype. R is the routed entries,
    not the padded capacity E·C that the kernel is launched over."""
    R = tokens * cfg.top_k
    d, F, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    flops = 6.0 * R * d * F
    nbytes = 2 * act_bytes * R * d + weight_bytes * 3 * E * d * F
    return least_time(flops, nbytes)


def n_moe_layers(cfg) -> int:
    return sum(1 for _, f in cfg.pattern() if f == "moe")


def pct(x: float) -> float:
    """A share as a percentage, unrounded; NaN and infinities refused."""
    if not math.isfinite(x):
        raise ValueError(f"not a finite share: {x}")
    return 100.0 * x
