"""Size / FLOPs accounting: per-portion parameter counts and the Eq.-1
inputs (|Wc|, q, Fc, Fs) for the simulator.

Transformer costs are analytic (per sample of sequence length S), the
reference's formulas term for term, so the floats are bit-equal. The
CNN per-unit forward FLOPs are the reference's own numbers, which it
takes from XLA's cost model on a per-unit lowering. The simulated clock
must match the reference exactly, and no torch counter counts the same
way (they count convolutions only), so the numbers are kept here as a
literal table (a test holds it against the reference's live values).
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.api import SplitModel, get_subtree
from repro_torch.models.params import count_params

# arch name -> ((fwd_flops, out_feature_elems) per unit), per sample
CNN_UNIT_COSTS = {
    "resnet8": (
        (995744.0, 16384.0), (9359424.0, 16384.0), (7013504.0, 8192.0),
        (6471936.0, 4096.0)),
    "vgg16": (
        (3982976.0, 65536.0), (73023616.0, 16384.0),
        (34963712.0, 32768.0), (69656832.0, 8192.0),
        (31867392.0, 16384.0), (63586816.0, 16384.0),
        (63599104.0, 4096.0), (26289152.0, 8192.0),
        (52503552.0, 8192.0), (52509696.0, 2048.0),
        (8408064.0, 2048.0), (8408064.0, 2048.0), (8409600.0, 512.0)),
    "mobilenet": (
        (1991488.0, 32768.0), (5644736.0, 65536.0), (4919808.0, 32768.0),
        (9520640.0, 32768.0), (4551680.0, 16384.0), (8932352.0, 16384.0),
        (4368384.0, 8192.0), (8640512.0, 8192.0), (8640512.0, 8192.0),
        (8640512.0, 8192.0), (8640512.0, 8192.0), (8640512.0, 8192.0),
        (4278272.0, 4096.0), (8499200.0, 4096.0)),
}


# ---------------------------------------------------------------------------
# parameter counts per segment
# ---------------------------------------------------------------------------
def segment_param_counts(model: SplitModel) -> dict:
    defs = model.defs()
    return {name: count_params(get_subtree(defs, path))
            for name, path in model.segments()}


def client_portion_size(model: SplitModel, split: int) -> float:
    counts = segment_param_counts(model)
    return float(sum(counts[n] for n in model.client_segments(split)))


def full_size(model: SplitModel) -> float:
    return float(sum(segment_param_counts(model).values()))


# ---------------------------------------------------------------------------
# forward FLOPs per unit, per sample
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


def _ssm_fwd_flops(cfg, S: int) -> float:
    d, di, N, Hs, P = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                       cfg.n_ssm_heads, cfg.ssm_head_dim)
    proj = 2 * S * d * (2 * di + 2 * N + Hs) + 2 * S * di * d
    conv = 2 * S * cfg.ssm_conv * (di + 2 * N)
    l = cfg.ssm_chunk
    # per chunk: CB^T (l²N) + W·x (l²·Hs·P) + state in/out (2·l·Hs·P·N)
    chunks = S / l
    ssd = chunks * (2 * l * l * N + 2 * l * l * Hs * P
                    + 4 * l * Hs * P * N)
    return proj + conv + ssd


def transformer_unit_flops(cfg, S: int) -> list:
    """Per-block fwd FLOPs for one sample of length S."""
    out = []
    for mixer, ffn in cfg.pattern():
        f = 0.0
        if mixer == "ssm":
            f += _ssm_fwd_flops(cfg, S)
        else:
            # 'attn' layers are global even when cfg carries a window
            # (gemma3's 5 local : 1 global pattern)
            c = (cfg if mixer == "swa"
                 else dataclasses.replace(cfg, sliding_window=0))
            f += _attn_fwd_flops(c, S)
        if ffn == "dense":
            f += _mlp_fwd_flops(cfg, S)
        elif ffn == "moe":
            f += _moe_fwd_flops(cfg, S)
        out.append(f)
    return out


def head_flops(cfg, S: int) -> float:
    return 2.0 * S * cfg.d_model * cfg.vocab_padded


def cnn_unit_costs(cfg) -> tuple:
    """(fwd_flops, out_feature_elems) per unit, per sample."""
    if cfg.name not in CNN_UNIT_COSTS:
        raise KeyError(f"no unit-cost table for arch {cfg.name!r}; "
                       f"known: {sorted(CNN_UNIT_COSTS)}")
    return CNN_UNIT_COSTS[cfg.name]


# ---------------------------------------------------------------------------
# Eq.-1 inputs for a given split
# ---------------------------------------------------------------------------
def split_costs(model: SplitModel, split: int, *, seq_len: int = 0) -> dict:
    """Per-sample Eq.-1 quantities for split s:
    wc_size (elements), feat_size q (elements/sample),
    fc / fs (fwd+bwd FLOPs per sample, bwd = 2x fwd)."""
    cfg = model.cfg
    counts = segment_param_counts(model)
    wc = client_portion_size(model, split)
    if model.is_cnn:
        unit_costs = cnn_unit_costs(cfg)
        fwd = [f for f, _ in unit_costs]
        feat = unit_costs[split - 1][1] if split >= 1 else float(
            cfg.image_size ** 2 * cfg.in_channels)
        head = 2.0 * unit_costs[-1][1]
    else:
        S = seq_len + (cfg.n_frontend_tokens if cfg.frontend else 0)
        fwd = transformer_unit_flops(cfg, S)
        feat = float(S * cfg.d_model)
        head = head_flops(cfg, S)
    fc = 3.0 * sum(fwd[:split])
    fs = 3.0 * (sum(fwd[split:]) + head)
    return {"wc_size": wc, "feat_size": feat, "fc": fc, "fs": fs,
            "w_size": float(sum(counts.values())),
            "f_full": 3.0 * (sum(fwd) + head)}


def model_flops_6nd(cfg, n_tokens: int) -> float:
    """MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE) for the roofline
    useful-compute ratio."""
    model = SplitModel(cfg)
    counts = segment_param_counts(model)
    total = sum(counts.values())
    if cfg.n_experts:
        # active = total - routed expert params + top_k/E * routed
        routed = 0
        for name, path in model.segments():
            if not name.startswith("block:"):
                continue
            i = int(name.split(":")[1])
            if cfg.pattern()[i][1] == "moe":
                E, F, d = cfg.n_experts, cfg.moe_d_ff, cfg.d_model
                routed += 3 * E * d * F
        active = total - routed + routed * cfg.top_k / cfg.n_experts
        return 6.0 * active * n_tokens
    return 6.0 * total * n_tokens
