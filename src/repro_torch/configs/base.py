"""Config system: ModelConfig (decoder-style models), CNNConfig, the
transport and round-loop knobs, the registry and reduced variants.

Every architecture has one file in this package exporting ``CONFIG``;
the registry maps the public ``--arch`` id to it. ``ModelConfig`` keeps
every field of the reference's, the SPMD and MoE ones included, so a
config carries across unchanged.
"""
from __future__ import annotations

import dataclasses


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Configuration for a decoder-style model (dense / moe / ssm / hybrid /
    vlm / audio backbones)."""

    name: str
    arch_type: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    vocab_size: int
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    # Per-layer mixer pattern; entries: 'attn' | 'swa' | 'ssm' | 'shared_attn'.
    # FFN kind per layer: 'dense' | 'moe' | 'none' (parallel list, same length).
    block_pattern: tuple = ()
    ffn_pattern: tuple = ()
    # attention
    rope_theta: float = 10000.0
    sliding_window: int = 0             # window size for 'swa' blocks
    # MLA (deepseek-style latent attention)
    mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_rope_head_dim: int = 0
    qk_nope_head_dim: int = 0
    v_head_dim: int = 0
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    router_aux_coef: float = 0.001
    moe_dispatch_shards: int = 0        # >1: shard-local dispatch
    moe_dispatch_axes: tuple = ()       # mesh axes of the shard dim
    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 128
    # shared-attention hybrid (zamba2-style): one shared block reused every
    # `shared_attn_every` layers.
    shared_attn_every: int = 0
    # misc
    act: str = "silu"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"             # activation / compute dtype
    param_dtype: str = "float32"
    remat: bool = False                 # recompute each block in training
    remat_policy: str = ""              # '' (full) | 'dots'
    scan_layers: bool = False           # scan over identical-block runs
    # 'xla' | 'pallas': 'pallas' routes prefill attention, the SSD scan
    # and the MoE expert FFN through the hand-written kernels (CUDA on a
    # CUDA tensor, their plain versions on a CPU tensor); 'xla' runs the
    # plain counterpart of the reference's XLA path
    attn_impl: str = "xla"
    # modality frontend stub ('' | 'audio' | 'vision'): precomputed
    # frame/patch embeddings of shape (B, n_prefix, d_model).
    frontend: str = ""
    n_frontend_tokens: int = 0
    # sharding hints (the SPMD layer, a later slice)
    fsdp_ff: bool = False
    source: str = ""                    # citation / model card

    # ---- derived ----
    @property
    def vocab_padded(self) -> int:
        return _round_up(self.vocab_size, 128)

    @property
    def d_inner(self) -> int:           # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    @property
    def qk_head_dim(self) -> int:
        if self.mla:
            return self.qk_rope_head_dim + self.qk_nope_head_dim
        return self.head_dim

    def __post_init__(self):
        if self.block_pattern:
            if (len(self.block_pattern) != self.n_layers
                    or len(self.ffn_pattern) != self.n_layers):
                raise ValueError(f"{self.name}: block/ffn pattern length "
                                 f"!= n_layers")
        if self.ssm_state and self.d_inner % self.ssm_head_dim:
            raise ValueError(f"{self.name}: d_inner % ssm_head_dim != 0")

    def pattern(self):
        """(mixer, ffn) kind per layer, defaulting to all-attn/all-dense."""
        bp = self.block_pattern or ("attn",) * self.n_layers
        fp = self.ffn_pattern or ("dense",) * self.n_layers
        return tuple(zip(bp, fp))


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    """Paper-native CNN configs (ResNet8 / VGG16 / MobileNet on CIFAR)."""

    name: str
    family: str                         # resnet | vgg | mobilenet
    n_classes: int = 10
    in_channels: int = 3
    image_size: int = 32
    width_mult: float = 1.0
    # family-specific stage description, consumed by models/cnn.py
    stages: tuple = ()
    source: str = ""
    arch_type: str = "cnn"
    dtype: str = "float32"
    param_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class CommConfig:
    """Transport knobs for the cut-layer exchange (repro_torch.comm).

    ``uplink_codec`` compresses uplink features, ``downlink_codec`` the
    downlink feature-gradients ('' -> same as uplink), and
    ``dispatch_codec`` the model legs (Wc dispatch/collect, and the
    FedAvg broadcast + QSGD-style update upload). ``codec`` /
    ``grad_codec`` are the original names for the first two and remain
    the storage fields; the ``*_codec`` aliases override them when set.
    ``error_feedback`` turns on the channel's per-(device, tensor)
    residual accumulators (compression error is added back before the
    next round's encode); ``topk_frac`` sets the kept fraction of the
    'topk'/'randk' sparsifiers. ``link`` selects the rate model:
    'static' (Table 1) or 'trace' (time-varying multiplier schedule —
    inline via trace_* fields or a JSON file).
    ``latency`` adds a per-message delay (four messages per
    device-round); with a non-constant ``latency_dist`` each
    device-round draws its own latency around that mean (uniform /
    lognormal / exp, spread ``latency_jitter``, deterministic per
    (latency_seed, device, round)). ``uplink_capacity`` bounds the Main
    Server's shared ingress and ``downlink_capacity`` its shared egress
    (Table-1 elements/s, 0 = uncontended) — concurrent uploads and
    dfx downloads in the phase pipeline then contend for them under the
    same max-min fair fluid schedule, with in-flight flows carried
    across aggregation windows."""

    codec: str = "fp32"                 # fp32|bf16|fp16|int8|topk|randk
    grad_codec: str = ""                # '' -> follow codec
    uplink_codec: str = ""              # alias: overrides codec when set
    downlink_codec: str = ""            # alias: overrides grad_codec
    dispatch_codec: str = "fp32"        # model legs (Wc / FedAvg W)
    error_feedback: bool = False        # residual accumulators on
    topk_frac: float = 0.1              # kept fraction for topk/randk
    link: str = "static"                # static | trace
    trace_times: tuple = ()             # ascending, starts at 0.0
    trace_multipliers: tuple = ()       # same length, > 0
    trace_period: float = 0.0           # 0 -> trace_times[-1]
    trace_phase_per_device: bool = True
    trace_file: str = ""                # JSON overrides the inline trace
    latency: float = 0.0                # seconds per message (the mean)
    latency_dist: str = "constant"      # constant|uniform|lognormal|exp
    latency_jitter: float = 0.5         # spread of the non-constant dists
    latency_seed: int = 0               # latency draw stream seed
    uplink_capacity: float = 0.0        # shared elements/s; 0 = off
    downlink_capacity: float = 0.0      # shared egress; 0 = off


@dataclasses.dataclass(frozen=True)
class DriverConfig:
    """Round-loop execution knobs (repro_torch.core.driver.RoundDriver).

    ``exec_mode='sync'`` is the paper's Eq.-1 barrier (the round clock
    advances by the max participant time). ``'semi_async'`` turns device
    completions into heap events: the aggregation window closes at a
    ``quorum`` fraction of this round's arrivals and stragglers commit
    up to ``staleness_cap`` rounds late (0 degenerates to sync).
    ``predictive`` makes the sliding scheduler re-price its EMA table
    with the link model's rate over the projected completion window.
    ``pipeline`` splits each device-round into upload / server-compute /
    download phase events: a group's update commits when its server
    backward finishes (downloads drain in the background), and
    concurrent uploads contend for ``CommConfig.uplink_capacity``.
    ``server_concurrency`` bounds the Main Server GPU to that many
    concurrent group backwards (FIFO queue; 0 = unbounded, the
    free-overlap regime) and ``gate_redispatch`` makes a device wait
    out its own draining download before it can start the next round's
    upload — both only observable under ``pipeline``.
    ``resource_aware``, ``auto_knobs``, ``fleet_size``, ``clusters``
    and ``cluster_quorum`` select the control plane, the batched fleet
    and hierarchical aggregation, whose modules are not ported yet: the
    engine refuses any non-default value of them."""

    exec_mode: str = "sync"             # sync | semi_async
    staleness_cap: int = 1              # max rounds an update may lag
    quorum: float = 0.5                 # window-close arrival fraction
    predictive: bool = False            # link-aware split forecasts
    pipeline: bool = False              # phase-level event pipeline
    server_concurrency: int = 0         # server backward slots; 0 = inf
    gate_redispatch: bool = False       # wait out own draining download
    resource_aware: bool = False        # physics-priced split forecasts
    auto_knobs: bool = False            # probe quorum/staleness pairs
    fleet_size: int = 0                 # batched population (0 = object grid)
    clusters: int = 0                   # edge clusters (<=1 = flat window)
    cluster_quorum: float = 1.0         # per-cluster close quantile


def make_reduced(cfg: ModelConfig, *, n_layers: int = 2, d_model: int = 256,
                 vocab: int = 512) -> ModelConfig:
    """Reduced same-family variant for CPU smoke tests (<=2 layers,
    d_model<=512, <=4 experts)."""
    d_model = min(d_model, cfg.d_model)
    scale = d_model / cfg.d_model

    def sc(x, m=8):
        return max(m, _round_up(int(x * scale), m)) if x else 0

    n_heads = max(2, min(cfg.n_heads, d_model // 64)) if cfg.n_heads else 0
    head_dim = 64 if cfg.n_heads else 0
    n_kv = 0
    if cfg.n_kv_heads:
        n_kv = max(1, n_heads * cfg.n_kv_heads // max(cfg.n_heads, 1))
        while n_heads % n_kv:
            n_kv -= 1
    bp = cfg.block_pattern and _reduce_pattern(cfg.block_pattern, n_layers)
    fp = cfg.ffn_pattern and _reduce_pattern(cfg.ffn_pattern, n_layers)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-reduced",
        n_layers=n_layers,
        d_model=d_model,
        vocab_size=min(cfg.vocab_size, vocab),
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=head_dim,
        d_ff=sc(cfg.d_ff, 16),
        block_pattern=tuple(bp),
        ffn_pattern=tuple(fp),
        kv_lora_rank=sc(cfg.kv_lora_rank, 8),
        q_lora_rank=sc(cfg.q_lora_rank, 8),
        qk_rope_head_dim=32 if cfg.mla else 0,
        qk_nope_head_dim=32 if cfg.mla else 0,
        v_head_dim=64 if cfg.mla else 0,
        n_experts=min(cfg.n_experts, 4),
        n_shared_experts=min(cfg.n_shared_experts, 1),
        top_k=min(cfg.top_k, 2),
        moe_d_ff=sc(cfg.moe_d_ff, 16),
        ssm_state=min(cfg.ssm_state, 32),
        ssm_head_dim=(min(cfg.ssm_head_dim, 32) if cfg.ssm_state
                      else cfg.ssm_head_dim),
        ssm_chunk=32,
        shared_attn_every=(min(cfg.shared_attn_every, 2)
                           if cfg.shared_attn_every else 0),
        sliding_window=(min(cfg.sliding_window, 64) if cfg.sliding_window
                        else 0),
        n_frontend_tokens=(min(cfg.n_frontend_tokens, 16) if cfg.frontend
                           else 0),
        remat=False,
        dtype="float32",
    )


def _reduce_pattern(pattern, n_layers):
    """Keep the flavour of a layer pattern in n_layers slots (ensure at least
    one of each distinct kind appears when possible)."""
    kinds = []
    for k in pattern:
        if k not in kinds:
            kinds.append(k)
    out = list(kinds[:n_layers])
    while len(out) < n_layers:
        out.append(pattern[len(out) % len(pattern)])
    return tuple(out[:n_layers])


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
_REGISTRY: dict = {}


def register(cfg):
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str):
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs():
    _ensure_loaded()
    return sorted(_REGISTRY)


_LOADED = False


def _ensure_loaded():
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    from repro_torch.configs import (  # noqa: F401
        deepseek_v2_lite_16b, gemma3_27b, h2o_danube3_4b, internlm2_1p8b,
        internvl2_1b, kimi_k2_1t_a32b, mamba2_2p7b, mobilenet,
        musicgen_medium, resnet8, stablelm_3b, vgg16, zamba2_1p2b)
