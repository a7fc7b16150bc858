"""Config system: the CNN model config, the transport and round-loop
knobs, and the registry.

Each paper-native CNN architecture (ResNet8 / VGG16 / MobileNet) has one
file in this package exporting ``CONFIG``; the registry maps the public
``--arch`` id to it. The decoder-style model families (``ModelConfig``)
are not ported yet: their ids are known so that asking for one fails
with a clear message instead of an unknown-arch error.
"""
from __future__ import annotations

import dataclasses

# decoder-style architectures of the reference whose model stack is not
# ported yet (the LM families)
LM_ARCHS = ("deepseek-v2-lite-16b", "gemma3-27b", "h2o-danube-3-4b",
            "internlm2-1.8b", "internvl2-1b", "kimi-k2-1t-a32b",
            "mamba2-2.7b", "musicgen-medium", "stablelm-3b",
            "zamba2-1.2b")


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


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
_REGISTRY: dict = {}


def register(cfg):
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str):
    _ensure_loaded()
    if name in LM_ARCHS:
        raise NotImplementedError(
            f"arch {name!r} is an LM family, which is not yet ported "
            f"(slice 2); ported archs: {sorted(_REGISTRY)}")
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
    from repro_torch.configs import mobilenet, resnet8, vgg16  # noqa: F401
