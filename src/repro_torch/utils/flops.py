"""Size / FLOPs accounting for the CNN families: per-portion parameter
counts and the Eq.-1 inputs (|Wc|, q, Fc, Fs) for the simulator.

The per-unit forward FLOPs are the reference's own numbers, which it
takes from XLA's cost model on a per-unit lowering. The simulated clock
must match the reference exactly, and no torch counter counts the same
way (they count convolutions only), so the numbers are kept here as a
literal table (a test holds it against the reference's live values).
"""
from __future__ import annotations

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
    unit_costs = cnn_unit_costs(cfg)
    fwd = [f for f, _ in unit_costs]
    feat = unit_costs[split - 1][1] if split >= 1 else float(
        cfg.image_size ** 2 * cfg.in_channels)
    head = 2.0 * unit_costs[-1][1]
    fc = 3.0 * sum(fwd[:split])
    fs = 3.0 * (sum(fwd[split:]) + head)
    return {"wc_size": wc, "feat_size": feat, "fc": fc, "fs": fs,
            "w_size": float(sum(counts.values())),
            "f_full": 3.0 * (sum(fwd) + head)}
