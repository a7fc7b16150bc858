"""Device heterogeneity simulation — Table 1 grid + the Eq. 1 round clock.

    T = (2|Wc| + 2 p q) / R + Fc / Comp_c + Fs / Comp_s          (Eq. 1)

|Wc| is the client portion size (elements), q the per-sample feature size
at the cut, p the local sample count this round, Fc/Fs the client/server
fwd+bwd FLOPs. Comm overhead (Table 3's "Comm." column) counts model
down+upload and feature/gradient exchange.

Unit convention follows the paper's: sizes in elements, rates in
elements/sec, FLOPS in FLOP/sec — the Table 1 magnitudes reproduce the
paper's regime directly.
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np

# Table 1
FLOPS_SETTINGS = {"low": 5e9, "mid": 1e10, "high": 2e10}
RATE_SETTINGS = {"low": 1e6, "mid": 2e6, "high": 5e6}
SERVER_FLOPS = 5e10
SERVER_RATE = 1e7

# repro_torch.comm byte convention: rates stay in Table-1 elements/s; byte
# accounting treats one fp32 element as 4 bytes (comm/README.md).
BYTES_PER_ELEM = 4.0

# Phase split of the client fwd+bwd FLOPs Fc: the forward pass (before
# the feature upload) is ~1/3, the backward (after the gradient
# download) ~2/3 — the standard bwd ≈ 2x fwd accounting that
# utils/flops.py already uses for Fc itself.
CLIENT_FWD_FRAC = 1.0 / 3.0


@dataclasses.dataclass(frozen=True)
class Device:
    cid: int
    comp: float                    # FLOP/s
    rate: float                    # elements/s


def make_device_grid(n_devices: int, seed: int = 0,
                     composition=None) -> list:
    """The paper's 9 device kinds = 3 FLOPS x 3 transfer rates (Table 1),
    assigned round-robin (uncorrelated, as in §5.1). `composition` can
    reweight qualities, e.g. {'high': 5, 'mid': 3, 'low': 2} (Fig. 6)."""
    rng = np.random.default_rng(seed)
    if composition is None:
        kinds = list(itertools.product(FLOPS_SETTINGS, RATE_SETTINGS))
        picks = [kinds[i % len(kinds)] for i in range(n_devices)]
    else:
        quals = list(composition)
        weights = np.array([composition[q] for q in quals], float)
        weights /= weights.sum()
        fq = rng.choice(quals, size=n_devices, p=weights)
        rq = rng.choice(quals, size=n_devices, p=weights)
        picks = list(zip(fq, rq))
    rng.shuffle(picks)
    return [Device(cid=i, comp=FLOPS_SETTINGS[f], rate=RATE_SETTINGS[r])
            for i, (f, r) in enumerate(picks)]


@dataclasses.dataclass
class RoundCost:
    time: float = 0.0              # wall (max over devices)
    comm: float = 0.0              # total elements transferred
    device_times: dict = dataclasses.field(default_factory=dict)


def device_round_time_bytes(dev: Device, *, comm_bytes: float, fc: float,
                            fs: float, rate: float = None) -> float:
    """Eq. 1 with channel-metered payloads: comm_bytes is the full wire
    traffic for this device-round (2|Wc| dispatch + encoded features +
    encoded gradients), ``rate`` the link model's elements/s at the
    current clock (None -> the device's static Table-1 rate)."""
    r = (dev.rate if rate is None else rate) * BYTES_PER_ELEM
    return comm_bytes / r + fc / dev.comp + fs / SERVER_FLOPS


def fedavg_round_time(dev: Device, *, w_size: float, p: int,
                      f_full: float) -> float:
    """FedAvg baseline: full model both ways, all compute on device."""
    return 2.0 * w_size / dev.rate + p * f_full / dev.comp


def fedavg_round_time_bytes(dev: Device, *, comm_bytes: float, p: int,
                            f_full: float, rate: float = None) -> float:
    """FedAvg round time from channel-priced model-leg bytes (the
    compressed-FedAvg baseline; fp32 bytes reproduce fedavg_round_time
    exactly — both scale by powers of two)."""
    r = (dev.rate if rate is None else rate) * BYTES_PER_ELEM
    return comm_bytes / r + p * f_full / dev.comp


def fedavg_round_comm_bytes(*, w_size: float) -> float:
    return 2.0 * w_size * BYTES_PER_ELEM
