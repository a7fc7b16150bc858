"""Public int8 quantize / dequantize: arbitrary-rank tensors are flattened
and re-grouped into (n_groups, group) rows so each fp32 scale/zp pair
covers ``group`` values regardless of the tensor's last-dim width (CNN
feature maps have as few as 16 channels — per-channel-row metadata would
cost 50% of the wire).

A tensor on the card goes through the CUDA kernels, a tensor on the CPU
through their plain versions (``kernel.py``); there is no switch."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.int8_quant.kernel import (int8_dequantize_rows,
                                                   int8_quantize_rows)

GROUP = 256                     # values per scale/zp pair (8 B / 256 B)


def _as_groups(x, group: int):
    flat = x.reshape(-1).contiguous()
    g = max(1, min(group, flat.numel()))
    pad = (-flat.numel()) % g
    if pad:
        # edge-pad: zero-padding would drag the tail group's min/max
        # toward 0 and blow its quantization step ~range/254 bound
        flat = torch.cat([flat, flat[-1:].expand(pad)])
    return flat.reshape(-1, g)


def int8_quantize(x, group: int = GROUP):
    """x: any-rank float tensor -> (q int8 (R,G), scale (R,1), zp (R,1),
    orig_shape). Rows are groups of ``group`` consecutive values (the
    tail group is edge-padded on the wire)."""
    q, scale, zp = int8_quantize_rows(_as_groups(x.to(torch.float32),
                                                 group))
    return q, scale, zp, tuple(x.shape)


def int8_dequantize(q, scale, zp, shape, dtype=torch.float32):
    x = int8_dequantize_rows(q, scale, zp)
    return x.reshape(-1)[:math.prod(shape)].reshape(shape).to(dtype)
