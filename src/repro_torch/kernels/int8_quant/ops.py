"""Public int8 quantize / dequantize: arbitrary-rank tensors are flattened
and re-grouped into (n_groups, group) rows so each fp32 scale/zp pair
covers ``group`` values regardless of the tensor's last-dim width (CNN
feature maps have as few as 16 channels — per-channel-row metadata would
cost 50% of the wire).

``int8_quantize_many`` / ``int8_dequantize_many`` take a list of tensors
(a model leg's leaves) and launch each kernel once for the whole list;
``int8_quantize`` / ``int8_dequantize`` are a list of one. Tensors on
the card go through the CUDA kernels, tensors on the CPU through their
plain versions (``kernel.py``); there is no switch."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.int8_quant.kernel import (int8_dequantize_segments,
                                                   int8_quantize_segments)

GROUP = 256                     # values per scale/zp pair (8 B / 256 B)


def group_size(numel: int, group: int = GROUP) -> int:
    """Values a row: ``group``, or the whole tensor when it is smaller."""
    return max(1, min(group, numel))


def int8_quantize_many(xs, group: int = GROUP):
    """xs: any-rank float tensors on one device -> [(q int8 (R,G), scale
    (R,1), zp (R,1), orig_shape)], each as ``int8_quantize`` gives it."""
    xs = list(xs)
    flats = [x.to(torch.float32).reshape(-1).contiguous() for x in xs]
    payloads = int8_quantize_segments(
        flats, [group_size(f.numel(), group) for f in flats])
    return [(q, s, z, tuple(x.shape)) for (q, s, z), x in zip(payloads, xs)]


def int8_dequantize_many(payloads, dtype=torch.float32):
    """Inverse of ``int8_quantize_many``: one tensor a payload."""
    payloads = list(payloads)
    outs = int8_dequantize_segments(
        [p[0] for p in payloads], [p[1] for p in payloads],
        [p[2] for p in payloads], [math.prod(p[3]) for p in payloads])
    return [o.reshape(p[3]).to(dtype) for o, p in zip(outs, payloads)]


def int8_quantize(x, group: int = GROUP):
    """x: any-rank float tensor -> (q int8 (R,G), scale (R,1), zp (R,1),
    orig_shape). Rows are groups of ``group`` consecutive values (the
    tail group is edge-padded on the wire)."""
    return int8_quantize_many([x], group)[0]


def int8_dequantize(q, scale, zp, shape, dtype=torch.float32):
    return int8_dequantize_many([(q, scale, zp, shape)], dtype)[0]
