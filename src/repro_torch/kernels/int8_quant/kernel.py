"""Int8 affine quantize / dequantize of (R, G) group rows.

    q  = clip(round(x / scale + zp), -127, 127)        int8
    x' = scale * (q - zp)                              dequant

with ``scale = max((mx - mn) / 254, 1e-12)`` and ``zp = -127 - mn /
scale`` per row. On a CUDA tensor each wrapper launches its hand-written
Hopper kernel (``csrc/int8_quant.cu``) or raises; on a CPU tensor it
runs the plain PyTorch version beside it, which is the same arithmetic
in the same order. ``LAUNCHES`` counts kernel launches per wrapper.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_QMAX = 127.0
_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIGNATURES = {
    "int8_quantize": [_P, _P, _P, _P, _LL, _I, _P],
    "int8_dequantize": [_P, _P, _P, _P, _LL, _I, _P],
}

LAUNCHES = {"int8_quantize": 0, "int8_dequantize": 0}


def _lib():
    return _build.load("int8_quant", _SIGNATURES)


def _check_2d(t, dtype, what):
    if t.dim() != 2 or t.dtype != dtype:
        raise ValueError(f"{what}: want a 2-D {dtype} tensor, got "
                         f"{tuple(t.shape)} {t.dtype}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {t.device}")
    if t.device.type == "cuda" and not t.is_contiguous():
        raise ValueError(f"{what}: the kernel takes contiguous rows")


# --------------------------------------------------------- plain versions
def int8_quantize_plain(x):
    """x: (R, G) float32 -> (q int8 (R,G), scale f32 (R,1), zp f32 (R,1))."""
    mn = x.amin(dim=1, keepdim=True)
    mx = x.amax(dim=1, keepdim=True)
    # the divisor is a tensor on x's device: on CUDA, torch divides by a
    # Python scalar as a multiply by its reciprocal, which is not the
    # reference's (or the kernel's) true division
    qrange = torch.tensor(2.0 * _QMAX, dtype=torch.float32, device=x.device)
    scale = torch.clamp_min((mx - mn) / qrange, 1e-12)
    zp = -_QMAX - mn / scale
    q = torch.clamp(torch.round(x / scale + zp), -_QMAX, _QMAX)
    return q.to(torch.int8), scale, zp


def int8_dequantize_plain(q, scale, zp):
    return scale * (q.to(torch.float32) - zp)


# --------------------------------------------------------------- wrappers
def int8_quantize_rows(x):
    """Kernel wrapper of ``int8_quantize_plain``."""
    _check_2d(x, torch.float32, "int8_quantize")
    if x.device.type == "cpu":
        return int8_quantize_plain(x)
    r, g = x.shape
    q = torch.empty((r, g), dtype=torch.int8, device=x.device)
    scale = torch.empty((r, 1), dtype=torch.float32, device=x.device)
    zp = torch.empty((r, 1), dtype=torch.float32, device=x.device)
    if r:
        _build.check(_lib().int8_quantize(
            x.data_ptr(), q.data_ptr(), scale.data_ptr(), zp.data_ptr(),
            r, g, _build.stream_ptr(x)), "int8_quantize")
        LAUNCHES["int8_quantize"] += 1
    return q, scale, zp


def int8_dequantize_rows(q, scale, zp):
    """Kernel wrapper of ``int8_dequantize_plain``."""
    _check_2d(q, torch.int8, "int8_dequantize")
    r, g = q.shape
    for t, what in ((scale, "scale"), (zp, "zp")):
        _check_2d(t, torch.float32, f"int8_dequantize {what}")
        if tuple(t.shape) != (r, 1) or t.device != q.device:
            raise ValueError(f"int8_dequantize: {what} must be ({r}, 1) "
                             f"on {q.device}")
    if q.device.type == "cpu":
        return int8_dequantize_plain(q, scale, zp)
    out = torch.empty((r, g), dtype=torch.float32, device=q.device)
    if r:
        _build.check(_lib().int8_dequantize(
            q.data_ptr(), scale.data_ptr(), zp.data_ptr(), out.data_ptr(),
            r, g, _build.stream_ptr(q)), "int8_dequantize")
        LAUNCHES["int8_dequantize"] += 1
    return out
