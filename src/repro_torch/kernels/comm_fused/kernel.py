"""Fused cohort-compression kernels.

``int8_roundtrip``   (R, G) group rows -> dequantize(quantize(x)) in one
                     pass; q/scale/zp never reach device memory.
``sparse_combine``   from the residual-added (D, N) cohort buffer y and
                     the 0/1 survivor mask, ``delivered = y * mask *
                     scale`` and ``residual = y - delivered`` from one
                     read.

On a CUDA tensor each wrapper launches its hand-written Hopper kernel
(``csrc/comm_fused.cu``) or raises; on a CPU tensor it runs the plain
PyTorch version beside it. ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.int8_quant.kernel import (_check_2d,
                                                   int8_dequantize_plain,
                                                   int8_quantize_plain)

_P, _LL, _I, _F = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_float)
_SIGNATURES = {
    "int8_roundtrip": [_P, _P, _LL, _I, _P],
    "sparse_combine": [_P, _P, _F, _P, _P, _LL, _P],
}

LAUNCHES = {"int8_roundtrip": 0, "sparse_combine": 0}


def _lib():
    return _build.load("comm_fused", _SIGNATURES)


# --------------------------------------------------------- plain versions
def int8_roundtrip_plain(x):
    """x: (R, G) float32 -> dequantize(quantize(x)), same shape."""
    return int8_dequantize_plain(*int8_quantize_plain(x))


def sparse_combine_plain(y, mask, scale: float):
    """(delivered, residual) = (y * mask * scale, y - delivered)."""
    delivered = y * mask * torch.tensor(scale, dtype=torch.float32)
    return delivered, y - delivered


# --------------------------------------------------------------- wrappers
def int8_roundtrip(x):
    """Kernel wrapper of ``int8_roundtrip_plain``."""
    _check_2d(x, torch.float32, "int8_roundtrip")
    if x.device.type == "cpu":
        return int8_roundtrip_plain(x)
    r, g = x.shape
    out = torch.empty_like(x)
    if r:
        _build.check(_lib().int8_roundtrip(
            x.data_ptr(), out.data_ptr(), r, g, _build.stream_ptr(x)),
            "int8_roundtrip")
        LAUNCHES["int8_roundtrip"] += 1
    return out


def sparse_combine(y, mask, scale: float):
    """Kernel wrapper of ``sparse_combine_plain``. y, mask: (D, N)
    float32; scale: 1.0 for top-k, n/k for unbiased rand-k."""
    _check_2d(y, torch.float32, "sparse_combine")
    _check_2d(mask, torch.float32, "sparse_combine mask")
    if mask.shape != y.shape or mask.device != y.device:
        raise ValueError("sparse_combine: mask must match y's shape and "
                         "device")
    if y.device.type == "cpu":
        return sparse_combine_plain(y, mask, scale)
    out = torch.empty_like(y)
    res = torch.empty_like(y)
    n = y.numel()
    if n:
        _build.check(_lib().sparse_combine(
            y.data_ptr(), mask.data_ptr(), float(scale), out.data_ptr(),
            res.data_ptr(), n, _build.stream_ptr(y)), "sparse_combine")
        LAUNCHES["sparse_combine"] += 1
    return out, res
