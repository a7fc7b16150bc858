"""Int8 affine quantize / dequantize of a list of tensors, one launch per
list.

    q  = clip(round(x / scale + zp), -127, 127)        int8
    x' = scale * (q - zp)                              dequant

with ``scale = max((mx - mn) / 254, 1e-12)`` and ``zp = -127 - mn /
scale`` per row of ``g`` consecutive values; a tensor of ``numel``
values has ``ceil(numel / g)`` rows, the last one edge-padded with its
last value. On CUDA tensors each wrapper launches its hand-written
Hopper kernel (``csrc/int8_quant.cu``) once for up to ``MAX_SEGMENTS``
tensors, or raises; on CPU tensors it runs the plain PyTorch version
beside it, the per-tensor loop of the same arithmetic in the same
order. ``LAUNCHES`` counts kernel launches per wrapper.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_QMAX = 127.0
MAX_SEGMENTS = 64               # tensors a launch (csrc kMaxSegments)
_ALIGN = 16                     # bytes between one tensor's output and
                                # the next: the kernels' vector stores
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "int8_quantize_segments": [_P, _I, _P],
    "int8_dequantize_segments": [_P, _I, _P],
}

LAUNCHES = {"int8_quantize": 0, "int8_dequantize": 0}


class _Leaf(ctypes.Structure):
    """One tensor of a launch, as csrc/int8_quant.cu's ``Leaf``."""
    _fields_ = [("x", _P), ("q", _P), ("scale", _P), ("zp", _P),
                ("numel", _LL), ("g", _LL)]


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


def n_rows(numel: int, g: int) -> int:
    return -(-numel // g)


def _device(tensors, what):
    dev = {t.device for t in tensors}
    if len(dev) > 1:
        raise ValueError(f"{what}: tensors on different devices {dev}")
    (dev,) = dev
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")
    return dev


def _launch(entry, counter, leaves, like):
    """One launch of ``entry`` per MAX_SEGMENTS leaves, on the current
    stream of ``like``'s device."""
    for i in range(0, len(leaves), MAX_SEGMENTS):
        part = leaves[i:i + MAX_SEGMENTS]
        table = (_Leaf * len(part))(*part)
        _build.check(getattr(_lib(), entry)(
            ctypes.addressof(table), len(part), _build.stream_ptr(like)),
            entry)
        LAUNCHES[counter] += 1


def _buffer(sizes, dtype, device):
    """Tensors of ``sizes`` elements cut from one buffer, each starting
    on _ALIGN bytes (the kernels' vector loads and stores), none
    overlapping another."""
    step = _ALIGN // dtype.itemsize
    padded = [-(-n // step) * step for n in sizes]
    chunks = torch.empty(sum(padded), dtype=dtype, device=device).split(
        padded)
    return [c if n == p else c[:n] for c, n, p in zip(chunks, sizes, padded)]


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


def edge_padded_rows(flat, g: int):
    """A 1-D tensor as (ceil(numel / g), g) rows, the tail row padded with
    the last value: zero-padding would drag the tail group's min/max
    toward 0 and blow its quantization step ~range/254 bound."""
    pad = (-flat.numel()) % g
    if pad:
        flat = torch.cat([flat, flat[-1:].expand(pad)])
    return flat.reshape(-1, g)


def int8_quantize_segments_plain(flats, groups):
    return [int8_quantize_plain(edge_padded_rows(f, g))
            for f, g in zip(flats, groups)]


def int8_dequantize_segments_plain(qs, scales, zps, numels):
    return [int8_dequantize_plain(q, s, z).reshape(-1)[:n]
            for q, s, z, n in zip(qs, scales, zps, numels)]


# --------------------------------------------------------------- wrappers
def int8_quantize_segments(flats, groups):
    """Kernel wrapper of ``int8_quantize_segments_plain``. flats: 1-D
    float32 tensors on one device, groups: each one's values a row. ->
    [(q int8 (R,g), scale f32 (R,1), zp f32 (R,1))]; on the card the
    outputs are views of one buffer each."""
    flats, groups = list(flats), [int(g) for g in groups]
    if len(flats) != len(groups):
        raise ValueError("int8_quantize: one group size a tensor")
    if not flats:
        return []
    for f, g in zip(flats, groups):
        if f.dim() != 1 or f.dtype != torch.float32 or g < 1:
            raise ValueError(f"int8_quantize: want 1-D float32 tensors and "
                             f"groups >= 1, got {tuple(f.shape)} {f.dtype}"
                             f" g={g}")
    dev = _device(flats, "int8_quantize")
    if dev.type == "cpu":
        return int8_quantize_segments_plain(flats, groups)
    if not all(f.is_contiguous() for f in flats):
        raise ValueError("int8_quantize: the kernel takes contiguous "
                         "tensors")
    rows = [n_rows(f.numel(), g) for f, g in zip(flats, groups)]
    sizes = [r * g for r, g in zip(rows, groups)]
    q_chunks = _buffer(sizes, torch.int8, dev)
    qs = [c.view(r, g) for c, r, g in zip(q_chunks, rows, groups)]
    ss = torch.empty((sum(rows), 1), dtype=torch.float32,
                     device=dev).split(rows)
    zs = torch.empty((sum(rows), 1), dtype=torch.float32,
                     device=dev).split(rows)
    _launch("int8_quantize_segments", "int8_quantize",
            [_Leaf(f.data_ptr(), q.data_ptr(), s.data_ptr(), z.data_ptr(),
                   f.numel(), g)
             for f, q, s, z, g in zip(flats, qs, ss, zs, groups)
             if f.numel()],
            qs[0])
    return list(zip(qs, ss, zs))


def int8_dequantize_segments(qs, scales, zps, numels):
    """Kernel wrapper of ``int8_dequantize_segments_plain``: each
    payload's first ``numel`` values, as 1-D float32 tensors (views of
    one buffer on the card)."""
    qs, scales, zps = list(qs), list(scales), list(zps)
    numels = [int(n) for n in numels]
    if not len(qs) == len(scales) == len(zps) == len(numels):
        raise ValueError("int8_dequantize: one scale, zp and numel a "
                         "payload")
    if not qs:
        return []
    for q, s, z, n in zip(qs, scales, zps, numels):
        _check_2d(q, torch.int8, "int8_dequantize")
        r, g = q.shape
        for t, what in ((s, "scale"), (z, "zp")):
            _check_2d(t, torch.float32, f"int8_dequantize {what}")
            if tuple(t.shape) != (r, 1):
                raise ValueError(f"int8_dequantize: {what} must be "
                                 f"({r}, 1), got {tuple(t.shape)}")
        if not (r - 1) * g < n <= r * g:
            raise ValueError(f"int8_dequantize: {n} values do not fill "
                             f"{r} rows of {g}")
    dev = _device([*qs, *scales, *zps], "int8_dequantize")
    if dev.type == "cpu":
        return int8_dequantize_segments_plain(qs, scales, zps, numels)
    outs = _buffer(numels, torch.float32, dev)
    _launch("int8_dequantize_segments", "int8_dequantize",
            [_Leaf(o.data_ptr(), q.data_ptr(), s.data_ptr(), z.data_ptr(),
                   n, q.shape[1])
             for o, q, s, z, n in zip(outs, qs, scales, zps, numels) if n],
            outs[0])
    return outs


def int8_quantize_rows(x):
    """(R, G) float32 rows -> (q, scale, zp): a list of one."""
    _check_2d(x, torch.float32, "int8_quantize")
    return int8_quantize_segments([x.reshape(-1)], [x.shape[1]])[0]


def int8_dequantize_rows(q, scale, zp):
    """Inverse of ``int8_quantize_rows``: (R, G) float32."""
    _check_2d(q, torch.int8, "int8_dequantize")
    return int8_dequantize_segments([q], [scale], [zp],
                                    [q.numel()])[0].reshape(q.shape)
