"""Public wrappers for the fused cohort-compression kernels.

Input convention: a cohort's cut tensors are stacked into one ``(D, N)``
buffer (one row per device, tensors flattened). Each wrapper runs the
whole codec roundtrip — residual add, select/quantize, decode, residual
update ``r' = (x + r) - decode(encode(x + r))`` — over the stacked
buffer in one kernel launch per roundtrip.

Numerics contract (tested): every wrapper is element-for-element the
same math as the sequential per-device codec path in
``repro_torch.comm.codecs`` — delivered tensors and residuals within
1e-6, wire bytes bit-equal.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.comm_fused.kernel import (int8_roundtrip,
                                                   sparse_combine)
from repro_torch.kernels.int8_quant.ops import GROUP
from repro_torch.utils.topk import top_k


def _as_group_rows(x2, group: int):
    """(D, N) -> (D * R, g) group rows, row-major so each device's
    values stay consecutive; per-row edge padding mirrors
    int8_quant.kernel.edge_padded_rows per device (zero-padding would drag the
    tail group's min/max toward 0)."""
    d, n = x2.shape
    g = max(1, min(group, n))
    pad = (-n) % g
    if pad:
        x2 = torch.cat([x2, x2[:, -1:].expand(d, pad)], dim=1)
    return x2.reshape(d * ((n + pad) // g), g)


def int8_group_geometry(n: int, group: int = GROUP):
    """(values-per-group g, groups-per-device R) for an N-value device
    row — the shape the wire bytes are metered from (R * g payload
    bytes + R group-metadata records), identical to the sequential
    Int8Codec accounting."""
    g = max(1, min(group, int(n)))
    return g, -(-int(n) // g)


def fused_int8_roundtrip(x, r=None, group: int = GROUP):
    """x: (D, N) stacked cohort; r: matching residual stack or None.
    Returns (delivered, new_residual_or_None)."""
    y = x + r.to(x.dtype) if r is not None else x
    d, n = y.shape
    rows = _as_group_rows(y.to(torch.float32).contiguous(), group)
    delivered = int8_roundtrip(rows).reshape(d, -1)[:, :n].to(y.dtype)
    return delivered, (y - delivered if r is not None else None)


def fused_sparse_roundtrip(x, r=None, *, k: int, scale=1.0, indices=None):
    """x: (D, N) stacked cohort; keep k entries per row — the k
    largest-magnitude (top-k) when ``indices`` is None, else the given
    (D, k) index rows (rand-k; drawn host-side to preserve the codec's
    per-call counter stream). ``scale`` multiplies survivors (n/k for
    the unbiased rand-k estimator). Returns (delivered,
    new_residual_or_None)."""
    y = x + r.to(x.dtype) if r is not None else x
    y32 = y.to(torch.float32).contiguous()
    if indices is None:
        # the selection is the codec's, row by row (ties to the lower
        # index, as jax.lax.top_k)
        idx = top_k(y32.abs(), int(k))[1]
    else:
        idx = torch.as_tensor(indices, dtype=torch.int64, device=y.device)
    mask = torch.zeros_like(y32).scatter_(1, idx, 1.0)
    delivered, res = sparse_combine(y32, mask, float(scale))
    delivered = delivered.to(y.dtype)
    if r is None:
        return delivered, None
    # the kernel already emitted the residual dual; it is exact when y
    # is f32 (y32 IS y), recompute otherwise
    return delivered, (res if y.dtype == torch.float32 else y - delivered)


def fused_cast_roundtrip(x, r=None, *, wire_dtype):
    """bf16/fp16 wire downcast over a stacked (D, N) cohort."""
    y = x + r.to(x.dtype) if r is not None else x
    delivered = y.to(wire_dtype).to(y.dtype)
    return delivered, (y - delivered if r is not None else None)

