"""Batched cohort compression: one fused kernel call per direction.

The sequential channel path encodes each (device, tensor) transfer as
its own dispatch chain — residual add, select/quantize, decode, residual
update, one python round-trip per device. When the engine flushes a
cohort together (all participants' uplinks, then all downlinks), the
per-device tensors share a shape, so the whole direction collapses to a
single (D, N) stacked buffer and ONE call into
``repro_torch.kernels.comm_fused`` (the CUDA kernels for tensors on the
card, their plain versions for tensors on the CPU).

Compatibility contract with the sequential path (tested):

* wire bytes are BIT-equal — computed analytically here from the same
  integer geometry the sequential codecs meter (sparse: k*(4+4)+4;
  int8: R*g + 8R via ``int8_group_geometry``; casts: n * width), so
  per-device meters, Eq.-1 clocks and recorder counters are identical;
* delivered tensors and residuals match to ≤1e-6 (same math, but the
  fused kernel may round differently than the per-device chain);
* the error-feedback residual dict is mutated with the sequential
  semantics exactly: residual added only when its shape matches, the
  new residual ``(x + r) - decode(encode(x + r))`` always stored, fp32
  short-circuited (its residual is identically zero);
* rand-k index draws happen host-side through the codec's own
  ``draw_indices`` counter stream, one draw per tensor in sequential
  transfer order, so the survivor masks (and any later sequential
  replay) are identical.

Items whose shapes differ still batch: the cohort is bucketed by
(shape, dtype) and each bucket is one fused call.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.comm.codecs import INDEX_BYTES, SPARSE_HEADER_BYTES
from repro_torch.kernels.comm_fused import (fused_cast_roundtrip,
                                      fused_int8_roundtrip,
                                      fused_sparse_roundtrip,
                                      int8_group_geometry)

SUPPORTED = ("fp32", "bf16", "fp16", "int8", "topk", "randk")


def supports(codec) -> bool:
    """True when this codec has a fused cohort implementation; the
    channel falls back to the sequential per-tensor path otherwise."""
    return getattr(codec, "name", "") in SUPPORTED


def payload_bytes(codec, n: int) -> float:
    """Exact wire bytes for one n-element tensor under ``codec`` —
    the same integer arithmetic the sequential encode meters from the
    materialized payload, so the two paths' byte counters are
    bit-equal (every term is an exact small integer in float64)."""
    name = codec.name
    if name in ("fp32", "bf16", "fp16"):
        return float(n) * codec.bytes_per_value
    if name == "int8":
        g, rows = int8_group_geometry(n)
        return float(rows * g) * codec.bytes_per_value \
            + float(rows) * codec.row_overhead_bytes
    # sparsifiers: (index, value) pair per survivor + count header
    k = codec._k(n)
    return k * (codec.value_bytes + INDEX_BYTES) + SPARSE_HEADER_BYTES


def cohort_roundtrip(codec, items, residuals: dict, error_feedback: bool):
    """Run a whole cohort's transfers through the fused kernels.

    ``items``: [(residual_key, tensor)] in the EXACT order the
    sequential path would have transferred them — rand-k draws and
    residual mutations depend on it. Returns [(delivered, wire_bytes)]
    aligned with ``items``; ``residuals`` is mutated in place with
    sequential-identical keying/overwrite/shape-reset semantics.
    """
    name = codec.name
    ef = bool(error_feedback) and name != "fp32"

    # host-side rand-k draws FIRST, in sequential transfer order, so the
    # codec's per-call counter stream stays replay-identical no matter
    # how the bucketing below regroups the tensors
    draws = [None] * len(items)
    if name == "randk":
        for i, (_, x) in enumerate(items):
            n = int(np.prod(x.shape)) if x.shape else 1
            draws[i] = np.asarray(codec.draw_indices(n, codec._k(n)))

    buckets = {}                      # (shape, dtype) -> item indices
    for i, (_, x) in enumerate(items):
        buckets.setdefault((tuple(x.shape), str(x.dtype)), []).append(i)

    out = [None] * len(items)
    for (shape, _), idxs in buckets.items():
        xs = torch.stack([items[i][1].reshape(-1) for i in idxs])
        n = xs.shape[1]
        r_stack = None
        if ef:
            rows = []
            for i in idxs:
                r = residuals.get(items[i][0])
                # sequential shape-reset rule: a stale-shaped residual
                # is ignored (adding zero is exact, so missing rows ride
                # the same fused call as held ones)
                if r is not None and tuple(r.shape) == shape:
                    rows.append(r.reshape(-1).to(xs.dtype))
                else:
                    rows.append(torch.zeros((n,), dtype=xs.dtype,
                                            device=xs.device))
            r_stack = torch.stack(rows)

        if name == "fp32":
            delivered, new_r = xs, None
        elif name in ("bf16", "fp16"):
            delivered, new_r = fused_cast_roundtrip(
                xs, r_stack, wire_dtype=codec.wire_dtype)
        elif name == "int8":
            delivered, new_r = fused_int8_roundtrip(xs, r_stack)
        else:
            k = codec._k(n)
            delivered, new_r = fused_sparse_roundtrip(
                xs, r_stack, k=k, scale=codec._scale(k, n),
                indices=(np.stack([draws[i] for i in idxs])
                         if name == "randk" else None))

        nbytes = payload_bytes(codec, n)
        for j, i in enumerate(idxs):
            if ef:
                residuals[items[i][0]] = new_r[j].reshape(shape)
            out[i] = (delivered[j].reshape(shape), nbytes)
    return out
