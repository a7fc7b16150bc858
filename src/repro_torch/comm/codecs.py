"""Payload codecs for the cut-layer exchange (uplink features, downlink
feature-gradients).

A codec is a wire format: ``encode`` produces the payload that would
cross the link (plus exact wire bytes), ``decode`` reconstructs the
tensor the receiver trains on. The engine always trains on
``decode(encode(x))`` so codec round-trip error is injected into the
training path — compression is never free by construction.

Byte accounting is exact per payload: element payload bytes + per-row
metadata (int8: fp32 scale+zp per row) + a fixed 4-byte aux scalar
carried alongside each feature tensor. Sparsifiers (top-k / random-k)
ship an index+value pair per surviving entry plus a 4-byte count header
per tensor.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels.int8_quant import (group_size,
                                            int8_dequantize_many,
                                            int8_quantize_many)
from repro_torch.utils.topk import top_k


class Codec:
    """Wire format for a single tensor. Subclasses set ``name`` and
    ``bytes_per_value`` and implement encode/decode."""

    name: str = "base"
    bytes_per_value: float = 4.0
    row_overhead_bytes: float = 0.0     # per-row metadata (scales etc.)

    def encode(self, x):
        """-> (payload, wire_bytes). payload is whatever decode needs."""
        raise NotImplementedError

    def decode(self, payload, dtype=torch.float32):
        raise NotImplementedError

    def roundtrip(self, x):
        """The tensor the receiver sees, plus exact wire bytes."""
        payload, nbytes = self.encode(x)
        return self.decode(payload, dtype=x.dtype), nbytes

    def roundtrip_many(self, xs):
        """``roundtrip`` of each tensor in order: [(y, wire_bytes)]."""
        return [self.roundtrip(x) for x in xs]

    def estimate_bytes(self, n_values: float, last_dim: int = 0) -> float:
        """Analytic wire size for n_values elements (used by the Eq.-1
        simulator for devices whose payloads are not materialized, e.g.
        warm-up observation of non-participants)."""
        rows = n_values / last_dim if last_dim else 1.0
        return n_values * self.bytes_per_value \
            + math.ceil(rows) * self.row_overhead_bytes


class Fp32Codec(Codec):
    name = "fp32"
    bytes_per_value = 4.0

    def encode(self, x):
        return x, float(x.numel()) * self.bytes_per_value

    def decode(self, payload, dtype=torch.float32):
        return payload.to(dtype)


class CastCodec(Codec):
    """Lossy downcast (bf16 / fp16): halves the wire size."""
    bytes_per_value = 2.0

    def __init__(self, name: str, wire_dtype):
        self.name = name
        self.wire_dtype = wire_dtype

    def encode(self, x):
        return x.to(self.wire_dtype), \
            float(x.numel()) * self.bytes_per_value

    def decode(self, payload, dtype=torch.float32):
        return payload.to(dtype)


class Int8Codec(Codec):
    """Group-wise affine int8 via the kernel pair
    (repro_torch.kernels.int8_quant): 1 byte/value + 8 bytes per group of
    GROUP values (fp32 scale + zero point), ~3% metadata.
    ``roundtrip_many`` sends a list of tensors through one quantize and
    one dequantize launch."""
    name = "int8"
    bytes_per_value = 1.0
    row_overhead_bytes = 8.0

    def _nbytes(self, q) -> float:
        # the edge-padded tail group crosses the wire too — count it
        return float(q.numel()) * self.bytes_per_value \
            + float(q.shape[0]) * self.row_overhead_bytes

    def encode(self, x):
        payload = int8_quantize_many([x])[0]
        return payload, self._nbytes(payload[0])

    def decode(self, payload, dtype=torch.float32):
        return int8_dequantize_many([payload], dtype=dtype)[0]

    def roundtrip_many(self, xs):
        xs = list(xs)
        payloads = int8_quantize_many(xs)
        ys = int8_dequantize_many(payloads)
        return [(y.to(x.dtype), self._nbytes(p[0]))
                for x, y, p in zip(xs, ys, payloads)]

    def estimate_bytes(self, n_values: float, last_dim: int = 0) -> float:
        if not n_values:
            return 0.0
        # mirror the kernels' grouping: tensors smaller than GROUP use
        # one tensor-sized group, not a full padded one
        g = group_size(int(n_values))
        groups = math.ceil(n_values / g)
        return groups * (g * self.bytes_per_value
                         + self.row_overhead_bytes)


# ---------------------------------------------------------------------------
# sparsification (index+value wire format)
# ---------------------------------------------------------------------------
DEFAULT_TOPK_FRAC = 0.1
INDEX_BYTES = 4.0            # int32 flat index per surviving entry
SPARSE_HEADER_BYTES = 4.0    # entry-count header per tensor


class SparseCodec(Codec):
    """Send only ``k = ceil(frac * size)`` entries of the flattened
    tensor: each survivor crosses the wire as (int32 flat index, fp32
    value) — 8 B/entry — plus a 4-byte count header per tensor. The
    receiver scatters into zeros, so the round-trip error is exactly the
    dropped mass; pair with the channel's error-feedback accumulators to
    re-inject it next round instead of losing it."""

    value_bytes = 4.0

    def __init__(self, name: str, frac: float = DEFAULT_TOPK_FRAC):
        if not 0.0 < frac <= 1.0:
            raise ValueError(f"topk_frac must be in (0, 1]: {frac}")
        self.name = name
        self.frac = float(frac)
        self.bytes_per_value = self.frac * (self.value_bytes + INDEX_BYTES)

    def _k(self, n: int) -> int:
        return max(1, math.ceil(self.frac * n))

    def _select(self, flat, k: int):
        raise NotImplementedError

    def _scale(self, k: int, n: int) -> float:
        return 1.0

    def encode(self, x):
        flat = x.reshape(-1).to(torch.float32)
        k = self._k(flat.numel())
        idx = self._select(flat, k)
        vals = flat[idx] * torch.tensor(self._scale(k, flat.numel()),
                                        dtype=torch.float32)
        nbytes = k * (self.value_bytes + INDEX_BYTES) + SPARSE_HEADER_BYTES
        return (idx, vals, tuple(x.shape)), nbytes

    def decode(self, payload, dtype=torch.float32):
        idx, vals, shape = payload
        out = torch.zeros(math.prod(shape), dtype=torch.float32,
                          device=vals.device)
        out[idx] = vals
        return out.reshape(shape).to(dtype)

    def estimate_bytes(self, n_values: float, last_dim: int = 0) -> float:
        if not n_values:
            return 0.0
        return self._k(int(n_values)) * (self.value_bytes + INDEX_BYTES) \
            + SPARSE_HEADER_BYTES


class TopKCodec(SparseCodec):
    """Keep the k largest-magnitude entries (biased; the standard
    error-feedback partner); equal magnitudes at the threshold go to the
    lower index, as ``jax.lax.top_k`` breaks ties."""

    def __init__(self, frac: float = DEFAULT_TOPK_FRAC):
        super().__init__("topk", frac)

    def _select(self, flat, k):
        return top_k(flat.abs(), k)[1]


class RandomKCodec(SparseCodec):
    """Keep k uniformly random entries, scaled by n/k so the estimator
    is unbiased (QSGD-style). Index draws come from a deterministic
    per-call counter seed, so runs are reproducible without threading
    RNG state through the channel.

    ``unbiased=False`` drops the n/k scaling: the scaled operator is
    not a contraction (||x - C(x)|| can exceed ||x||), which makes
    error-feedback accumulators diverge — the channel flips this flag
    when feedback is on, since re-injecting the residual already
    compensates the bias."""

    def __init__(self, frac: float = DEFAULT_TOPK_FRAC, seed: int = 0,
                 unbiased: bool = True):
        super().__init__("randk", frac)
        self.seed = seed
        self.unbiased = unbiased
        self._calls = 0

    def draw_indices(self, n: int, k: int):
        """Advance the per-call counter and draw this call's survivor
        indices (host-side numpy). Exposed so the batched cohort path
        can consume the SAME counter stream in the same order as the
        sequential per-tensor path — one draw per tensor either way, so
        a run's index masks are identical whichever path carried it."""
        self._calls += 1
        rng = np.random.default_rng((self.seed, self._calls))
        return rng.choice(n, size=k, replace=False)

    def _select(self, flat, k):
        return torch.as_tensor(self.draw_indices(flat.numel(), k),
                               dtype=torch.int64, device=flat.device)

    def _scale(self, k, n):
        return n / k if self.unbiased else 1.0

    # ------------------------------------------------- replayable state
    def state(self) -> dict:
        """Checkpointable RNG-stream position: restoring (seed, calls)
        and replaying makes every subsequent index draw identical."""
        return {"seed": self.seed, "calls": self._calls}

    def set_state(self, state: dict):
        self.seed = state["seed"]
        self._calls = int(state["calls"])

    def reset(self):
        """Rewind the call counter to the start of the stream (a fresh
        run from the same seed)."""
        self._calls = 0


_CODECS = {
    "fp32": Fp32Codec,
    "bf16": lambda: CastCodec("bf16", torch.bfloat16),
    "fp16": lambda: CastCodec("fp16", torch.float16),
    "int8": Int8Codec,
    "topk": TopKCodec,
    "randk": RandomKCodec,
}

_SPARSE = ("topk", "randk")


def get_codec(name: str, *, topk_frac: float = None) -> Codec:
    if name not in _CODECS:
        raise ValueError(
            f"unknown codec {name!r}; known codecs: {list_codecs()}")
    if name in _SPARSE and topk_frac is not None:
        return _CODECS[name](topk_frac)
    return _CODECS[name]()


def list_codecs():
    return sorted(_CODECS)
