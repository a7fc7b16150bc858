"""Flash attention forward: online-softmax attention, causal and/or
sliding window, grouped-query heads.

Positions are implicit (q and k both start at 0, contiguous), as in the
train / prefill paths that call it; masked scores are ``-1e30``; a row
with no key kept is 0; the scale is ``1/sqrt(D)`` of the *q* head dim.

On a CUDA tensor the wrapper launches the hand-written Hopper kernel
(``csrc/flash_attention.cu``) or raises; on a CPU tensor it runs the
plain version beside it, dense masked softmax attention (the reference's
``flash_attention/ref.py``). ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "flash_attention_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                            _P, _I, _I, _F, _P],
}

LAUNCHES = {"flash_attention": 0}


def _lib():
    return _build.load("flash_attention", _SIGNATURES)


def _mask(S: int, T: int, causal: bool, window: int, device):
    qpos = torch.arange(S, device=device)[:, None]
    kpos = torch.arange(T, device=device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=device)
    if causal:
        mask &= qpos >= kpos
    if window:
        mask &= qpos - kpos < window
    return mask


# ----------------------------------------------------------- plain version
def attention_plain(q, k, v, *, causal: bool = True, window: int = 0):
    """q (B,H,S,D), k (B,K,T,D), v (B,K,T,Dv) -> (B,H,S,Dv) in q's dtype;
    q head h reads kv head h // (H // K)."""
    B, H, S, D = q.shape
    T, G = k.shape[2], H // k.shape[1]
    k = k.repeat_interleave(G, dim=1)
    v = v.repeat_interleave(G, dim=1)
    s = torch.einsum("bhsd,bhtd->bhst", q.to(torch.float32),
                     k.to(torch.float32)) * (1.0 / math.sqrt(D))
    mask = _mask(S, T, causal, window, q.device)
    s = torch.where(mask, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    # fully-masked rows -> 0 (the kernel's l == 0 guard)
    w = torch.where(mask.any(dim=-1)[:, None], w, 0.0)
    return torch.einsum("bhst,bhtd->bhsd", w,
                        v.to(torch.float32)).to(q.dtype)


# ----------------------------------------------------------------- wrapper
def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: want 4-D q, k, v")
    B, H, S, D = q.shape
    _, K, T, Dk = k.shape
    if (k.shape[0] != B or v.shape[:3] != k.shape[:3] or Dk != D
            or K == 0 or H % K):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention: q, k, v must share float32 or "
                         f"bfloat16, got {q.dtype} {k.dtype} {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")


def flash_attention_bhsd(q, k, v, *, causal: bool = True, window: int = 0):
    """Kernel wrapper of ``attention_plain``: q (B,H,S,D), k (B,K,T,D),
    v (B,K,T,Dv), any strides over the first three dims (the last is
    unit on the card). Returns a contiguous (B,H,S,Dv) tensor."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal=causal, window=window)
    B, H, S, D = q.shape
    _, K, T, _ = k.shape
    Dv = v.shape[-1]
    if max(D, Dv) > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dims {D}, {Dv} > "
                         f"{MAX_HEAD_DIM}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the last dim must be unit-stride")
    out = torch.empty((B, H, S, Dv), dtype=q.dtype, device=q.device)
    if out.numel():
        strides = (ctypes.c_longlong * 12)(
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3])
        _build.check(_lib().flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], B, H, K, S, T, D, Dv, strides, int(causal),
            int(window), 1.0 / math.sqrt(D), _build.stream_ptr(q)),
            "flash_attention")
        LAUNCHES["flash_attention"] += 1
    return out


def flash_attention_fwd(q, k, v, *, causal: bool = True, window: int = 0,
                        groups: int = 1):
    """The reference kernel's layout: q (BHq, S, D) with BHq = BK*groups,
    k (BK, T, D), v (BK, T, Dv) -> (BHq, S, Dv); q row b reads kv row
    b // groups."""
    BH, S, D = q.shape
    BK, T, Dv = v.shape[0], k.shape[1], v.shape[-1]
    if BH != BK * groups:
        raise ValueError(f"flash_attention_fwd: {BH} q rows, {BK} kv rows, "
                         f"groups {groups}")
    out = flash_attention_bhsd(q.reshape(BK, groups, S, D),
                               k.reshape(BK, 1, T, D),
                               v.reshape(BK, 1, T, Dv), causal=causal,
                               window=window)
    return out.reshape(BH, S, Dv)
