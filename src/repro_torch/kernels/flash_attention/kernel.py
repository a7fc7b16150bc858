"""Flash attention forward: online-softmax attention, causal and/or
sliding window, grouped-query heads.

Positions are implicit (q and k both start at 0, contiguous), as in the
train / prefill paths that call it; masked scores are ``-1e30``; a row
with no key kept is 0; the scale is ``1/sqrt(D)`` of the *q* head dim.

On a CUDA tensor the wrapper launches one of the hand-written Hopper
kernels (``csrc/flash_attention.cu``) or raises; ``_path`` picks it from
the dtype, the head dims and the alignment alone. On a CPU tensor it
runs the plain version beside it, dense masked softmax attention (the
reference's ``flash_attention/ref.py``), which stays differentiable; the
wrapper refuses a gradient on either device (``_build.refuse_grad``).
``LAUNCHES["flash_attention"]`` counts every kernel launch,
``LAUNCHES["flash_attention_<path>"]`` those of each path.
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
                            _I, _P, _I, _I, _F, _P],
}
# the C entry's path codes
PATHS = {"fp32": 0, "wgmma": 1}

LAUNCHES = {"flash_attention": 0, **{f"flash_attention_{p}": 0
                                     for p in PATHS}}


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


def _path(dtype, D: int, Dv: int, aligned: bool) -> str:
    """The kernel a CUDA call runs. "wgmma" (tensor cores fed by TMA):
    bf16 with D and Dv multiples of 8 up to 256 and ``aligned`` tensors;
    "fp32" (the fp32 cores): float32, and the bf16 that TMA cannot
    take."""
    if (dtype == torch.bfloat16 and aligned and D % 8 == 0 and Dv % 8 == 0
            and max(D, Dv) <= MAX_HEAD_DIM):
        return "wgmma"
    return "fp32"


def _strides(t) -> list:
    """(batch, head, seq) element strides; a dim of size 1 is never
    stepped, so it gets its contiguous stride (TMA checks every one)."""
    n = t.shape
    contiguous = (n[1] * n[2] * n[3], n[2] * n[3], n[3])
    return [st if size > 1 else c
            for st, size, c in zip(t.stride()[:3], n[:3], contiguous)]


def _aligned(tensors, strides) -> bool:
    """What TMA asks of each tensor: a 16-byte base pointer and strides
    that are multiples of 8 elements."""
    return all(t.data_ptr() % 16 == 0 for t in tensors) and all(
        st % 8 == 0 for st in strides)


def flash_attention_bhsd(q, k, v, *, causal: bool = True, window: int = 0):
    """Kernel wrapper of ``attention_plain``: q (B,H,S,D), k (B,K,T,D),
    v (B,K,T,Dv), any strides over the first three dims (the last is
    unit on the card). Returns a contiguous (B,H,S,Dv) tensor. Refuses
    inputs that require a gradient under grad mode, on the CPU too: the
    kernel has no backward."""
    _check(q, k, v)
    _build.refuse_grad("flash_attention", q, k, v)
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
        ins = [*_strides(q), *_strides(k), *_strides(v)]
        path = _path(q.dtype, D, Dv, _aligned((q, k, v), ins))
        strides = (ctypes.c_longlong * 12)(*ins, *out.stride()[:3])
        _build.check(_lib().flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], PATHS[path], B, H, K, S, T, D, Dv, strides,
            int(causal), int(window), 1.0 / math.sqrt(D),
            _build.stream_ptr(q)), f"flash_attention ({path})")
        LAUNCHES["flash_attention"] += 1
        LAUNCHES[f"flash_attention_{path}"] += 1
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
