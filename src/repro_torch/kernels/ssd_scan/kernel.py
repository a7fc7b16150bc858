"""Mamba2 SSD chunked scan (single B/C group).

Per chunk of ``chunk`` rows, with ``cs = cumsum(dt * A)`` in the chunk:

    y     = (L o C Bᵀ)(dt o x) + exp(cs) o (C stateᵀ)
    state = exp(cs_last) state + xᵀ (B o exp(cs_last - cs) dt)

``L[i, j] = exp(cs_i - cs_j)`` for ``j <= i``, else 0. The (p, n) state
is carried in f32 from the initial state; y and the final state come
back in x's dtype. x, B, C and the initial state share one dtype; dt
and A are f32, as ``ssm_apply`` hands them over.

On a CUDA tensor the wrapper launches one of the hand-written Hopper
kernels (``csrc/ssd_scan.cu``) or raises; ``_path`` picks it from the
dtype, p, n and the alignment alone. On a CPU tensor it runs the plain
version beside it, which is the same per-chunk arithmetic with the f32
state. (The model's own oracle, ``models/ssm.ssd_scan_ref``, carries its
state in x's dtype; both exist.) ``LAUNCHES["ssd_scan"]`` counts kernel
launches, ``LAUNCHES["ssd_scan_<path>"]`` those of each path.
"""
from __future__ import annotations

import contextlib
import ctypes

import torch

from repro_torch.kernels import _build

MAX_CHUNK = 128
MAX_DIM = 128                   # p and n
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "ssd_scan": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                 _I, _I, _P],
}
# the C entry's path codes
PATHS = {"f32": 0, "mma": 1, "wgmma": 2}
P_TILE = 64                     # p columns of one chain of the wgmma path

LAUNCHES = {"ssd_scan": 0, **{f"ssd_scan_{p}": 0 for p in PATHS}}


def _lib():
    return _build.load("ssd_scan", _SIGNATURES)


# ----------------------------------------------------------- plain version
@contextlib.contextmanager
def _one_cpu_thread(device):
    """Run the block on one CPU thread (no-op for a card's tensors).

    On the CPU, ``torch.exp`` of float32 splits a tensor of more than
    2048 values into 2048-value chunks over the intra-op threads, and each
    chunk goes through MKL's vector math (``vmsExp``, high-accuracy
    mode). In about one process in 100 to 300 (CPU PyTorch 2.13.0, MKL
    2024.2, 8 threads), the first such call that runs on several threads
    at once returns worker-thread chunks with ~1.5e-4 relative error, the
    accuracy of a lower-accuracy exp; the main thread's chunk and every
    later call are right. On one thread the call is never concurrent."""
    if device.type != "cpu":
        yield
        return
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def ssd_scan_plain(x, dt, A, B, C, *, chunk: int = 128, initial_state=None):
    """x (b,s,h,p), dt (b,s,h), A (h,), B/C (b,s,n), initial_state
    (b,h,p,n) or None -> (y (b,s,h,p), final_state (b,h,p,n)). Every
    exp runs on one CPU thread (``_one_cpu_thread``)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    nc, l = s // chunk, chunk
    f32 = torch.float32
    xc = x.to(f32).reshape(b, nc, l, h, p)
    dtc = dt.to(f32).reshape(b, nc, l, h)
    Bc = B.to(f32).reshape(b, nc, l, n)
    Cc = C.to(f32).reshape(b, nc, l, n)
    A = A.to(f32)
    state = (torch.zeros((b, h, p, n), dtype=f32, device=x.device)
             if initial_state is None else initial_state.to(f32))
    tri = torch.tril(torch.ones((l, l), dtype=torch.bool, device=x.device))
    ys = []
    for c in range(nc):
        xi, dti, Bi, Ci = xc[:, c], dtc[:, c], Bc[:, c], Cc[:, c]
        cs = torch.cumsum(dti * A, dim=1)                  # (b,l,h)
        seg = cs[:, :, None, :] - cs[:, None, :, :]         # (b,i,j,h)
        with _one_cpu_thread(x.device):
            exp_seg, exp_cs = torch.exp(seg), torch.exp(cs)
            exp_tail = torch.exp(cs[:, -1:] - cs)
            exp_last = torch.exp(cs[:, -1])
        L = torch.where(tri[None, :, :, None], exp_seg, 0.0)
        scores = torch.einsum("bin,bjn->bij", Ci, Bi)
        W = L * scores[..., None]
        y = torch.einsum("bijh,bjhp->bihp", W, xi * dti[..., None])
        y_off = torch.einsum("bin,bhpn->bihp", Ci, state)
        y = y + y_off * exp_cs[..., None]
        ys.append(y)
        tail = exp_tail * dti                                # (b,l,h)
        upd = torch.einsum("bjhp,bjhn->bhpn", xi,
                           Bi[:, :, None, :] * tail[..., None])
        state = state * exp_last[..., None, None] + upd
    y = torch.stack(ys, dim=1).reshape(b, s, h, p)
    return y.to(x.dtype), state.to(x.dtype)


# ----------------------------------------------------------------- wrapper
def _check(x, dt, A, B, C, chunk, initial_state):
    if x.dim() != 4:
        raise ValueError(f"ssd_scan: x must be (b,s,h,p), got "
                         f"{tuple(x.shape)}")
    b, s, h, p = x.shape
    n = B.shape[-1]
    if (tuple(dt.shape) != (b, s, h) or tuple(A.shape) != (h,)
            or tuple(B.shape) != (b, s, n) or tuple(C.shape) != (b, s, n)):
        raise ValueError(f"ssd_scan: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)}, C {tuple(C.shape)}")
    if chunk <= 0 or s % chunk:
        raise ValueError(f"ssd_scan: s={s} is not a multiple of chunk "
                         f"{chunk}")
    if x.dtype not in _DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise ValueError(f"ssd_scan: x, B, C must share float32 or bfloat16,"
                         f" got {x.dtype} {B.dtype} {C.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError(f"ssd_scan: dt and A must be float32, got "
                         f"{dt.dtype} {A.dtype}")
    tensors = [x, dt, A, B, C]
    if initial_state is not None:
        if (tuple(initial_state.shape) != (b, h, p, n)
                or initial_state.dtype != x.dtype):
            raise ValueError(f"ssd_scan: initial_state must be "
                             f"{(b, h, p, n)} {x.dtype}, got "
                             f"{tuple(initial_state.shape)} "
                             f"{initial_state.dtype}")
        tensors.append(initial_state)
    if any(t.device != x.device for t in tensors):
        raise ValueError("ssd_scan: inputs on different devices")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ssd_scan: unsupported device {x.device}")
    return tensors


def _path(dtype, p: int, n: int, aligned: bool) -> str:
    """The kernel a CUDA call runs. "f32" (the fp32 cores): float32.
    "wgmma" (chunk-parallel on wgmma fed by TMA): bf16 with p and n
    multiples of 8 and ``aligned`` x, B and C. "mma" (one block walks
    the chunks in order on mma.sync): the other bf16."""
    if dtype == torch.float32:
        return "f32"
    if aligned and p % 8 == 0 and n % 8 == 0:
        return "wgmma"
    return "mma"


def _aligned(tensors) -> bool:
    """What TMA asks of a contiguous tensor's base: 16 bytes."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def lookback_scratch(b: int, h: int, p: int, n: int) -> int:
    """64-bit words of the wgmma path's scratch, zeroed each call: the
    ticket (two words, so the slots start on 16 bytes), then one (64, 64
    or 128) state slot per chain, through which a chunk hands its f32
    state to the next; each word holds a value and the number of the
    chunk that wrote it. A chain is one (batch, head, 64-wide p
    tile)."""
    chains = b * h * -(-p // P_TILE)
    return 2 + chains * P_TILE * (64 if n <= 64 else 128)


def ssd_scan(x, dt, A, B, C, *, chunk: int = 128, initial_state=None):
    """Kernel wrapper of ``ssd_scan_plain``; refuses inputs that require
    a gradient under grad mode, on the CPU too (no backward)."""
    tensors = _check(x, dt, A, B, C, chunk, initial_state)
    _build.refuse_grad("ssd_scan", *tensors)
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, B, C, chunk=chunk,
                              initial_state=initial_state)
    b, s, h, p = x.shape
    n = B.shape[-1]
    if chunk > MAX_CHUNK or p > MAX_DIM or n > MAX_DIM:
        raise ValueError(f"ssd_scan: chunk {chunk}, p {p}, n {n}: the "
                         f"kernel takes chunk, p, n <= 128")
    x, dt, A, B, C, *init = [t.contiguous() for t in tensors]
    path = _path(x.dtype, p, n, _aligned((x, B, C)))
    y = torch.empty_like(x)
    fs = torch.empty((b, h, p, n), dtype=x.dtype, device=x.device)
    if y.numel():
        scratch = None
        if path == "wgmma":
            scratch = torch.zeros(lookback_scratch(b, h, p, n),
                                  dtype=torch.int64, device=x.device)
        _build.check(_lib().ssd_scan(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), init[0].data_ptr() if init else None,
            y.data_ptr(), fs.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            _DTYPES[x.dtype], PATHS[path], b, s, h, p, n, chunk,
            _build.stream_ptr(x)), f"ssd_scan ({path})")
        LAUNCHES["ssd_scan"] += 1
        LAUNCHES[f"ssd_scan_{path}"] += 1
    return y, fs
