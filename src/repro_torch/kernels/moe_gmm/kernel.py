"""Grouped expert FFN: per expert e, on its capacity bucket x_e (C, d),

    y_e = (act(x_e Wg_e) o (x_e Wu_e)) Wd_e

in f32 arithmetic, with y in x's dtype. act is silu or gelu (the tanh
approximation, as ``jax.nn.gelu``). x is float32 or bfloat16; the three
weights share float32 or bfloat16 (the reference passes the params as
they are, f32 by default, beside bf16 activations).

On a CUDA tensor the wrapper launches the hand-written Hopper kernels
(``csrc/moe_gmm.cu``: a gate/up kernel into a workspace, then a down
kernel) or raises; ``_path`` picks the pair from the dtypes, C, d, F
and the alignment alone. With f32 weights the TMA paths split each
weight into a bf16 high part and remainder on the card and keep h as
such a pair, so neither enters a product as a single bf16. On a CPU
tensor it runs the plain version beside it, the reference's
``moe_gmm/ref.py``. ``LAUNCHES["moe_gmm"]``
counts wrapper calls that launched a kernel pair,
``LAUNCHES["moe_gmm_<path>"]`` those of each path.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

ACTS = {"silu": 0, "gelu": 1}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "moe_gmm": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
}
# the C entry's path codes
PATHS = {"f32": 0, "mma": 1, "stream": 2, "wgmma": 3}
# The largest C that takes the "stream" path (decode-sized buckets);
# above it "wgmma". Measured on an H100 at E 64, d 2048, F 1408, with
# bf16 and with f32 weights (PERF.md, the threshold sweep of
# chip_smoke.py); the stream kernels take C up to 64.
STREAM_MAX_C = 64

LAUNCHES = {"moe_gmm": 0, **{f"moe_gmm_{p}": 0 for p in PATHS}}


def _lib():
    return _build.load("moe_gmm", _SIGNATURES)


def _act(act: str):
    if act == "silu":
        return F.silu
    return lambda v: F.gelu(v, approximate="tanh")


# ----------------------------------------------------------- plain version
def moe_gmm_plain(x, wg, wu, wd, *, act: str = "silu"):
    """x: (E, C, d); wg/wu: (E, d, F); wd: (E, F, d) -> (E, C, d)."""
    f32 = torch.float32
    xf = x.to(f32)
    g = _act(act)(torch.einsum("ecd,edf->ecf", xf, wg.to(f32)))
    u = torch.einsum("ecd,edf->ecf", xf, wu.to(f32))
    y = torch.einsum("ecf,efd->ecd", g * u, wd.to(f32))
    return y.to(x.dtype)


# ----------------------------------------------------------------- wrapper
def _check(x, wg, wu, wd, act):
    if act not in ACTS:
        raise ValueError(f"moe_gmm: act must be one of {sorted(ACTS)}, "
                         f"got {act!r}")
    if x.dim() != 3 or any(w.dim() != 3 for w in (wg, wu, wd)):
        raise ValueError("moe_gmm: want 3-D x, wg, wu, wd")
    E, C, d = x.shape
    Fd = wg.shape[-1]
    if (tuple(wg.shape) != (E, d, Fd) or tuple(wu.shape) != (E, d, Fd)
            or tuple(wd.shape) != (E, Fd, d)):
        raise ValueError(f"moe_gmm: shapes x {tuple(x.shape)}, wg "
                         f"{tuple(wg.shape)}, wu {tuple(wu.shape)}, wd "
                         f"{tuple(wd.shape)}")
    if (x.dtype not in _DTYPES or wg.dtype not in _DTYPES
            or not (wg.dtype == wu.dtype == wd.dtype)):
        raise ValueError(f"moe_gmm: x and the (shared) weight dtype must be "
                         f"float32 or bfloat16, got {x.dtype} {wg.dtype} "
                         f"{wu.dtype} {wd.dtype}")
    if any(w.device != x.device for w in (wg, wu, wd)):
        raise ValueError("moe_gmm: inputs on different devices")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"moe_gmm: unsupported device {x.device}")


def _path(x_dtype, w_dtype, C: int, d: int, F: int, aligned: bool) -> str:
    """The kernel pair a CUDA call runs. "f32" (the fp32 cores): float32
    x. "stream" (C <= STREAM_MAX_C) or "wgmma" (tensor cores fed by
    TMA): bf16 x, bf16 or f32 weights, d and F multiples of 8 and
    ``aligned`` tensors. "mma" (tensor cores, operands staged through
    registers): the other bf16 x."""
    if x_dtype == torch.float32:
        return "f32"
    if aligned and d % 8 == 0 and F % 8 == 0:
        return "stream" if C <= STREAM_MAX_C else "wgmma"
    return "mma"


def _aligned(tensors) -> bool:
    """What TMA asks of a contiguous tensor's base: 16 bytes."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def moe_gmm(x, wg, wu, wd, *, act: str = "silu"):
    """Kernel wrapper of ``moe_gmm_plain``; refuses inputs that require a
    gradient under grad mode, on the CPU too (no backward)."""
    _check(x, wg, wu, wd, act)
    _build.refuse_grad("moe_gmm", x, wg, wu, wd)
    if x.device.type == "cpu":
        return moe_gmm_plain(x, wg, wu, wd, act=act)
    x, wg, wu, wd = (t.contiguous() for t in (x, wg, wu, wd))
    E, C, d = x.shape
    path = _path(x.dtype, wg.dtype, C, d, wg.shape[-1],
                 _aligned((x, wg, wu, wd)))
    return _launch(x, wg, wu, wd, act, path)


def _workspace(path, w_dtype, E: int, C: int, F: int):
    """-> (shape, dtype) of h between the two kernels: f32 on the "f32"
    and "mma" paths; on the TMA paths bf16, or with f32 weights a bf16
    hi / lo pair, each row Fp / 32 groups of 32 hi then 32 lo values (Fp:
    F rounded up to 32; the pad is written as zeros), the bytes of an
    f32 h when F is a multiple of 32."""
    if path not in ("stream", "wgmma"):
        return (E, C, F), torch.float32
    if w_dtype == torch.bfloat16:
        return (E, C, F), torch.bfloat16
    return (E, C, 2 * (-(-F // 32) * 32)), torch.bfloat16


def _launch(x, wg, wu, wd, act, path):
    """One launch of the kernel pair of ``path`` on contiguous CUDA
    tensors (``moe_gmm`` picks the path; the threshold sweep of
    chip_smoke.py times the stream and wgmma pairs side by side)."""
    E, C, d = x.shape
    Fd = wg.shape[-1]
    if E > 65535:
        raise ValueError(f"moe_gmm: {E} experts > 65535 (the grid's z)")
    y = torch.empty_like(x)
    if y.numel():
        shape, dtype = _workspace(path, wg.dtype, E, C, Fd)
        h = torch.empty(shape, dtype=dtype, device=x.device)
        _build.check(_lib().moe_gmm(
            x.data_ptr(), wg.data_ptr(), wu.data_ptr(), wd.data_ptr(),
            h.data_ptr(), y.data_ptr(), _DTYPES[x.dtype], _DTYPES[wg.dtype],
            PATHS[path], E, C, d, Fd, ACTS[act], _build.stream_ptr(x)),
            f"moe_gmm ({path})")
        LAUNCHES["moe_gmm"] += 1
        LAUNCHES[f"moe_gmm_{path}"] += 1
    return y
