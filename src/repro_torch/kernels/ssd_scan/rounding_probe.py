"""Which f32 operands of the SSD scan's wgmma path need their bf16
remainder pass.

The wgmma path splits three f32 operands into a bf16 high part and a
bf16 remainder and runs each of their products twice: W = L o S o dt,
the carried state and B o tail. This script builds ``csrc/ssd_scan.cu``
once as it is and once per operand with that operand's remainder set to
zero (so it is rounded to bf16 once), and once with all three rounded
once. Each build runs on the card at zamba2-1.2b's and mamba2-2.7b's
serving shapes (batch 4, 2048 tokens) against the plain version. One
JSON line per build and shape gives the worst error of y and of the
final state and their excess over the bf16 tolerance (0.1, 3e-2):
max(|out - ref| - rtol |ref|) - atol, which is <= 0 iff inside.

    PYTHONPATH=src python -m repro_torch.kernels.ssd_scan.rounding_probe

It needs the card and ``nvcc``; the libraries go to
``build/rounding_probe/`` (git-ignored).
"""
from __future__ import annotations

import ctypes
import json
import subprocess

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan import kernel as ss

TOL = (0.1, 3e-2)
# (b, s, h, p, n, chunk) of one SSM layer's scan at the serving batch
SHAPES = {"zamba2-1.2b": (4, 2048, 64, 64, 64, 128),
          "mamba2-2.7b": (4, 2048, 80, 64, 128, 128)}
# operand -> (the source line that stores its remainder, the same line
# storing zeros instead)
ROUND_ONCE = {
    "W": ("      wh[kk][q] = pack_split(w0, w1, wl[kk][q]);",
          "      wh[kk][q] = pack_split(w0, w1, wl[kk][q]);\n"
          "      wl[kk][q] = 0u;"),
    "state": ("      *reinterpret_cast<uint32_t*>(sm + T::kSl + off) = lo;",
              "      *reinterpret_cast<uint32_t*>(sm + T::kSl + off) = 0u;"),
    "B_tail": ("    *reinterpret_cast<uint4*>(sm + T::kBtl + off) = lv;",
               "    *reinterpret_cast<uint4*>(sm + T::kBtl + off) ="
               " make_uint4(0u, 0u, 0u, 0u);"),
}
VARIANTS = {"split": (), "W": ("W",), "state": ("state",),
            "B_tail": ("B_tail",), "all_once": tuple(ROUND_ONCE)}


def _source(operands) -> str:
    src = (_build.CSRC / "ssd_scan.cu").read_text()
    for op in operands:
        old, new = ROUND_ONCE[op]
        if src.count(old) != 1:
            raise RuntimeError(f"ssd_scan.cu: the line of {op}'s remainder "
                               f"is not found once: {old!r}")
        src = src.replace(old, new)
    return src


def build() -> dict:
    """One nvcc per variant, all at once; -> {variant: ctypes library}."""
    out = _build.BUILD_DIR.parent / "rounding_probe"
    out.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, ops in VARIANTS.items():
        src = out / f"ssd_scan_{name}.cu"
        src.write_text(_source(ops))
        lib = out / f"libssd_scan_{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
               "-o", str(lib), str(src)]
        jobs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (path, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {name} variant:\n{log}")
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in ss._SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def inputs(shape, seed: int = 0):
    """tests/test_torch_cuda.py's distributions: normal x, B, C (bf16);
    softplus dt; A = -exp(normal); initial state normal * 0.1."""
    b, s, h, p, n, _ = shape
    g = torch.Generator().manual_seed(seed)
    bf = torch.bfloat16
    x = torch.randn(b, s, h, p, generator=g).to(bf)
    B = torch.randn(b, s, n, generator=g).to(bf)
    C = torch.randn(b, s, n, generator=g).to(bf)
    dt = F.softplus(torch.randn(b, s, h, generator=g))
    A = -torch.exp(torch.randn(h, generator=g))
    init = (torch.randn(b, h, p, n, generator=g) * 0.1).to(bf)
    return [t.cuda() for t in (x, dt, A, B, C, init)]


def _excess(out, ref) -> float:
    atol, rtol = TOL
    d = (out.float() - ref.float()).abs() - rtol * ref.float().abs()
    return float(d.max()) - atol


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("rounding_probe: no CUDA device")
    libs = build()
    lib_of = ss._lib
    try:
        for arch, shape in SHAPES.items():
            x, dt, A, B, C, init = inputs(shape)
            chunk = shape[5]
            y_p, f_p = ss.ssd_scan_plain(x, dt, A, B, C, chunk=chunk,
                                         initial_state=init)
            for name, lib in libs.items():
                ss._lib = lambda lib=lib: lib
                before = ss.LAUNCHES["ssd_scan_wgmma"]
                y, f = ss.ssd_scan(x, dt, A, B, C, chunk=chunk,
                                   initial_state=init)
                torch.cuda.synchronize()
                if ss.LAUNCHES["ssd_scan_wgmma"] != before + 1:
                    raise RuntimeError(f"{arch}: not on the wgmma path")
                print(json.dumps({
                    "rounding_probe": name, "arch": arch,
                    "shape": list(shape), "tol": list(TOL),
                    "y_max_abs_err": float((y.float() - y_p.float())
                                           .abs().max()),
                    "state_max_abs_err": float((f.float() - f_p.float())
                                               .abs().max()),
                    "y_excess": _excess(y, y_p),
                    "state_excess": _excess(f, f_p),
                    "y_max_abs": float(y_p.float().abs().max())}),
                    flush=True)
    finally:
        ss._lib = lib_of
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
