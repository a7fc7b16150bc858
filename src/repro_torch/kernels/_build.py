"""Build the CUDA sources under ``repro_torch/csrc`` and load them.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C
interface, compiled by ``nvcc`` for Hopper (``sm_90a``) on first use and
loaded with ``ctypes``. Libraries go to ``build/kernels/`` at the root of
the checkout (listed in ``.gitignore``), named by a hash of the sources
and flags, so an edited source is rebuilt and an unchanged one is not.

``-use_fast_math`` is deliberately absent: it would turn ``x / scale``
into a reciprocal multiply and move the int8 codec's ``.5`` rounding
boundaries away from the reference's.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: dict = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "from source on the machine with the card")
    return path


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for csrc/<name>.cu unless its library is built;
    -> (target, process or None)."""
    target = _target(name)
    if target.exists():
        return target, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return target, (proc, tmp)


def _finish(name: str, target: Path, job) -> None:
    if job is None:
        return
    proc, tmp = job
    log, _ = proc.communicate()
    target.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log}")
    os.replace(tmp, target)


def build(names) -> dict:
    """Compile the named sources, all nvcc processes at once;
    -> {name: library path}."""
    with _LOCK:
        jobs = {n: _start(n) for n in names}
        for n, (target, job) in jobs.items():
            _finish(n, target, job)
        return {n: target for n, (target, _) in jobs.items()}


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The library of csrc/<name>.cu, built on first use. ``signatures``
    maps each C entry to its ctypes argtypes; every entry returns the
    ``cudaError_t`` of its launch as an int."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def refuse_grad(what: str, *tensors) -> None:
    """Raise where autograd would need a backward the kernel does not
    have: grad mode on and any input requiring a gradient. Its output
    would carry no ``grad_fn`` and the weights before it would quietly
    get no gradient. The reference's kernels have no gradient either, so
    training runs the model with ``attn_impl="xla"``."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: the kernel has no backward, and an input requires a "
            f"gradient; train with attn_impl=\"xla\" (the plain path)")


def stream_ptr(t) -> int:
    """The current CUDA stream of t's device, as the C entries take it."""
    return torch.cuda.current_stream(t.device).cuda_stream
