#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON line each on stdout; any failure ends the run with a
non-zero exit:

1. device   the card, torch/CUDA versions, the TF32 switches, and the
            build of the CUDA kernels from ``src/repro_torch/csrc``.
2. kernels  each kernel against its plain PyTorch version on the card
            (edge shapes and the main path's shapes): int8 q/scale/zp
            exactly equal, float outputs within 1e-6. Device time per
            call of the kernel and of the plain version (profiler CUDA
            activity) with the L2 flushed before each call and warm,
            the time per call as the host sees it (CUDA events around
            one call on an idle card), and the bound.
3. train    ``repro_torch.launch.train`` on vgg16 (full width), int8
            codecs on every leg with error feedback, sequential path:
            the quantize/dequantize kernels must have launched.
4. fused    the same run with ``--fused-comm``, once with int8 (the
            roundtrip kernel must launch) and once with top-k (the
            sparse-combine kernel must launch).
5. parity   the resnet8 reference config with the int8 codec on the
            card and on the CPU: simulated clock and wire bytes exactly
            equal, per-round losses within 1e-3.

Then a ``kernels`` line (all four kernels with their launch counts on
the main path, times and bounds), the card's name and power limit as
nvidia-smi gives them, and as the last line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
FP32_OPS_PER_S = 67e12             # H100 SXM fp32 outside the tensor cores
TOL = 1e-6                         # float outputs vs the plain version
LOSS_TOL = 1e-3                    # card vs CPU per-round losses


def emit(phase: str, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 100, warmup: int = 10) -> float:
    """Median CUDA-event time of one call, after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def _profile(fn, iters: int) -> dict:
    """{kernel name: device µs summed over ``iters`` calls of fn}."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total for e in prof.key_averages()
            if e.self_device_time_total > 0}


def device_ms(fn, cold: bool, iters: int = 50):
    """Device time of one call from the profiler's CUDA activity: the
    kernels' device time summed over ``iters`` calls, divided by
    ``iters``. ``cold``: a 128 MB write before each call evicts the
    50 MB L2, so the inputs come from device memory (the bound's
    premise); its own kernel is left out of the sum.
    -> (ms, names of the kernels counted)."""
    import torch
    if cold:
        junk = torch.empty(32 << 20, dtype=torch.float32, device="cuda")
        flush_names = set(_profile(lambda: junk.fill_(1.0), 2))
        times = _profile(lambda: (junk.fill_(1.0), fn()), iters)
        times = {k: v for k, v in times.items() if k not in flush_names}
    else:
        times = _profile(fn, iters)
    if not times:
        fail("the profiler saw no device time")
    return (sum(times.values()) / iters / 1e3,
            sorted(k[:60] for k in times))


def bound(nbytes: float, ops: float):
    """-> (bound_ms, bound_by): the larger of the bytes over the memory
    rate and the fp32 operations over the fp32 rate."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = ops / FP32_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


# ---------------------------------------------------------------- inputs
def int8_inputs(dev, gen):
    """Edge rows and the main path's (R, 256) shapes."""
    import torch
    xs = []
    for r, g in [(1, 1), (3, 10), (37, 16), (5, 255), (300, 256),
                 (2048, 256), (4096, 256), (8192, 256)]:
        x = torch.randn(r, g, generator=gen, device="cpu") * 3.0
        xs.append(x.to(dev))
    edge = torch.randn(6, 256, generator=gen) * 2.0
    edge[0] = 0.0                                    # all-zero (post-ReLU)
    edge[1] = 2.5                                    # constant: scale floor
    edge[2] = torch.relu(edge[2])                    # half zeros
    # .5 boundaries: mn 0, mx 254 -> scale 1, zp -127, x/scale+zp = k+.5
    edge[3, 0], edge[3, 1] = 0.0, 254.0
    edge[3, 2:] = torch.arange(254, dtype=torch.float32)[:254] + 0.5
    edge[4] = torch.arange(256, dtype=torch.float32) * 1e-3 - 7.0
    xs.append(edge.to(dev))
    return xs


def sparse_inputs(dev, gen):
    import torch
    out = []
    for d, n, k, scale in [(1, 8, 2, 1.0), (5, 33, 4, 33 / 4),
                           (3, 1001, 101, 1.0), (4, 524288, 52429, 1.0),
                           (4, 1048576, 104858, 1.0)]:
        y = (torch.randn(d, n, generator=gen) * 2.0).to(dev)
        idx = torch.topk(y.abs(), k, dim=1).indices
        mask = torch.zeros_like(y).scatter_(1, idx, 1.0)
        out.append((y, mask, scale))
    return out


# ---------------------------------------------------------------- phases
def phase_device(torch, build):
    smi = nvidia_smi()
    t0 = time.time()
    libs = build.build(["int8_quant", "comm_fused"])
    build_s = time.time() - t0
    for lib in libs.values():
        log = lib.with_suffix(".log")
        if log.exists():
            print(log.read_text(), file=sys.stderr)
    emit("device", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), kernel_build_s=build_s,
         kernel_libs=[p.name for p in libs.values()],
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32)
    return smi


def phase_kernels(torch, dev):
    from repro_torch.kernels.comm_fused import kernel as cf
    from repro_torch.kernels.int8_quant import kernel as iq
    gen = torch.Generator().manual_seed(0)
    worst = {"int8_quantize": 0.0, "int8_dequantize": 0.0,
             "int8_roundtrip": 0.0, "sparse_combine": 0.0}
    for x in int8_inputs(dev, gen):
        q, s, z = iq.int8_quantize_rows(x)
        qp, sp, zp = iq.int8_quantize_plain(x)
        if not (torch.equal(q, qp) and torch.equal(s, sp)
                and torch.equal(z, zp)):
            fail(f"int8_quantize differs from its plain version at "
                 f"{tuple(x.shape)}: q {int((q != qp).sum())}, scale "
                 f"{int((s != sp).sum())}, zp {int((z != zp).sum())} "
                 f"values")
        d = iq.int8_dequantize_rows(q, s, z)
        err = float((d - iq.int8_dequantize_plain(q, s, z)).abs().max())
        worst["int8_dequantize"] = max(worst["int8_dequantize"], err)
        rt = cf.int8_roundtrip(x)
        err = float((rt - cf.int8_roundtrip_plain(x)).abs().max())
        worst["int8_roundtrip"] = max(worst["int8_roundtrip"], err)
    for y, mask, scale in sparse_inputs(dev, gen):
        out, res = cf.sparse_combine(y, mask, scale)
        op, rp = cf.sparse_combine_plain(y, mask, scale)
        err = max(float((out - op).abs().max()),
                  float((res - rp).abs().max()))
        worst["sparse_combine"] = max(worst["sparse_combine"], err)
    torch.cuda.synchronize()
    for name, err in worst.items():
        if not err <= TOL:
            fail(f"{name} differs from its plain version by {err}")

    # times at the main path's shapes (vgg16, batch 32, split 2: 2048
    # group rows per device, a 4-device cohort on the fused path)
    x = (torch.randn(2048, 256, generator=gen) * 3.0).to(dev)
    xc = (torch.randn(8192, 256, generator=gen) * 3.0).to(dev)
    y, mask, scale = sparse_inputs(dev, gen)[3]
    q, s, z = iq.int8_quantize_rows(x)
    n, nc, ns = x.numel(), xc.numel(), y.numel()
    rows = {
        "int8_quantize": (
            lambda: iq.int8_quantize_rows(x),
            lambda: iq.int8_quantize_plain(x), (2048, 256),
            bound(n * 5 + 2048 * 8, n * 7), "int8_quantize_pallas"),
        "int8_dequantize": (
            lambda: iq.int8_dequantize_rows(q, s, z),
            lambda: iq.int8_dequantize_plain(q, s, z), (2048, 256),
            bound(n * 5 + 2048 * 8, n * 2), "int8_dequantize_pallas"),
        "int8_roundtrip": (
            lambda: cf.int8_roundtrip(xc),
            lambda: cf.int8_roundtrip_plain(xc), (8192, 256),
            bound(nc * 8, nc * 9), "int8_roundtrip_pallas"),
        "sparse_combine": (
            lambda: cf.sparse_combine(y, mask, scale),
            lambda: cf.sparse_combine_plain(y, mask, scale), (4, 524288),
            bound(ns * 16 + 4, ns * 3), "sparse_combine_pallas"),
    }
    timed = {}
    for name, (kern, plain, shape, (b_ms, b_by), _) in rows.items():
        # plain, kernel, kernel, plain: the two versions in turns
        p1, k1, k2, p2 = (device_ms(plain, True), device_ms(kern, True),
                          device_ms(kern, True), device_ms(plain, True))
        warm_k, warm_p = device_ms(kern, False), device_ms(plain, False)
        c_p1, c_k1, c_k2, c_p2 = (time_ms(plain), time_ms(kern),
                                  time_ms(kern), time_ms(plain))
        timed[name] = {"shape": list(shape), "ms": min(k1[0], k2[0]),
                       "plain_ms": min(p1[0], p2[0]), "bound_ms": b_ms,
                       "bound_by": b_by, "library_ms": None,
                       "max_abs_err": worst[name]}
        emit("kernel", name=name, **timed[name],
             device_ms_runs=[k1[0], k2[0]],
             plain_device_ms_runs=[p1[0], p2[0]],
             warm_l2_ms=warm_k[0], plain_warm_l2_ms=warm_p[0],
             call_ms_runs=[c_k1, c_k2], plain_call_ms_runs=[c_p1, c_p2],
             device_kernels=k1[1], plain_device_kernels=p1[1])
    return timed


def reset_launches():
    from repro_torch.kernels.comm_fused import kernel as cf
    from repro_torch.kernels.int8_quant import kernel as iq
    for counts in (iq.LAUNCHES, cf.LAUNCHES):
        for k in counts:
            counts[k] = 0


def launches() -> dict:
    from repro_torch.kernels.comm_fused import kernel as cf
    from repro_torch.kernels.int8_quant import kernel as iq
    return {**iq.LAUNCHES, **cf.LAUNCHES}


def run_train(args, tmp: Path, tag: str) -> dict:
    from repro_torch.launch import train
    out = tmp / f"{tag}.json"
    train.main([*args, "--out", str(out)])
    with open(out) as f:
        return json.load(f)


VGG = ["--arch", "vgg16", "--rounds", "2", "--clients", "8",
       "--per-round", "4", "--batch-size", "32", "--n-train", "2000",
       "--alpha", "0.5", "--eval-every", "1000", "--seed", "0"]


def phase_train(torch, tmp, tag, extra, need):
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    res = run_train([*VGG, "--device", "cuda", *extra], tmp, tag)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = launches()
    losses = [h["loss"] for h in res["history"]]
    if not all(math.isfinite(v) for v in losses):
        fail(f"{tag}: non-finite losses {losses}")
    if not math.isfinite(res["final"]["loss"]):
        fail(f"{tag}: non-finite eval loss")
    for k in need:
        if counts[k] <= 0:
            fail(f"{tag}: kernel {k} was never launched ({counts})")
    emit(tag, args=extra, launches=counts, losses=losses,
         eval=res["final"], clock=res["clock"], comm=res["comm"],
         wall_s=wall)
    return counts


def phase_parity(tmp):
    base = ["--arch", "resnet8", "--rounds", "3", "--clients", "6",
            "--per-round", "4", "--batch-size", "16", "--n-train", "240",
            "--alpha", "0.3", "--eval-every", "1000", "--seed", "0",
            "--codec", "int8"]
    gpu = run_train([*base, "--device", "cuda"], tmp, "parity_cuda")
    cpu = run_train([*base, "--device", "cpu"], tmp, "parity_cpu")
    lg = [h["loss"] for h in gpu["history"]]
    lc = [h["loss"] for h in cpu["history"]]
    dl = max(abs(a - b) for a, b in zip(lg, lc))
    if gpu["clock"] != cpu["clock"] or gpu["comm"] != cpu["comm"]:
        fail(f"parity: clock/comm differ: card {gpu['clock']} "
             f"{gpu['comm']}, cpu {cpu['clock']} {cpu['comm']}")
    if not dl <= LOSS_TOL:
        fail(f"parity: losses differ by {dl}: {lg} vs {lc}")
    emit("parity", clock=gpu["clock"], comm=gpu["comm"], losses_cuda=lg,
         losses_cpu=lc, max_loss_diff=dl)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch.kernels import _build
    from repro_torch.utils.device import resolve_device
    dev = resolve_device("cuda")

    smi = phase_device(torch, _build)
    timed = phase_kernels(torch, dev)
    with tempfile.TemporaryDirectory() as d:
        tmp = Path(d)
        seq = phase_train(torch, tmp, "train_int8",
                          ["--codec", "int8", "--dispatch-codec", "int8",
                           "--error-feedback"],
                          ["int8_quantize", "int8_dequantize"])
        f_int8 = phase_train(torch, tmp, "fused_int8",
                             ["--fused-comm", "--codec", "int8",
                              "--error-feedback"], ["int8_roundtrip"])
        f_topk = phase_train(torch, tmp, "fused_topk",
                             ["--fused-comm", "--codec", "topk",
                              "--error-feedback"], ["sparse_combine"])
        phase_parity(tmp)

    main_path = {"int8_quantize": seq, "int8_dequantize": seq,
                 "int8_roundtrip": f_int8, "sparse_combine": f_topk}
    replaces = {
        "int8_quantize": "src/repro/kernels/int8_quant/kernel.py:48",
        "int8_dequantize": "src/repro/kernels/int8_quant/kernel.py:80",
        "int8_roundtrip": "src/repro/kernels/comm_fused/kernel.py:49",
        "sparse_combine": "src/repro/kernels/comm_fused/kernel.py:82",
    }
    source = {"int8_quantize": "src/repro_torch/csrc/int8_quant.cu",
              "int8_dequantize": "src/repro_torch/csrc/int8_quant.cu",
              "int8_roundtrip": "src/repro_torch/csrc/comm_fused.cu",
              "sparse_combine": "src/repro_torch/csrc/comm_fused.cu"}
    kernels = [{"name": k, "route": "cuda", "source": source[k],
                "replaces": replaces[k],
                "launches": main_path[k][k],
                "max_abs_err": timed[k]["max_abs_err"],
                "ms": timed[k]["ms"], "plain_ms": timed[k]["plain_ms"],
                "bound_ms": timed[k]["bound_ms"],
                "bound_by": timed[k]["bound_by"],
                "library_ms": timed[k]["library_ms"],
                "shape": timed[k]["shape"]} for k in replaces]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
