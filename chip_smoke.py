#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON line each on stdout; any failure ends the run with a
non-zero exit:

1. device   the card, torch/CUDA versions, the TF32 switches, and the
            build of the CUDA kernels from ``src/repro_torch/csrc``.
2. kernels  each kernel against its plain PyTorch version on the card
            (edge shapes and the main path's shapes): the int8 pair
            bit-equal (q, scale, zp and x'), as rows and as lists (a
            vgg16 model leg, both feature shapes, one value, g not a
            multiple of 4, a list past the segment cap, an empty list,
            views off 16 bytes), other float outputs within 1e-6.
            Device time per call of the kernel and of the plain version
            (CUDA events around a run of calls that a spin kernel lets
            the host queue in full) with the L2 flushed before each call
            and warm, the time per call as the host sees it (CUDA events
            around one call on an idle card), and the bound; the int8
            pair at vgg16's model legs and feature transfers, beside the
            time of an empty kernel (the launch floor).
   int8_leg_side_by_side  one vgg16 model leg through the int8 codec as
            a per-leaf loop of list-of-one round trips and as one list
            call: device time and the host's wall per leg.
3. train    ``repro_torch.launch.train`` on vgg16 (full width), int8
            codecs on every leg with error feedback, sequential path:
            exactly 32 quantize and 32 dequantize launches (16 model
            legs, 16 feature transfers), clock 5.61946362688 and comm
            14229056.0; then the same run under the profiler, device ms
            by kernel group and the card's idle share.
4. fused    the same run with ``--fused-comm``, once with int8 (the
            roundtrip kernel must launch) and once with top-k (the
            sparse-combine kernel must launch).
5. parity   the resnet8 reference config with the int8 codec on the
            card and on the CPU: simulated clock and wire bytes exactly
            equal, per-round losses within 1e-3.
5a. train_fused_server  vgg16 at full width on the fused int8 cohort
            path (``--fused-comm --codec int8 --error-feedback``),
            without and then with ``--fused-server``: the multi-group
            server step must batch (calls and groups counted by wrapping
            the engine's ``_multi_server_step``, no counter in the
            engine), with clock, comm, splits and the int8_roundtrip
            launches exactly those of the sequential server path and
            losses within 1e-3; the host wall of each round of both.
5b. train_service  vgg16 at full width, 3 rounds, int8 with error
            feedback, churn (``--fault-kill-prob 0.25``), a snapshot
            every round, a trace and a metrics stream, on the phase
            timeline (``--pipeline``: the trace's flights need it):
            straight twice, then resumed from the first run's round-1
            snapshot. History (losses aside), splits, clock, comm and
            the dispatched / committed / abandoned ledger exactly equal;
            the resumed run's int8 launches those of the straight run's
            rounds 2-3; whether the straight runs' params agree bitwise
            (if they do, the resumed run's must; if not, it must be no
            further from the first straight run than the second is);
            the trace must load and hold flights, the metrics file 4
            records. Prints each snapshot's host wall.
5c. parity_control  the resnet8 reference config with the int8 codec,
            6 rounds, under ``--exec-mode semi_async --resource-aware
            --scheduler joint --auto-knobs --fleet-size 100000
            --clusters 4 --fault-kill-prob 0.2``, on the card and on the
            CPU: clock, comm, splits, the ledger and the knob
            controller's lock and rejections exactly equal, losses
            within 1e-3.
6. lm_kernels  flash attention, the SSD scan and moe_gmm against their
            plain versions on the card (flash, f32 and bf16: the zamba2
            and deepseek MLA serving shapes, GQA with a window, D = 120,
            non-causal, S not a multiple of 64, D = Dv = 256, each
            bf16 case on the wgmma path; and bf16 that TMA cannot take
            on the fp32-core path: tensors off a 16-byte boundary at
            both serving shapes, and D or Dv not a multiple of 8; ssd,
            f32 and bf16, each bf16 case on its asserted path: the
            serving shape with a nonzero initial state, p = 64, n = 128,
            and 128 chunks on 16 chains with no initial state (wgmma),
            and p, n not multiples of 8 (mma); moe_gmm, each case on its
            asserted path: deepseek's prefill (wgmma) and decode
            (stream) shapes in bf16, bf16 x with f32 weights at the
            prefill shape, d not a multiple of 8, and x off a 16-byte
            boundary at the decode shape (mma), and the reference's
            five kernel-test cases, gelu and non-128 shapes included),
            then cold / warm device time, plain time, bound and, for
            flash, the path, the achieved TFLOP/s and the time of
            PyTorch's SDPA at both serving shapes (a yardstick only; the
            port never calls it); for ssd, the path, the look-back
            scratch's bytes, the device time of the fill kernel that
            zeroes it and the kernels one call runs; for moe_gmm at both
            serving shapes, three bf16 ``torch.bmm`` of the same shapes
            (a yardstick only), and the stream / wgmma threshold sweep:
            both paths' cold time at C 8 to 256 (E 64, d 2048, F 1408).
7. serve    zamba2-1.2b at full width (38 layers, d_model 2048, vocab
            32000) in bf16 with attn_impl="pallas", through
            ``repro_torch.launch.serve.generate``: batch 4, prompt 2048,
            32 greedy tokens; flash must launch exactly 6 times, all on
            the wgmma path, and the SSD scan 32 times (one prefill), all
            on the wgmma path.
            Prints prefill seconds, decode tokens/s, peak memory and the
            prefill and decode profiles.
8. serve_parity  zamba2 at 6 layers (both block kinds), d_model 256, in
            float32, card vs CPU: prefill and decode logits within 1e-4,
            both sides stepped with the CPU's greedy tokens.
9. serve_moe  deepseek-v2-lite-16b at full width (27 layers: one dense,
            26 MoE of 64 experts top-6 + 2 shared; MLA in every layer;
            d_model 2048, vocab 102400) with bf16 params (the one cut:
            f32 would hold 62.8 GB of the 80) and attn_impl="pallas",
            through ``generate``: batch 4, prompt 2048, 32 greedy tokens.
            One prefill must launch moe_gmm exactly 26 times and flash 27
            times, all on their wgmma paths, the whole generate moe_gmm
            858 times (26 per prefill and per decode step): 26 on wgmma
            and the 832 of the decode steps on stream. Prints init
            seconds, prefill seconds, decode tokens/s, peak memory, a
            prefill profile and a decode profile (device ms by kernel
            group over the decode steps of one generate, with the idle
            share).
10. serve_moe_parity  reduced deepseek (a dense and an MoE layer, MLA)
            in float32, card vs CPU: prefill and decode logits within
            1e-4, both sides stepped with the CPU's greedy tokens.

Then a ``kernels`` line (all seven kernels with their launch counts on
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
BF16_OPS_PER_S = 989e12            # H100 SXM bf16 tensor cores, dense
TOL = 1e-6                         # float outputs vs the plain version
LOSS_TOL = 1e-3                    # card vs CPU per-round losses
# kernel vs plain, (atol, rtol) by dtype: the reference's own kernel
# tolerances (tests/test_kernels.py)
FA_TOL = {"float32": (2e-5, 0.0), "bfloat16": (2e-2, 0.0)}
SSD_TOL = {"float32": (2e-4, 1e-5), "bfloat16": (0.1, 3e-2)}
GMM_TOL = {"float32": 1e-5, "bfloat16": 2e-2}   # by the output's dtype
SERVE_TOL = 1e-4                   # card vs CPU logits, float32


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


def _profile(fn, iters: int, counts: dict | None = None) -> dict:
    """{kernel name: device µs summed over ``iters`` calls of fn}, from
    the profiler's CUDA activity; ``counts``, if given, receives
    {kernel name: launches}."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    if counts is not None:
        counts.clear()
        counts.update({e.key: e.count for e in events})
    return {e.key: e.self_device_time_total for e in events}


_SPIN = {}


def _spin_cycles_per_ms() -> float:
    """Clock cycles of ``torch.cuda._sleep`` per ms on this card."""
    import torch
    if not _SPIN:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        torch.cuda._sleep(10 ** 7)
        b.record()
        torch.cuda.synchronize()
        _SPIN["per_ms"] = 10 ** 7 / a.elapsed_time(b)
    return _SPIN["per_ms"]


def device_ms(fn, cold: bool, iters: int = 20) -> float:
    """Device time of one call: CUDA events around a run of ``iters``
    calls, over ``iters``. A spin kernel first holds the card while the
    host queues the whole run, so the interval holds the calls' device
    work and not the host's launch path. ``cold``: a 128 MB write
    before each call evicts the 50 MB L2, so the inputs come from
    device memory (the bound's premise); the same run of writes alone
    is timed too and taken off."""
    import torch
    junk = (torch.empty(32 << 20, dtype=torch.float32, device="cuda")
            if cold else None)

    def flush():
        if cold:
            junk.fill_(1.0)
    fn()
    torch.cuda.synchronize()
    host_ms = 0.0                                  # to queue one call
    for _ in range(3):
        t0 = time.perf_counter()
        flush()
        fn()
        host_ms = max(host_ms, (time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    spin = int(_spin_cycles_per_ms() * (4.0 * host_ms * iters + 5.0))

    def run(body) -> float:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(spin)
        a.record()
        for _ in range(iters):
            body()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b)
    if not cold:
        return run(fn) / iters
    both = run(lambda: (flush(), fn()))
    return max(0.0, both - run(flush)) / iters


def bound(nbytes: float, ops: float, ops_per_s: float = FP32_OPS_PER_S):
    """-> (bound_ms, bound_by): the larger of the bytes over the memory
    rate and the operations over the rate of their type (fp32 by
    default)."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = ops / ops_per_s * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def excess(out, ref, atol: float, rtol: float) -> float:
    """max(|out - ref| - rtol |ref|) - atol: <= 0 iff allclose."""
    d = (out.float() - ref.float()).abs() - rtol * ref.float().abs()
    return float(d.max()) - atol


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


# the int8 list kernels' cases: tests/test_torch_cuda.py INT8_CASES (a
# vgg16 model leg, the two feature shapes, one value, g not a multiple
# of 4, a list past the segment cap, an empty list, views off 16 bytes)
INT8_LIST_CASES = {
    "vgg16_leg": [(64,), (64,), (3, 3, 3, 64), (64,), (64,),
                  (3, 3, 64, 64), (128,), (128,), (3, 3, 64, 128)],
    "features_2048_rows": [(32, 64, 16, 16)],
    "features_4096_rows": [(32, 128, 16, 16)],
    "one_value": [(1,)],
    "g_not_multiple_of_4": [(7,), (3, 85), (2, 129)],
    "over_segment_cap": [((37 * i) % 600 + 1,) for i in range(70)],
    "empty": [],
    "odd_offset_views": [(3, 3, 64, 64), (300,), (1728,)],
}


def at_odd_offset(t):
    """A contiguous copy of t whose base sits one element past an
    aligned one."""
    import torch
    return torch.cat([t.new_zeros(1), t.reshape(-1)])[1:].view(t.shape)


def vgg16_leg(dev, split: int):
    """The leaves a vgg16 model leg sends at ``split``: the client
    portion's BN scale / shift and conv weights, from the port's model
    (splits 2 and 3 are the legs of chip_smoke's 2-round run)."""
    from repro_torch.configs import get_config
    from repro_torch.models import SplitModel
    from repro_torch.utils.tree import get_subtree, tree_flatten
    model = SplitModel(get_config("vgg16"))
    params = model.init(0, device=dev)
    names = model.client_segments(split)
    return tree_flatten([get_subtree(params, p)
                         for n, p in model.segments() if n in names])[0]


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
    libs = build.build(["int8_quant", "comm_fused", "flash_attention",
                        "ssd_scan", "moe_gmm"])
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


def check_int8_lists(torch, dev, gen):
    """Every INT8_LIST_CASES list through the list kernels against the
    plain per-tensor loop: q, scale, zp and x' bit-equal, one launch a
    direction per MAX_SEGMENTS tensors."""
    from repro_torch.kernels.int8_quant import kernel as iq
    from repro_torch.kernels.int8_quant import ops as iq_ops
    for name, shapes in INT8_LIST_CASES.items():
        xs = [(torch.randn(sh, generator=gen) * (0.05 + i % 5)).to(dev)
              for i, sh in enumerate(shapes)]
        odd = name == "odd_offset_views"
        if odd:
            xs = [at_odd_offset(x) for x in xs]
        flats = [x.reshape(-1) for x in xs]
        groups = [iq_ops.group_size(f.numel()) for f in flats]
        launches = -(-len(flats) // iq.MAX_SEGMENTS)
        before = dict(iq.LAUNCHES)
        got = iq.int8_quantize_segments(flats, groups)
        want = iq.int8_quantize_segments_plain(flats, groups)
        qs, ss, zs = ([p[i] for p in got] for i in range(3))
        if odd:
            qs = [at_odd_offset(q) for q in qs]
        numels = [f.numel() for f in flats]
        out = iq.int8_dequantize_segments(qs, ss, zs, numels)
        ref = iq.int8_dequantize_segments_plain(qs, ss, zs, numels)
        torch.cuda.synchronize()
        bad = [i for i, ((q, s, z), (qp, sp, zp)) in enumerate(
            zip(got, want)) if not (torch.equal(q, qp) and torch.equal(
                s, sp) and torch.equal(z, zp))]
        bad += [i for i, (o, r) in enumerate(zip(out, ref))
                if not torch.equal(o, r)]
        moved = {k: iq.LAUNCHES[k] - before[k] for k in before}
        if bad or moved != {"int8_quantize": launches,
                            "int8_dequantize": launches}:
            fail(f"int8 list case {name}: tensors {bad} differ from the "
                 f"plain versions, launches {moved} (want {launches})")
    return len(INT8_LIST_CASES)


def int8_list_bound(flats, groups, quantize: bool):
    """Bound of one list call: each tensor's values (f32), its rows of
    int8 and 8 bytes of scale / zp a row, once each; ~7 operations a
    quantized value, 2 a dequantized one."""
    from repro_torch.kernels.int8_quant import kernel as iq
    values = sum(f.numel() for f in flats)
    rows = [iq.n_rows(f.numel(), g) for f, g in zip(flats, groups)]
    q_bytes = sum(r * g for r, g in zip(rows, groups))
    nbytes = values * 4 + q_bytes + 8 * sum(rows)
    return bound(nbytes, 7 * q_bytes if quantize else 2 * values)


def int8_list_rows(torch, dev, gen):
    """The list kernels timed at the main path's lists: vgg16's model
    legs at splits 3 (the row's own) and 2, and the feature transfers of
    (2048, 256) and (4096, 256) rows (lists of one), beside the time of
    an empty kernel (``torch.cuda._sleep(0)``) in the same harness, the
    launch floor. -> {kernel name: (kern, plain, shape, bound, extra)}"""
    from repro_torch.kernels.int8_quant import kernel as iq
    from repro_torch.kernels.int8_quant import ops as iq_ops
    lists = {"leg_split3": vgg16_leg(dev, 3), "leg_split2": vgg16_leg(dev, 2)}
    for r in (2048, 4096):
        lists[f"features_{r}_rows"] = [
            (torch.randn(r * 256, generator=gen) * 3.0).to(dev)]
    floor = {"launch_floor_ms": device_ms(lambda: torch.cuda._sleep(0),
                                          False, 50)}
    rows = {}
    for quantize, name in ((True, "int8_quantize"),
                           (False, "int8_dequantize")):
        calls = {}
        for key, xs in lists.items():
            flats = [x.reshape(-1) for x in xs]
            groups = [iq_ops.group_size(f.numel()) for f in flats]
            qs, ss, zs = zip(*iq.int8_quantize_segments(flats, groups))
            numels = [f.numel() for f in flats]
            if quantize:
                kern = (lambda f=flats, g=groups:
                        iq.int8_quantize_segments(f, g))
                plain = (lambda f=flats, g=groups:
                         iq.int8_quantize_segments_plain(f, g))
            else:
                kern = (lambda a=(qs, ss, zs, numels):
                        iq.int8_dequantize_segments(*a))
                plain = (lambda a=(qs, ss, zs, numels):
                         iq.int8_dequantize_segments_plain(*a))
            shape = [[iq.n_rows(f.numel(), g), g]
                     for f, g in zip(flats, groups)]
            calls[key] = (kern, plain, shape,
                          int8_list_bound(flats, groups, quantize))
        kern, plain, shape, bnd = calls.pop("leg_split3")
        also = {key: {"shape": sh, "ms": device_ms(k, True, 50),
                      "warm_l2_ms": device_ms(k, False, 50),
                      "bound_ms": b[0]}
                for key, (k, _, sh, b) in calls.items()}
        rows[name] = (kern, plain, shape, bnd, {**floor, **also})
    return rows


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
        if not torch.equal(d, iq.int8_dequantize_plain(q, s, z)):
            fail(f"int8_dequantize differs from its plain version at "
                 f"{tuple(x.shape)}")
        rt = cf.int8_roundtrip(x)
        err = float((rt - cf.int8_roundtrip_plain(x)).abs().max())
        worst["int8_roundtrip"] = max(worst["int8_roundtrip"], err)
    n_lists = check_int8_lists(torch, dev, gen)
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
    emit("int8_lists", cases=n_lists, bit_equal=True)

    # times at the main path's shapes: the int8 pair at its lists; the
    # fused kernels at a 4-device cohort (vgg16, batch 32, split 2: 2048
    # group rows per device)
    xc = (torch.randn(8192, 256, generator=gen) * 3.0).to(dev)
    y, mask, scale = sparse_inputs(dev, gen)[3]
    nc, ns = xc.numel(), y.numel()
    rows = int8_list_rows(torch, dev, gen)
    rows.update({
        "int8_roundtrip": (
            lambda: cf.int8_roundtrip(xc),
            lambda: cf.int8_roundtrip_plain(xc), (8192, 256),
            bound(nc * 8, nc * 9), {}),
        "sparse_combine": (
            lambda: cf.sparse_combine(y, mask, scale),
            lambda: cf.sparse_combine_plain(y, mask, scale), (4, 524288),
            bound(ns * 16 + 4, ns * 3), {}),
    })
    timed = {}
    for name, (kern, plain, shape, (b_ms, b_by), also) in rows.items():
        # plain, kernel, kernel, plain: the two versions in turns
        p1, k1, k2, p2 = (device_ms(plain, True, 50),
                          device_ms(kern, True, 50),
                          device_ms(kern, True, 50),
                          device_ms(plain, True, 50))
        warm_k = device_ms(kern, False, 50)
        warm_p = device_ms(plain, False, 50)
        c_p1, c_k1, c_k2, c_p2 = (time_ms(plain), time_ms(kern),
                                  time_ms(kern), time_ms(plain))
        timed[name] = {"shape": list(shape), "ms": min(k1, k2),
                       "plain_ms": min(p1, p2), "bound_ms": b_ms,
                       "bound_by": b_by, "library_ms": None,
                       "max_abs_err": worst[name], "warm_l2_ms": warm_k,
                       **also}
        emit("kernel", name=name, **timed[name], device_ms_runs=[k1, k2],
             plain_device_ms_runs=[p1, p2], plain_warm_l2_ms=warm_p,
             call_ms_runs=[c_k1, c_k2], plain_call_ms_runs=[c_p1, c_p2])
    return timed


def phase_int8_legs(torch, dev):
    """One vgg16 model leg (splits 2 and 3) through the int8 codec side
    by side in one run: the per-leaf loop of list-of-one round trips
    (``Int8Codec.roundtrip``, two launches a leaf) against one
    ``roundtrip_many`` (two launches a leg). Device time per leg cold
    and warm (the spin-queued harness), the host's wall per leg
    (synchronised, no spin, 200 legs), in turns (loop, list, list,
    loop); both give the same tensors and bytes."""
    from repro_torch.comm.codecs import Int8Codec
    from repro_torch.kernels.int8_quant import kernel as iq
    from repro_torch.kernels.int8_quant.ops import group_size
    codec = Int8Codec()

    def wall_ms(fn, n=200):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    out = {}
    for split in (2, 3):
        leg = vgg16_leg(dev, split)
        loop = lambda leg=leg: [codec.roundtrip(x) for x in leg]
        listed = lambda leg=leg: codec.roundtrip_many(leg)
        res, launches = {}, {}
        for key, fn in (("per_leaf", loop), ("list", listed)):
            before = iq.LAUNCHES["int8_quantize"]
            res[key] = fn()
            launches[key] = iq.LAUNCHES["int8_quantize"] - before
        if not all(torch.equal(ya, yb) and na == nb for (ya, na), (yb, nb)
                   in zip(res["per_leaf"], res["list"])):
            fail(f"int8 leg split {split}: the list call differs from "
                 f"the per-leaf loop")
        cold = [device_ms(f, True, 50) for f in (loop, listed, listed, loop)]
        warm = [device_ms(f, False, 50)
                for f in (loop, listed, listed, loop)]
        wall = [wall_ms(f) for f in (loop, listed, listed, loop)]
        out[f"split{split}"] = {
            "leaves": len(leg), "values": sum(x.numel() for x in leg),
            "rows": sum(iq.n_rows(x.numel(), group_size(x.numel()))
                        for x in leg),
            "quantize_launches": launches,
            "device_ms": {"per_leaf": min(cold[0], cold[3]),
                          "list": min(cold[1], cold[2])},
            "warm_device_ms": {"per_leaf": min(warm[0], warm[3]),
                               "list": min(warm[1], warm[2])},
            "host_wall_ms": {"per_leaf": min(wall[0], wall[3]),
                             "list": min(wall[1], wall[2])},
            "runs": {"device_ms": cold, "warm_device_ms": warm,
                     "host_wall_ms": wall}}
    emit("int8_leg_side_by_side", **out)


def _counters():
    from repro_torch.kernels.comm_fused import kernel as cf
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.int8_quant import kernel as iq
    from repro_torch.kernels.moe_gmm import kernel as gmm
    from repro_torch.kernels.ssd_scan import kernel as ss
    return (iq.LAUNCHES, cf.LAUNCHES, fa.LAUNCHES, ss.LAUNCHES,
            gmm.LAUNCHES)


def reset_launches():
    for counts in _counters():
        for k in counts:
            counts[k] = 0


def launches() -> dict:
    out = {}
    for counts in _counters():
        out.update(counts)
    return out


def run_train(args, tmp: Path, tag: str) -> dict:
    from repro_torch.launch import train
    out = tmp / f"{tag}.json"
    train.main([*args, "--out", str(out)])
    with open(out) as f:
        return json.load(f)


VGG = ["--arch", "vgg16", "--rounds", "2", "--clients", "8",
       "--per-round", "4", "--batch-size", "32", "--n-train", "2000",
       "--alpha", "0.5", "--eval-every", "1000", "--seed", "0"]


def phase_train(torch, tmp, tag, extra, need, exact=None):
    """One 2-round vgg16 run; every kernel of ``need`` must launch, and
    ``exact`` (launch counts, and ``clock`` / ``comm``) must be met
    exactly."""
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
    got = {**counts, "clock": res["clock"], "comm": res["comm"]}
    for k, want in (exact or {}).items():
        if got[k] != want:
            fail(f"{tag}: {k} is {got[k]}, want exactly {want}")
    emit(tag, args=extra, launches=counts, losses=losses,
         eval=res["final"], clock=res["clock"], comm=res["comm"],
         wall_s=wall)
    return counts


# kernel groups of a training profile, by name: the port's batch norm
# is plain PyTorch (models/cnn.py), so its statistics are reduce kernels
TRAIN_GROUPS = (
    ("int8_kernels", ("quantize",)),
    ("cudnn_conv", ("cudnn", "conv", "xmma", "implicit", "wgrad",
                    "dgrad")),
    ("reductions", ("reduce_kernel",)),
    ("gemm", ("gemm", "cutlass", "nvjet")),
    ("copies", ("memcpy", "memset", "copy")),
)


def phase_train_profile(torch, tmp, extra):
    """The train_int8 run again under the profiler: device ms by kernel
    group (the int8 list kernels, cuDNN's convolutions, reductions (the
    batch-norm statistics among them), GEMMs, copies and memsets, the
    other elementwise kernels) over the whole run, set-up included,
    beside its host-clock wall, and the share of it the card was
    idle."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        run_train([*VGG, "--device", "cuda", *extra], tmp, "train_profile")
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    groups = {g: 0.0 for g, _ in TRAIN_GROUPS}
    groups["elementwise"] = 0.0
    launches = dict.fromkeys(groups, 0)
    for e in events:
        low = e.key.lower()
        g = next((g for g, keys in TRAIN_GROUPS
                  if any(k in low for k in keys)), "elementwise")
        groups[g] += e.self_device_time_total / 1e3
        launches[g] += e.count
    busy = sum(groups.values())
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:10]
    emit("train_int8_profile", device_ms_by_group=groups,
         launches_by_group=launches, device_busy_ms=busy, wall_ms=wall_ms,
         idle_share=max(0.0, 1.0 - busy / wall_ms),
         kernels_seen=len(events),
         top_kernels_ms=[[e.key[:80], e.self_device_time_total / 1e3,
                          e.count] for e in top])


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


# ----------------------------- slice 8: the trainer's other modules
class Capture:
    """While active, wraps three methods of the port at class level (no
    counter is added to the port): ``S2FLEngine.run_round`` (the engine,
    each round's host wall and the launch counts after it),
    ``RoundDriver.run_round`` (each round's splits), and
    ``S2FLEngine._multi_server_step`` (each batched server call and the
    groups it stacked); and the trainer's ``save_run_state`` (each
    snapshot's host wall)."""

    def __enter__(self):
        import repro_torch.checkpoint as ck
        from repro_torch.core.driver import RoundDriver
        from repro_torch.core.engine import S2FLEngine
        from repro_torch.utils.tree import tree_leaves
        import torch
        self.engines, self.round_s, self.after_round = [], [], []
        self.splits, self.multi, self.snapshot_ms = [], [], []
        self._saved = [(S2FLEngine, "run_round"), (RoundDriver, "run_round"),
                       (S2FLEngine, "_multi_server_step"),
                       (ck, "save_run_state")]
        self._saved = [(o, n, getattr(o, n)) for o, n in self._saved]
        eng_round, drv_round, multi, save = (f for _, _, f in self._saved)

        def run_round(eng):
            if not self.engines or self.engines[-1] is not eng:
                self.engines.append(eng)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rec = eng_round(eng)
            torch.cuda.synchronize()
            self.round_s.append(time.perf_counter() - t0)
            self.after_round.append(launches())
            return rec

        def driver_round(drv, *a, **kw):
            rec = drv_round(drv, *a, **kw)
            self.splits.append({int(c): int(s)
                                for c, s in rec.splits.items()})
            return rec

        def multi_step(eng, gsplits, sp, *a):
            self.multi.append(int(tree_leaves(sp)[0].shape[0]))
            return multi(eng, gsplits, sp, *a)

        def save_run_state(path, eng):
            t0 = time.perf_counter()
            save(path, eng)
            self.snapshot_ms.append((time.perf_counter() - t0) * 1e3)

        S2FLEngine.run_round = run_round
        RoundDriver.run_round = driver_round
        S2FLEngine._multi_server_step = multi_step
        ck.save_run_state = save_run_state
        return self

    def __exit__(self, *exc):
        for obj, name, fn in self._saved:
            setattr(obj, name, fn)
        return False


FUSED_INT8 = ["--fused-comm", "--codec", "int8", "--error-feedback"]


def phase_train_fused_server(torch, tmp):
    """vgg16 at full width, fused int8 cohort path, without and then
    with ``--fused-server``: the multi-group server step must batch (more
    than 0 calls of 2+ groups), with clock, comm and the int8_roundtrip
    launches exactly those of the sequential server path and losses
    within 1e-3."""
    runs = {}
    for tag, extra in (("sequential", FUSED_INT8),
                       ("fused_server", [*FUSED_INT8, "--fused-server"])):
        reset_launches()
        with Capture() as cap:
            res = run_train([*VGG, "--device", "cuda", *extra], tmp,
                            f"fs_{tag}")
        runs[tag] = (res, cap, launches())
    (rs, cs, ls), (rf, cf, lf) = runs["sequential"], runs["fused_server"]
    if not cf.multi or min(cf.multi) < 2:
        fail(f"train_fused_server: no batched server call ({cf.multi})")
    if cs.multi:
        fail("train_fused_server: the sequential run batched")
    for k, a, b in (("clock", rs["clock"], rf["clock"]),
                    ("comm", rs["comm"], rf["comm"]),
                    ("int8_roundtrip", ls["int8_roundtrip"],
                     lf["int8_roundtrip"]),
                    ("splits", cs.splits, cf.splits)):
        if a != b:
            fail(f"train_fused_server: {k} {b} != sequential {a}")
    if lf["int8_roundtrip"] <= 0:
        fail("train_fused_server: int8_roundtrip never launched")
    dl = max(abs(a["loss"] - b["loss"])
             for a, b in zip(rs["history"], rf["history"]))
    if not dl <= LOSS_TOL:
        fail(f"train_fused_server: losses differ by {dl}")
    emit("train_fused_server", args=[*FUSED_INT8, "--fused-server"],
         batched_calls=len(cf.multi), groups_batched=sum(cf.multi),
         groups_per_call=cf.multi, clock=rf["clock"], comm=rf["comm"],
         int8_roundtrip=lf["int8_roundtrip"], max_loss_diff=dl,
         losses=[h["loss"] for h in rf["history"]],
         round_wall_s={"sequential": cs.round_s,
                       "fused_server": cf.round_s})


SERVICE = ["--rounds", "3", "--codec", "int8", "--error-feedback",
           "--fault-kill-prob", "0.25", "--checkpoint-every", "1",
           "--pipeline"]
INT8_PAIR = ("int8_quantize", "int8_dequantize")


def _params_of(path: Path) -> dict:
    import numpy as np
    with np.load(path) as z:
        return {k: z[k] for k in z.files if k.startswith("/params/")}


def phase_train_service(torch, tmp):
    """vgg16 at full width under churn with per-round snapshots, a trace
    and a metrics stream (``--pipeline``: flights need the phase
    timeline), 3 rounds straight twice, then resumed from the first
    run's round-1 snapshot for the other 2. History (losses aside),
    splits, clock, comm and the exactly-once ledger must be exactly
    equal; the resumed run's int8 launches those of the straight run's
    rounds 2-3; params bitwise equal if the two straight runs are, else
    no further from the first than the second is."""
    import numpy as np
    runs = {}
    for tag in ("straight_a", "straight_b", "resumed"):
        d = tmp / f"service_{tag}"
        d.mkdir()
        extra = ["--checkpoint-dir", str(d / "ck"),
                 "--trace-out", str(d / "trace.json"),
                 "--metrics-out", str(d / "metrics.jsonl")]
        if tag == "resumed":
            extra += ["--resume-from",
                      str(tmp / "service_straight_a/ck/round00001.npz")]
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.time()
        with Capture() as cap:
            res = run_train([*VGG, "--device", "cuda", *SERVICE, *extra],
                            tmp, f"service_{tag}")
        runs[tag] = dict(res=res, cap=cap, dir=d, wall_s=time.time() - t0,
                         launches=launches())
    a, b, c = runs["straight_a"], runs["straight_b"], runs["resumed"]

    def ledger(r):
        s = r["res"]["summary"]
        return (s["dispatched"], s["committed"], s["abandoned"])

    def hist(r):
        return [{k: v for k, v in h.items() if k != "loss"}
                for h in r["res"]["history"]]

    if ledger(a)[2] <= 0:
        fail(f"train_service: the fault plan abandoned nothing {ledger(a)}")
    for tag, r, splits in (("straight_b", b, a["cap"].splits),
                           ("resumed", c, a["cap"].splits[1:])):
        for k, x, y in (("clock", a["res"]["clock"], r["res"]["clock"]),
                        ("comm", a["res"]["comm"], r["res"]["comm"]),
                        ("ledger", ledger(a), ledger(r)),
                        ("history", hist(a), hist(r)),
                        ("splits", splits, r["cap"].splits)):
            if x != y:
                fail(f"train_service: {tag} {k} {y} != {x}")
    rounds_23 = {k: a["launches"][k] - a["cap"].after_round[0][k]
                 for k in INT8_PAIR}
    if {k: c["launches"][k] for k in INT8_PAIR} != rounds_23 \
            or min(rounds_23.values()) <= 0:
        fail(f"train_service: resumed launches {c['launches']} != "
             f"rounds 2-3 {rounds_23}")
    pa, pb, pc = (_params_of(r["dir"] / "ck" / "round00003.npz")
                  for r in (a, b, c))

    def max_diff(x, y):
        return max(float(np.abs(x[k].astype(np.float64)
                                - y[k].astype(np.float64)).max())
                   for k in x)

    straight_bitwise = all(np.array_equal(pa[k], pb[k]) for k in pa)
    resumed_bitwise = all(np.array_equal(pa[k], pc[k]) for k in pa)
    d_ab, d_ac = max_diff(pa, pb), max_diff(pa, pc)
    if straight_bitwise and not resumed_bitwise:
        fail(f"train_service: straight runs agree bitwise, the resumed "
             f"run differs by {d_ac}")
    if not d_ac <= d_ab:
        fail(f"train_service: resumed differs by {d_ac}, more than the "
             f"straight runs' {d_ab}")
    from repro_torch.observe import load_recorder
    flights = len(load_recorder(str(a["dir"] / "trace.json")).flights)
    if not flights:
        fail("train_service: the trace holds no flights")
    with open(a["dir"] / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    if len(records) != 3 + 1:
        fail(f"train_service: {len(records)} metrics records, want 4")
    emit("train_service", args=SERVICE, ledger=ledger(a),
         clock=a["res"]["clock"], comm=a["res"]["comm"],
         splits=a["cap"].splits,
         straight_runs_bitwise=straight_bitwise,
         resumed_bitwise=resumed_bitwise,
         max_param_diff={"straight": d_ab, "resumed": d_ac},
         int8_launches={t: {k: r["launches"][k] for k in INT8_PAIR}
                        for t, r in runs.items()},
         snapshot_ms={t: r["cap"].snapshot_ms for t, r in runs.items()},
         round_wall_s={t: r["cap"].round_s for t, r in runs.items()},
         run_wall_s={t: r["wall_s"] for t, r in runs.items()},
         trace_flights=flights,
         metrics_records=len(records))


CONTROL = ["--rounds", "6", "--exec-mode", "semi_async",
           "--resource-aware", "--scheduler", "joint", "--auto-knobs",
           "--fleet-size", "100000", "--clusters", "4",
           "--fault-kill-prob", "0.2"]


def phase_parity_control(tmp):
    """resnet8's golden config with int8 and the control plane, a fleet
    and churn, on the card and on the CPU: clock, comm, splits, the
    ledger and the knob controller's lock and rejections exactly equal,
    losses within 1e-3."""
    base = ["--arch", "resnet8", "--clients", "6", "--per-round", "4",
            "--batch-size", "16", "--n-train", "240", "--alpha", "0.3",
            "--eval-every", "1000", "--seed", "0", "--codec", "int8",
            *CONTROL]
    out = {}
    for dev in ("cuda", "cpu"):
        with Capture() as cap:
            res = run_train([*base, "--device", dev], tmp,
                            f"control_{dev}")
        kc = cap.engines[-1].driver.knob_controller
        s = res["summary"]
        out[dev] = dict(res=res, splits=cap.splits, locked=kc.locked,
                        rejected=list(kc.rejected),
                        ledger=(s["dispatched"], s["committed"],
                                s["abandoned"]))
    g, c = out["cuda"], out["cpu"]
    for k in ("splits", "locked", "rejected", "ledger"):
        if g[k] != c[k]:
            fail(f"parity_control: {k} card {g[k]} != cpu {c[k]}")
    for k in ("clock", "comm"):
        if g["res"][k] != c["res"][k]:
            fail(f"parity_control: {k} card {g['res'][k]} != cpu "
                 f"{c['res'][k]}")
    lg = [h["loss"] for h in g["res"]["history"]]
    lc = [h["loss"] for h in c["res"]["history"]]
    dl = max(abs(a - b) for a, b in zip(lg, lc)
             if not (math.isnan(a) and math.isnan(b)))
    if not dl <= LOSS_TOL:
        fail(f"parity_control: losses differ by {dl}: {lg} vs {lc}")
    emit("parity_control", args=CONTROL, clock=g["res"]["clock"],
         comm=g["res"]["comm"], splits=g["splits"], ledger=g["ledger"],
         locked={d: out[d]["locked"] for d in out},
         rejected={d: out[d]["rejected"] for d in out},
         losses_cuda=lg, losses_cpu=lc, max_loss_diff=dl)


# ------------------------------------------------- slices 2-3: the LM path
FA_CASES = [  # (B, S, H, K, D, Dv, causal, window): model layout (B,S,H,D)
    (4, 2048, 32, 32, 64, 64, True, 0),     # zamba2 shared attention
    (4, 2048, 16, 16, 192, 128, True, 0),   # deepseek MLA prefill
    (2, 1000, 16, 4, 64, 64, True, 256),    # GQA G = 4 with a window
    (1, 512, 8, 2, 120, 120, True, 0),      # h2o-danube's head dim
    (2, 384, 4, 4, 64, 64, False, 0),       # non-causal
    (2, 333, 4, 2, 80, 80, True, 0),        # S not a multiple of 64
    (1, 512, 4, 4, 256, 256, True, 0),      # the widest head dims
]
# bf16 that TMA cannot take runs the fp32-core kernel: (case, shift).
# shift: every tensor one element past a 16-byte boundary
FA_FP32_CASES = [
    ((4, 2048, 32, 32, 64, 64, True, 0), True),     # zamba2's shape
    ((4, 2048, 16, 16, 192, 128, True, 0), True),   # MLA's shape
    ((1, 300, 4, 2, 36, 36, True, 0), False),       # D % 8 != 0
    ((1, 300, 2, 1, 200, 164, True, 0), False),     # Dv % 8 != 0
]
SSD_CASES = [  # (b, s, h, p, n, chunk, initial state, bf16 path)
    (4, 2048, 64, 64, 64, 128, True, "wgmma"),   # zamba2 SSM layers, prefill
    (2, 1024, 8, 64, 128, 128, True, "wgmma"),   # mamba2's p, n
    # 128 chunks on 16 chains: blocks wait on the chunk before theirs
    (2, 8192, 8, 64, 64, 64, False, "wgmma"),
    (1, 192, 2, 24, 20, 64, True, "mma"),        # n, p % 8 != 0: no TMA
]
# (E, C, d, F, act, x dtype, weight dtype, input scales, path, shift).
# C is moe.py's capacity at factor 1.25, top-6 of 64 experts: 960 for a
# 4 x 2048 prefill, the floor of 8 for a 4-token decode step. shift: x
# one element past a 16-byte boundary (TMA refuses it).
GMM_CASES = {
    "prefill": (64, 960, 2048, 1408, "silu", "bfloat16", "bfloat16", "model",
                "wgmma", False),
    "decode": (64, 8, 2048, 1408, "silu", "bfloat16", "bfloat16", "model",
               "stream", False),
    "prefill_f32_weights": (64, 960, 2048, 1408, "silu", "bfloat16",
                            "float32", "model", "mma", False),
    "decode_shifted": (64, 8, 2048, 1408, "silu", "bfloat16", "bfloat16",
                       "model", "mma", True),
    "d_not_8": (8, 96, 2044, 1400, "silu", "bfloat16", "bfloat16", "model",
                "mma", False),
    # tests/test_kernels.py GMM_CASES, at its scales
    "ref_0": (4, 64, 128, 256, "silu", "float32", "float32", "ref", "f32",
              False),
    "ref_1": (2, 128, 64, 512, "gelu", "float32", "float32", "ref", "f32",
              False),
    "ref_2": (8, 32, 256, 128, "silu", "float32", "float32", "ref", "f32",
              False),
    "ref_3": (2, 64, 128, 256, "silu", "bfloat16", "bfloat16", "ref",
              "stream", False),
    "ref_4": (3, 40, 96, 192, "gelu", "float32", "float32", "ref", "f32",
              False),
}
# the stream / wgmma threshold sweep: C at E 64, d 2048, F 1408
GMM_SWEEP_C = (8, 16, 32, 64, 128, 256)


def fa_inputs(torch, case, dtype, gen, shift=False):
    B, S, H, K, D, Dv = case[:6]
    shapes = [(B, S, n, dd) for n, dd in ((H, D), (K, D), (K, Dv))]
    if not shift:
        return [torch.randn(*sh, generator=gen).to(dtype).cuda()
                for sh in shapes]
    return [torch.randn(math.prod(sh) + 1, generator=gen).to(dtype).cuda()
            [1:].view(*sh) for sh in shapes]


def ssd_inputs(torch, case, dtype, gen):
    """The reference kernel test's distributions: x, B, C normal, dt =
    softplus(normal), A = -exp(normal), initial state normal * 0.1."""
    import torch.nn.functional as F
    b, s, h, p, n = case[:5]

    def r(*shape):
        return torch.randn(*shape, generator=gen)
    x, B, C, init = r(b, s, h, p), r(b, s, n), r(b, s, n), r(b, h, p, n) * 0.1
    dt, A = F.softplus(r(b, s, h)), -torch.exp(r(h))
    return ([t.to(dtype).cuda() for t in (x,)] + [dt.cuda(), A.cuda()]
            + [t.to(dtype).cuda() for t in (B, C, init)])


def gmm_inputs(torch, case, gen):
    """"ref": the reference kernel test's scales (x * 0.5, w * 0.05).
    "model": unit-normal x (the RMS-normed hidden) and each weight
    scaled by 1/sqrt of its contracted dim, so g, u and y are O(1):
    |y| <= ~4 at the prefill shape, where a one-ulp difference of two
    bf16 roundings (2^-6 at [2, 4)) is inside the 2e-2 tolerance."""
    E, C, d, F, _, xdt, wdt, scale, _, shift = case
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    sx, sg, sd = ((0.5, 0.05, 0.05) if scale == "ref"
                  else (1.0, d ** -0.5, F ** -0.5))

    def r(shape, sc, dt):
        return (torch.randn(*shape, generator=gen) * sc).to(dts[dt]).cuda()
    x = r((E, C, d), sx, xdt)
    if shift:
        x = torch.cat([x.new_zeros(1), x.reshape(-1)])[1:].view(E, C, d)
    return (x, r((E, d, F), sg, wdt), r((E, d, F), sg, wdt),
            r((E, F, d), sd, wdt))


def kept_pairs(S: int, T: int, causal: bool, window: int) -> int:
    """(q, k) pairs the mask keeps, per head."""
    total = 0
    for i in range(S):
        hi = min(T - 1, i) if causal else T - 1
        lo = max(0, i - window + 1) if window else 0
        total += max(0, hi - lo + 1)
    return total


def timed_row(kern, plain, lib, shape, bnd, n_ops, err, iters=5):
    """Cold device time of the kernel and of the plain version in turns
    (plain, kernel, kernel, plain; the better of each pair), warm time,
    the library yardstick's cold time, and one call on the host's clock.
    -> (row of the kernels line, extra readings)."""
    p1, k1, k2, p2 = (device_ms(plain, True, iters),
                      device_ms(kern, True, iters),
                      device_ms(kern, True, iters),
                      device_ms(plain, True, iters))
    warm_k = device_ms(kern, False, iters)
    lib_ms = None
    if lib is not None:
        lib_ms = min(device_ms(lib, True, iters), device_ms(lib, True, iters))
    c_k = time_ms(kern, iters=10, warmup=2)
    ms = min(k1, k2)
    row = {"shape": shape, "ms": ms, "plain_ms": min(p1, p2),
           "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": lib_ms,
           "max_abs_err": err}
    extra = {"device_ms_runs": [k1, k2], "plain_device_ms_runs": [p1, p2],
             "warm_l2_ms": warm_k, "call_ms": c_k, "ops": n_ops,
             "achieved_tflops": n_ops / (ms * 1e-3) / 1e12}
    return row, extra


def flash_paths() -> dict:
    """Flash launches so far, by kernel path."""
    from repro_torch.kernels.flash_attention import kernel as fa
    return {p: fa.LAUNCHES[f"flash_attention_{p}"] for p in fa.PATHS}


def gmm_paths() -> dict:
    """moe_gmm launches so far, by kernel path."""
    from repro_torch.kernels.moe_gmm import kernel as gmm
    return {p: gmm.LAUNCHES[f"moe_gmm_{p}"] for p in gmm.PATHS}


def ssd_paths() -> dict:
    """SSD scan launches so far, by kernel path."""
    from repro_torch.kernels.ssd_scan import kernel as ss
    return {p: ss.LAUNCHES[f"ssd_scan_{p}"] for p in ss.PATHS}


def path_taken(paths, before: dict) -> str:
    """The one path of ``paths()`` launched since ``before``."""
    now = paths()
    moved = [p for p in now if now[p] != before[p]]
    if len(moved) != 1 or now[moved[0]] != before[moved[0]] + 1:
        fail(f"{paths.__name__}: expected one launch, got {before} -> "
             f"{now}")
    return moved[0]


def check_lm_kernels(torch, gen):
    """Every LM kernel case against its plain version; -> worst abs
    error by kernel."""
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.moe_gmm import kernel as gmm
    from repro_torch.kernels.ssd_scan import kernel as ss
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    worst = {"flash_attention": 0.0, "ssd_scan": 0.0, "moe_gmm": 0.0}
    runs = ([(case, name, False) for case in FA_CASES for name in dtypes]
            + [(case, "bfloat16", shift) for case, shift in FA_FP32_CASES])
    for case, name, shift in runs:
        causal, window, dt = case[6], case[7], dtypes[name]
        q, k, v = fa_inputs(torch, case, dt, gen, shift)
        before = flash_paths()
        out = fa_ops.flash_attention(q, k, v, window=window,
                                     causal=causal)
        torch.cuda.synchronize()
        path = path_taken(flash_paths, before)
        want = ("wgmma" if name == "bfloat16" and not shift
                and case[4] % 8 == 0 and case[5] % 8 == 0 else "fp32")
        if path != want:
            fail(f"flash_attention {case} {name} shift={shift}: ran "
                 f"the {path} path, want {want}")
        ref = fa.attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), causal=causal,
                                 window=window).transpose(1, 2)
        err = float((out.float() - ref.float()).abs().max())
        ex = excess(out, ref, *FA_TOL[name])
        emit("lm_kernel_check", name="flash_attention", case=case,
             dtype=name, shift=shift, path=path, max_abs_err=err,
             tol=FA_TOL[name])
        if not ex <= 0:
            fail(f"flash_attention {case} {name}: max abs err {err} "
                 f"over {FA_TOL[name]}")
        worst["flash_attention"] = max(worst["flash_attention"], err)
        del q, k, v, out, ref
    for case in SSD_CASES:
        chunk, with_init = case[5], case[6]
        for name, dt in dtypes.items():
            x, dtt, A, B, C, init = ssd_inputs(torch, case, dt, gen)
            init = init if with_init else None
            before = ssd_paths()
            y, f = ss.ssd_scan(x, dtt, A, B, C, chunk=chunk,
                               initial_state=init)
            torch.cuda.synchronize()
            path = path_taken(ssd_paths, before)
            want = "f32" if name == "float32" else case[7]
            if path != want:
                fail(f"ssd_scan {case} {name}: ran the {path} path, want "
                     f"{want}")
            yp, fp = ss.ssd_scan_plain(x, dtt, A, B, C, chunk=chunk,
                                       initial_state=init)
            err = max(float((y.float() - yp.float()).abs().max()),
                      float((f.float() - fp.float()).abs().max()))
            ex = max(excess(y, yp, *SSD_TOL[name]),
                     excess(f, fp, *SSD_TOL[name]))
            emit("lm_kernel_check", name="ssd_scan", case=case, dtype=name,
                 path=path, max_abs_err=err, excess_over_tol=ex,
                 tol=SSD_TOL[name])
            if not ex <= 0:
                fail(f"ssd_scan {case} {name}: outside {SSD_TOL[name]} "
                     f"by {ex} (max abs err {err})")
            worst["ssd_scan"] = max(worst["ssd_scan"], err)
    for label, case in GMM_CASES.items():
        x, wg, wu, wd = gmm_inputs(torch, case, gen)
        before = gmm_paths()
        y = gmm.moe_gmm(x, wg, wu, wd, act=case[4])
        torch.cuda.synchronize()
        path = path_taken(gmm_paths, before)
        if path != case[8]:
            fail(f"moe_gmm {label}: ran the {path} path, want {case[8]}")
        yp = gmm.moe_gmm_plain(x, wg, wu, wd, act=case[4])
        err = float((y.float() - yp.float()).abs().max())
        tol = GMM_TOL[case[5]]
        emit("lm_kernel_check", name="moe_gmm", case=label, shape=case[:4],
             act=case[4], x_dtype=case[5], w_dtype=case[6], path=path,
             shift=case[9], max_abs_err=err, tol=tol,
             y_abs_max=float(yp.abs().max()))
        if not (err <= tol and y.dtype == x.dtype):
            fail(f"moe_gmm {label} {case}: max abs err {err} over {tol}")
        worst["moe_gmm"] = max(worst["moe_gmm"], err)
        del x, wg, wu, wd, y, yp
    torch.cuda.empty_cache()
    return worst


def phase_lm_kernels(torch):
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.moe_gmm import kernel as gmm
    from repro_torch.kernels.ssd_scan import kernel as ss
    gen = torch.Generator().manual_seed(1)
    worst = check_lm_kernels(torch, gen)

    # times at the serving shapes, in the dtypes the serve phases run
    def flash_row(case, dt, lib=True):
        B, S, H, K, D, Dv, causal, window = case
        q, k, v = fa_inputs(torch, case, dt, gen)
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        qc, kc, vc = (t.contiguous() for t in (qh, kh, vh))
        size = q.element_size()
        n_bytes = (q.numel() + k.numel() + v.numel()
                   + B * S * H * Dv) * size       # q, k, v in, o out
        n_ops = 2 * B * H * (D + Dv) * kept_pairs(S, S, causal, window)
        rate = BF16_OPS_PER_S if dt == torch.bfloat16 else FP32_OPS_PER_S

        def kern():
            return fa_ops.flash_attention(q, k, v, window=window,
                                          causal=causal)
        before = flash_paths()
        kern()
        torch.cuda.synchronize()
        path = path_taken(flash_paths, before)
        row, extra = timed_row(
            kern,
            lambda: fa.attention_plain(qh, kh, vh, causal=causal,
                                       window=window),
            (lambda: F.scaled_dot_product_attention(qc, kc, vc,
                                                    is_causal=True))
            if lib else None,
            [B * H, S, D, Dv], bound(n_bytes, n_ops, rate), n_ops,
            worst["flash_attention"])
        extra["path"] = path
        if row["library_ms"]:
            extra["sdpa_tflops"] = n_ops / (row["library_ms"] * 1e-3) / 1e12
        return row, extra

    def gmm_row(label):
        E, C, d, Fd, act, xdt, wdt, _, want, _ = case = GMM_CASES[label]
        x, wg, wu, wd = gmm_inputs(torch, case, gen)
        n_bytes = (2 * x.numel() * x.element_size()
                   + 3 * wg.numel() * wg.element_size())
        n_ops = 6 * E * C * d * Fd
        rate = BF16_OPS_PER_S if xdt == "bfloat16" else FP32_OPS_PER_S
        row, extra = timed_row(
            lambda: gmm.moe_gmm(x, wg, wu, wd, act=act),
            lambda: gmm.moe_gmm_plain(x, wg, wu, wd, act=act), None,
            list(case[:4]) + [xdt, wdt], bound(n_bytes, n_ops, rate), n_ops,
            worst["moe_gmm"])
        extra["path"] = want
        if label in ("prefill", "decode"):
            # yardstick only: three bf16 torch.bmm of the same shapes
            # (cuBLAS), no activation; the port never calls it
            h = torch.empty((E, C, Fd), dtype=x.dtype, device=x.device)
            extra["bmm3_bf16_ms"] = min(device_ms(
                lambda: (torch.bmm(x, wg), torch.bmm(x, wu),
                         torch.bmm(h, wd)), True, 5) for _ in range(2))
        return row, extra

    def gmm_sweep():
        """Cold device time of the stream and wgmma pairs at each C of
        GMM_SWEEP_C, in turns (stream, wgmma, wgmma, stream; the better
        of each pair); the stream kernel takes C up to 64."""
        E, _, d, Fd = GMM_CASES["decode"][:4]
        w = gmm_inputs(torch, (E, 1) + GMM_CASES["decode"][2:], gen)[1:]
        rows = []
        for C in GMM_SWEEP_C:
            x = (torch.randn(E, C, d, generator=gen)
                 .to(torch.bfloat16).cuda())
            runs = {p: (lambda p=p: gmm._launch(x, *w, "silu", p))
                    for p in ("stream", "wgmma")
                    if p == "wgmma" or C <= 64}
            order = list(runs) + list(runs)[::-1]
            ms = {p: [] for p in runs}
            for p in order:
                ms[p].append(device_ms(runs[p], True, 5))
            rows.append({"C": C, **{f"{p}_ms": min(v) for p, v in ms.items()},
                         "chosen": gmm._path(x.dtype, w[0].dtype, C, d, Fd,
                                             True)})
        return {"shape": [E, "C", d, Fd], "stream_max_c": gmm.STREAM_MAX_C,
                "rows": rows}

    sc = SSD_CASES[0]
    x, dtt, A, Bm, Cm, init = ssd_inputs(torch, sc, torch.bfloat16, gen)
    b_, s_, h_, p_, n_, l_ = sc[:6]
    nc = s_ // l_
    ssd_bytes = (2 * x.numel() * 2 + dtt.numel() * 4 + A.numel() * 4
                 + 2 * Bm.numel() * 2 + 2 * init.numel() * 2)
    ssd_ops_n = (b_ * nc * 2 * l_ * l_ * n_
                 + b_ * h_ * nc * (2 * (l_ * (l_ + 1) // 2) * p_
                                   + 2 * l_ * n_ * p_ + 2 * l_ * p_ * n_))
    def ssd_row():
        def kern():
            return ss.ssd_scan(x, dtt, A, Bm, Cm, chunk=l_,
                               initial_state=init)
        before = ssd_paths()
        kern()
        torch.cuda.synchronize()
        path = path_taken(ssd_paths, before)
        if path != sc[7]:
            fail(f"ssd_scan row: ran the {path} path, want {sc[7]}")
        row, extra = timed_row(
            kern,
            lambda: ss.ssd_scan_plain(x, dtt, A, Bm, Cm, chunk=l_,
                                      initial_state=init),
            None, list(sc[:6]), bound(ssd_bytes, ssd_ops_n, BF16_OPS_PER_S),
            ssd_ops_n, worst["ssd_scan"])
        extra["path"] = path
        words = ss.lookback_scratch(b_, h_, p_, n_)
        extra["scratch_bytes"] = 8 * words
        # the wrapper zeroes the scratch with torch.zeros, a fill kernel
        # of its own that the row's ms includes: its cold time alone, and
        # every kernel of one call with its device µs (profiler)
        extra["scratch_fill_ms"] = min(device_ms(
            lambda: torch.zeros(words, dtype=torch.int64, device="cuda"),
            True, 5) for _ in range(2))
        extra["one_call_kernels_us"] = _profile(kern, 1)
        return row, extra

    makers = {
        "flash_attention": lambda: flash_row(FA_CASES[0], torch.bfloat16),
        "flash_attention_mla": lambda: flash_row(FA_CASES[1],
                                                 torch.bfloat16),
        "flash_attention_mla_f32": lambda: flash_row(
            FA_CASES[1], torch.float32, lib=False),
        "ssd_scan": ssd_row,
    }
    # every moe_gmm case; at the reference's small shapes the time is
    # mostly launch overhead
    makers.update({"moe_gmm" if k == "prefill" else f"moe_gmm_{k}":
                   (lambda k=k: gmm_row(k)) for k in GMM_CASES})
    timed = {}
    for name, make in makers.items():
        row, extra = make()
        timed[name] = row
        emit("kernel", name=name, **row, **extra)
        torch.cuda.empty_cache()
    emit("moe_gmm_threshold_sweep", **gmm_sweep())
    torch.cuda.empty_cache()
    return timed


ZAMBA = "zamba2-1.2b"
DEEPSEEK = "deepseek-v2-lite-16b"
GROUPS = (("flash_attention", ("flash_fwd",)), ("ssd_scan", ("ssd_scan",)),
          ("moe_gmm", ("::gmm_",)),
          ("gemm", ("gemm", "cutlass", "xmma", "nvjet")))
# PyTorch's fill kernel for int64 (torch.zeros of the SSD look-back
# scratch)
INT64_FILL = "FillFunctor<long>"


def _device_times(torch, fn, counts: dict | None = None) -> dict:
    """{kernel name: device µs} of one call of fn (``counts``: as in
    _profile). The profiler now and then reports nothing for a session:
    up to three sessions."""
    times = {}
    for _ in range(3):
        with torch.no_grad():
            times = _profile(fn, 1, counts)
        if times:
            break
    return times


def _by_group(times: dict) -> dict:
    """{group: device ms} of a {kernel name: device µs}."""
    groups = {g: 0.0 for g, _ in GROUPS}
    groups["elementwise_and_copies"] = 0.0
    for name, us in times.items():
        low = name.lower()
        group = next((g for g, keys in GROUPS
                      if any(k in low for k in keys)),
                     "elementwise_and_copies")
        groups[group] += us / 1e3
    return groups


def prefill_breakdown(times: dict, counts: dict, wall_s: float,
                      ssd_launches: int) -> dict:
    """Device time of one prefill by kernel group (``times`` and
    ``counts``, from _device_times), beside the host-clock time of a
    prefill; ``kernels_seen`` says whether a profiler session reported.
    The SSD scan's scratch is zeroed by PyTorch's int64 fill kernel,
    which the name groups count as elementwise: the int64 fills are
    given apart, and where there are as many as the prefill's SSD
    launches (``ssd_launches``), they are the scan's and are added to
    its group in ``ssd_scan_with_fill_ms``."""
    groups = _by_group(times)
    busy_ms = sum(groups.values())
    top = sorted(times.items(), key=lambda kv: -kv[1])[:8]
    fills = [k for k in times if INT64_FILL in k]
    fill = {"launches": sum(counts.get(k, 0) for k in fills),
            "ms": sum(times[k] for k in fills) / 1e3}
    with_fill = (groups["ssd_scan"] + fill["ms"]
                 if ssd_launches and fill["launches"] == ssd_launches
                 else None)
    return {"device_ms_by_group": groups, "device_busy_ms": busy_ms,
            "int64_fills": fill, "ssd_scan_with_fill_ms": with_fill,
            "kernels_seen": len(times), "wall_ms": wall_s * 1e3,
            "idle_share": max(0.0, 1.0 - busy_ms / (wall_s * 1e3)),
            "top_kernels_ms": [[k[:80], v / 1e3] for k, v in top]}


def decode_breakdown(torch, generate_fn, prefill_times: dict,
                     prefill_s: float, generate_s: float,
                     steps: int) -> dict:
    """Device time of the decode steps of one generate by kernel group:
    a profiled generate less the profiled prefill, group by group;
    beside it the decode's host-clock time (a generate less a prefill)
    and the share of it the card was idle."""
    gen_times = _device_times(torch, generate_fn)
    gen_groups = _by_group(gen_times)
    pre_groups = _by_group(prefill_times)
    groups = {g: gen_groups[g] - pre_groups[g] for g in gen_groups}
    busy_ms = sum(groups.values())
    wall_ms = (generate_s - prefill_s) * 1e3
    return {"device_ms_by_group": groups, "device_busy_ms": busy_ms,
            "device_ms_per_step": busy_ms / steps, "wall_ms": wall_ms,
            "idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
            "steps": steps, "kernels_seen": len(gen_times),
            "prefill_kernels_seen": len(prefill_times)}


def serve_full(torch, dev, cfg, tag, per_prefill, per_generate,
               draw_on_device=False):
    """One full-width config through generate(): batch 4, prompt 2048,
    32 greedy tokens. The launches of one prefill and of the whole
    generate are counted (each from 0) and must equal ``per_prefill`` /
    ``per_generate``; then a timed prefill and a second generate, which
    must repeat the first's tokens. -> the generate's launch counts."""
    from repro_torch.launch.serve import generate
    from repro_torch.models import SplitModel
    from repro_torch.models import transformer as tf
    batch, prompt, steps = 4, 2048, 32
    t0 = time.time()
    params = SplitModel(cfg).init(0, device=dev,
                                  draw_on_device=draw_on_device)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    gen = torch.Generator().manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt),
                           generator=gen).to(dev)
    torch.cuda.reset_peak_memory_stats()

    def counted(fn):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        return out, launches(), time.time() - t0

    with torch.no_grad():
        _, pre_counts, _ = counted(
            lambda: tf.prefill(cfg, params, tokens, prompt + steps))
    out, counts, first_s = counted(
        lambda: generate(cfg, params, tokens, steps=steps))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if tuple(out.shape) != (batch, steps):
        fail(f"{tag}: generated shape {tuple(out.shape)}")
    if not bool(((out >= 0) & (out < cfg.vocab_size)).all()):
        fail(f"{tag}: generated tokens outside the vocabulary")
    for name, want in per_prefill.items():
        if pre_counts[name] != want:
            fail(f"{tag}: one prefill must launch {name} {want} times, "
                 f"got {pre_counts}")
    for name, want in per_generate.items():
        if counts[name] != want:
            fail(f"{tag}: generate must launch {name} {want} times, got "
                 f"{counts}")

    # second reading, outside the counted runs: prefill alone, then the
    # whole generate again; decode time = their difference
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.time()
        logits, _, _ = tf.prefill(cfg, params, tokens, prompt + steps)
        torch.cuda.synchronize()
        prefill_s = time.time() - t0
        t0 = time.time()
        out2 = generate(cfg, params, tokens, steps=steps)
        torch.cuda.synchronize()
        gen_s = time.time() - t0
    if not bool(torch.isfinite(logits.float()).all()):
        fail(f"{tag}: non-finite prefill logits")
    del logits
    pre_fn = lambda: tf.prefill(cfg, params, tokens, prompt + steps)
    pre_kernel_counts = {}
    pre_times = _device_times(torch, pre_fn, pre_kernel_counts)
    breakdown = prefill_breakdown(pre_times, pre_kernel_counts, prefill_s,
                                  pre_counts.get("ssd_scan_wgmma", 0))
    decode = decode_breakdown(
        torch, lambda: generate(cfg, params, tokens, steps=steps),
        pre_times, prefill_s, gen_s, steps)
    if not torch.equal(out, out2):
        fail(f"{tag}: two greedy runs of the same prompt differ")
    decode_s = gen_s - prefill_s
    emit(tag, arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
         vocab=cfg.vocab_size, dtype=cfg.dtype, param_dtype=cfg.param_dtype,
         attn_impl=cfg.attn_impl, batch=batch, prompt=prompt, gen=steps,
         launches_prefill=pre_counts, launches=counts, init_s=init_s,
         first_generate_s=first_s, prefill_s=prefill_s, generate_s=gen_s,
         decode_s=decode_s, decode_tok_per_s=batch * steps / decode_s,
         prefill_tok_per_s=batch * prompt / prefill_s,
         peak_mem_gb=peak_gb, sample=out[0, :8].tolist())
    emit(f"{tag}_prefill_profile", **breakdown)
    emit(f"{tag}_decode_profile", **decode)
    del params
    torch.cuda.empty_cache()
    return counts


def phase_serve(torch, dev):
    """zamba2-1.2b at full width, bf16 activations, f32 params."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(ZAMBA), attn_impl="pallas")
    if not (cfg.n_layers == 38 and cfg.d_model == 2048
            and cfg.vocab_size == 32000 and cfg.dtype == "bfloat16"):
        fail(f"serve: {ZAMBA} is not the full-width config: {cfg}")
    want = {"flash_attention": 6, "flash_attention_wgmma": 6, "ssd_scan": 32,
            "ssd_scan_wgmma": 32}
    return serve_full(torch, dev, cfg, "serve", want, want)


def phase_serve_moe(torch, dev):
    """deepseek-v2-lite-16b at full width, bf16 activations and params;
    the weights are drawn on the card (15.7 B values)."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(DEEPSEEK), attn_impl="pallas",
                              param_dtype="bfloat16")
    n_moe = sum(f == "moe" for _, f in cfg.pattern())
    if not (cfg.n_layers == 27 and n_moe == 26 and cfg.d_model == 2048
            and cfg.n_experts == 64 and cfg.top_k == 6 and cfg.mla
            and cfg.vocab_size == 102400 and cfg.dtype == "bfloat16"):
        fail(f"serve_moe: {DEEPSEEK} is not the full-width config: {cfg}")
    steps = 32
    flash = {"flash_attention": cfg.n_layers,
             "flash_attention_wgmma": cfg.n_layers}
    prefill = {"moe_gmm": n_moe, "moe_gmm_wgmma": n_moe}
    return serve_full(
        torch, dev, cfg, "serve_moe", {**prefill, **flash},
        {"moe_gmm": n_moe * (1 + steps), "moe_gmm_wgmma": n_moe,
         "moe_gmm_stream": n_moe * steps, **flash}, draw_on_device=True)


def serve_parity(torch, dev, cfg, tag, batch=2, prompt=200, steps=8):
    """Card vs CPU on a reduced config in float32: prefill and decode
    logits, both sides stepped with the CPU's greedy tokens."""
    from repro_torch.models import SplitModel
    from repro_torch.models import transformer as tf
    from repro_torch.utils.tree import tree_map
    p_cpu = SplitModel(cfg).init(0, device="cpu")
    p_gpu = tree_map(lambda t: t.to(dev), p_cpu)
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt),
                           generator=torch.Generator().manual_seed(3))
    reset_launches()
    with torch.no_grad():
        lc, cc, n = tf.prefill(cfg, p_cpu, tokens, prompt + steps)
        lg, cg, _ = tf.prefill(cfg, p_gpu, tokens.to(dev), prompt + steps)
        worst = float((lg.cpu() - lc).abs().max())
        for t in range(steps):
            tok = torch.argmax(lc[:, -1, :cfg.vocab_size], -1)[:, None]
            lc, cc = tf.decode_step(cfg, p_cpu, tok, cc, n + t)
            lg, cg = tf.decode_step(cfg, p_gpu, tok.to(dev), cg, n + t)
            worst = max(worst, float((lg.cpu() - lc).abs().max()))
    emit(tag, arch=cfg.name, n_layers=cfg.n_layers,
         pattern=[list(k) for k in cfg.pattern()], batch=batch,
         prompt=prompt, steps=steps, max_abs_logit_diff=worst,
         tol=SERVE_TOL, logit_scale=float(lc.abs().max()),
         card_launches={k: v for k, v in launches().items() if v})
    if not worst <= SERVE_TOL:
        fail(f"{tag}: card vs CPU logits differ by {worst}")


def phase_serve_parity(torch, dev):
    """Reduced zamba2 (both block kinds)."""
    import dataclasses
    from repro_torch.configs import get_config, make_reduced
    cfg = dataclasses.replace(make_reduced(get_config(ZAMBA), n_layers=6),
                              attn_impl="pallas")
    if cfg.dtype != "float32" or {m for m, _ in cfg.pattern()} != {
            "ssm", "shared_attn"}:
        fail(f"serve_parity: unexpected reduced config {cfg.pattern()}")
    serve_parity(torch, dev, cfg, "serve_parity")


def phase_serve_moe_parity(torch, dev):
    """Reduced deepseek: MLA in both layers, a dense and an MoE FFN."""
    import dataclasses
    from repro_torch.configs import get_config, make_reduced
    cfg = dataclasses.replace(make_reduced(get_config(DEEPSEEK)),
                              attn_impl="pallas")
    if (cfg.dtype != "float32" or not cfg.mla
            or {f for _, f in cfg.pattern()} != {"dense", "moe"}):
        fail(f"serve_moe_parity: unexpected reduced config {cfg}")
    serve_parity(torch, dev, cfg, "serve_moe_parity")


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
    phase_int8_legs(torch, dev)
    with tempfile.TemporaryDirectory() as d:
        tmp = Path(d)
        # 16 model legs (8 client-rounds, a dispatch and a collect
        # each) and 16 feature transfers: one launch a direction each
        int8_args = ["--codec", "int8", "--dispatch-codec", "int8",
                     "--error-feedback"]
        seq = phase_train(torch, tmp, "train_int8", int8_args,
                          ["int8_quantize", "int8_dequantize"],
                          {"int8_quantize": 32, "int8_dequantize": 32,
                           "clock": 5.61946362688, "comm": 14229056.0})
        phase_train_profile(torch, tmp, int8_args)
        f_int8 = phase_train(torch, tmp, "fused_int8",
                             ["--fused-comm", "--codec", "int8",
                              "--error-feedback"], ["int8_roundtrip"])
        f_topk = phase_train(torch, tmp, "fused_topk",
                             ["--fused-comm", "--codec", "topk",
                              "--error-feedback"], ["sparse_combine"])
        phase_parity(tmp)
        phase_train_fused_server(torch, tmp)
        phase_train_service(torch, tmp)
        phase_parity_control(tmp)
    timed.update(phase_lm_kernels(torch))
    served = phase_serve(torch, dev)
    phase_serve_parity(torch, dev)
    served_moe = phase_serve_moe(torch, dev)
    phase_serve_moe_parity(torch, dev)

    flash_by_serve = {"serve": served["flash_attention"],
                      "serve_moe": served_moe["flash_attention"]}
    main_path = {"int8_quantize": seq["int8_quantize"],
                 "int8_dequantize": seq["int8_dequantize"],
                 "int8_roundtrip": f_int8["int8_roundtrip"],
                 "sparse_combine": f_topk["sparse_combine"],
                 "flash_attention": sum(flash_by_serve.values()),
                 "ssd_scan": served["ssd_scan"],
                 "moe_gmm": served_moe["moe_gmm"]}
    replaces = {
        "int8_quantize": "src/repro/kernels/int8_quant/kernel.py:48",
        "int8_dequantize": "src/repro/kernels/int8_quant/kernel.py:80",
        "int8_roundtrip": "src/repro/kernels/comm_fused/kernel.py:49",
        "sparse_combine": "src/repro/kernels/comm_fused/kernel.py:82",
        "flash_attention": "src/repro/kernels/flash_attention/kernel.py:97",
        "ssd_scan": "src/repro/kernels/ssd_scan/kernel.py:75",
        "moe_gmm": "src/repro/kernels/moe_gmm/kernel.py:61",
    }
    source = {"int8_quantize": "src/repro_torch/csrc/int8_quant.cu",
              "int8_dequantize": "src/repro_torch/csrc/int8_quant.cu",
              "int8_roundtrip": "src/repro_torch/csrc/comm_fused.cu",
              "sparse_combine": "src/repro_torch/csrc/comm_fused.cu",
              "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
              "ssd_scan": "src/repro_torch/csrc/ssd_scan.cu",
              "moe_gmm": "src/repro_torch/csrc/moe_gmm.cu"}
    # a kernel timed at more than one main-path shape: the first is the
    # row's own, the others ride along
    by_kernel_path = {p: served[f"flash_attention_{p}"]
                      + served_moe[f"flash_attention_{p}"]
                      for p in ("wgmma", "fp32")}
    also = {"flash_attention": {"launches_by_path": flash_by_serve,
                                "launches_by_kernel_path": by_kernel_path,
                                "mla": timed["flash_attention_mla"]},
            "moe_gmm": {"launches_by_path": {
                p: served_moe[f"moe_gmm_{p}"] for p in gmm_paths()},
                "decode": timed["moe_gmm_decode"]},
            "ssd_scan": {"launches_by_path": {
                p: served[f"ssd_scan_{p}"] for p in ssd_paths()}}}
    for k in ("int8_quantize", "int8_dequantize"):
        also[k] = {key: v for key, v in timed[k].items()
                   if key.startswith(("leg_", "features_", "launch_floor",
                                      "warm_l2"))}
    kernels = [{"name": k, "route": "cuda", "source": source[k],
                "replaces": replaces[k],
                "launches": main_path[k],
                "max_abs_err": timed[k]["max_abs_err"],
                "ms": timed[k]["ms"], "plain_ms": timed[k]["plain_ms"],
                "bound_ms": timed[k]["bound_ms"],
                "bound_by": timed[k]["bound_by"],
                "library_ms": timed[k]["library_ms"],
                "shape": timed[k]["shape"], **also.get(k, {})}
               for k in replaces]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
