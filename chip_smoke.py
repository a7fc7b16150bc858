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
            views off 16 bytes), other float outputs within 1e-6; at
            the LM training path's shapes (int8_lm_shapes): a bf16
            internlm2-1.8b feature tensor (32 x 64 x 2048, 16384 rows of
            256) through the list API to bf16 and back, bit-equal, and a
            4-client cohort of them (65536 rows) through int8_roundtrip.
            Device time per call of the kernel and of the plain version
            (CUDA events around a run of calls that a spin kernel lets
            the host queue in full) with the L2 flushed before each call
            and warm, the time per call as the host sees it (CUDA events
            around one call on an idle card), and the bound; the int8
            pair at vgg16's model legs and feature transfers and at
            internlm2-1.8b's, beside the time of an empty kernel (the
            launch floor); int8_roundtrip at vgg16's cohort and at
            internlm2-1.8b's.
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
5d. train_lm  internlm2-1.8b at full width (24 layers, d_model 2048,
            vocab 92544, 1.889 B f32 params, bf16 activations, split
            points 3, 6, 12) through ``repro_torch.launch.train``: 2
            rounds of 4 of 8 clients, batch 32, seq 64, int8 with error
            feedback on the feature legs (fp32 model legs): exactly 16
            quantize and 16 dequantize launches, no other kernel of the
            port, finite losses, clock 3186.34285896672 and comm
            30319706176.0; host wall a round, peak memory, the
            evaluation's loss.
   train_lm_profile  round 2 of that run under the profiler: device ms
            by kernel group, idle share.
   train_lm_fused  the same run with ``--fused-comm``: exactly 4
            int8_roundtrip launches and none of the int8 pair, clock and
            comm equal train_lm's, losses within 1e-3 of them.
5e. parity_lm  reduced internlm2 (int8 on every leg, EF), zamba2 (the
            shared attention block; fused top-k cohort path: the
            sparse-combine kernel must launch) and deepseek (MoE + MLA;
            ``--fused-server``, which must batch), card vs CPU: clock,
            comm and splits exactly equal, losses within 1e-3.
5f. lm_grad_refusal  the flash wrapper, given CUDA tensors that require
            a gradient, must raise before it launches (the kernels have
            no backward; training runs ``attn_impl="xla"``).
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
            (stream) shapes in bf16 and with bf16 x and f32 weights, d
            not a multiple of 8, and x off a 16-byte boundary at the
            decode shape (mma), and the reference's five kernel-test
            cases, gelu and non-128 shapes included),
            then cold / warm device time, plain time, bound and, for
            flash, the path, the achieved TFLOP/s and the time of
            PyTorch's SDPA at both serving shapes (a yardstick only; the
            port never calls it); for ssd, the path, the look-back
            scratch's bytes, the device time of the fill kernel that
            zeroes it and the kernels one call runs; for moe_gmm at both
            serving shapes, three bf16 ``torch.bmm`` of the same shapes
            (a yardstick only); with f32 weights, the mma pair they took
            before, timed on the same inputs right after, both pairs'
            worst error, and three f32 ``torch.bmm`` with x upcast (a
            yardstick only); and the stream / wgmma threshold sweep: both
            paths' cold time at C 8 to 256 (E 64, d 2048, F 1408), with
            bf16 and with f32 weights.
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
            d_model 2048, vocab 102400) with bf16 params (the one cut;
            9b serves its own f32 params) and attn_impl="pallas",
            through ``generate``: batch 4, prompt 2048, 32 greedy tokens.
            One prefill must launch moe_gmm exactly 26 times and flash 27
            times, all on their wgmma paths, the whole generate moe_gmm
            858 times (26 per prefill and per decode step): 26 on wgmma
            and the 832 of the decode steps on stream. Prints init
            seconds, prefill seconds, decode tokens/s, peak memory, a
            prefill profile and a decode profile (device ms by kernel
            group over the decode steps of one generate, with the idle
            share).
9b. serve_moe_f32  deepseek-v2-lite-16b at full width at its configured
            dtypes: bf16 activations and f32 params (62.8 GB, drawn on
            the card after asserting it holds under 1 GB), batch 4,
            prompt 2048, 32 greedy tokens through ``generate``. One
            prefill must launch moe_gmm 26 times and flash 27, all on
            their wgmma paths; the generate moe_gmm 26 + 832 times, the
            decode steps' on the path ``_path`` picks at C 8. Prints as
            serve_moe does.
10. serve_moe_parity  reduced deepseek (a dense and an MoE layer, MLA),
            card vs CPU, both sides stepped with the CPU's greedy
            tokens: in float32, prefill and decode logits within 1e-4;
            then with bf16 activations and f32 params, within 2e-2 of
            the largest |logit|, its prefill's moe_gmm (C 250) on the
            wgmma pair and its decode steps' (C 8) on the stream pair.
11. spmd_train  a process group of one rank (NCCL, a file store) and a
            1 x 1 DeviceMesh; internlm2-1.8b at full width through
            ``repro_torch.launch.steps.build_train_step`` at train_4k's
            seq 4096, batch 8 (the one cut: the global batch is 256), 4
            groups, split 12, lr 0.01, remat forced by the builder: two
            steps. Step 1 equals the host-path step (``dp_axes=None``)
            bit for bit or within 1e-6 relative, and a hand-written loop
            over the groups within 1e-4; the first loss is near
            ln(92544). Step wall, tokens/s, peak above the inputs. Then
            remat off / full / dots at seq 1024 (each once untimed, then
            timed): losses and params equal within 1e-6, each one's peak
            and wall.
12. spmd_serve  zamba2-1.2b at full width (attn_impl="pallas") through
            ``build_prefill_step`` at prefill_32k (seq 32768, batch 2:
            the cut): exactly 6 flash and 32 SSD launches, all on wgmma;
            the last-token logits within 2e-2 of the largest of the same
            step under attn_impl="xla"; prefill wall, peak. Then
            ``build_decode_step`` at decode_32k (cache 32768, batch 16:
            the cut; 4 steps) and long_500k (cache 524288, batch 1,
            uncut; 2 steps) after a 512-token prefill. The process group
            ends here.
13. kernel_32k  flash at (B*H 64, 32768, 64) causal and the SSD scan at
            x (2, 32768, 64, 64), state 64, chunk 128, alone: each
            against its plain version (flash's per (batch, head) slice),
            cold device time, the plain version's, the bound and, for
            flash, SDPA's.
14. dryrun  ``python -m repro_torch.launch.dryrun`` in subprocesses on
            this host (no card work: fake tensors on a fake process
            group), 5 at a time: internlm2-1.8b x {train_4k,
            prefill_32k, decode_32k}, zamba2-1.2b x all four shapes and
            deepseek-v2-lite-16b x {train_4k, prefill_32k, decode_32k}
            at full width on the (16, 16) mesh of 256 ranks, and
            internlm2-1.8b x train_4k on the (2, 16, 16) mesh of 512:
            every record with the reference's keys and nonzero FLOPs,
            bytes and peak, every train step with collective bytes; a
            line each. Then dryrun_cross_check: the spmd_train step and
            spmd_serve's xla prefill, dry-run on a 1 x 1 mesh, their
            predicted peak, arguments and FLOPs beside what the card
            measured (peak allocation, parameters' bytes, FLOPs over the
            measured wall against the 989.4 TFLOP/s peak), with ratios.

Then a ``kernels`` line (all seven kernels with their launch counts on
the main path, times and bounds; the flash and SSD rows carry their
``prefill_32k`` readings), the card's name and power limit as
nvidia-smi gives them, and as the last line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import gc
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


# the int8 kernels at the LM training path's shapes: internlm2-1.8b's
# bf16 features at batch 32, seq 64 (32 x 64 x 2048 values, 16384 rows of
# 256), sent one transfer at a time through the list API, and a cohort
# of 4 clients' features (65536 rows) through int8_roundtrip
LM_FEATURES = (32, 64, 2048)
LM_FEATURE_ROWS = 32 * 64 * 2048 // 256
LM_COHORT_ROWS = 4 * LM_FEATURE_ROWS


def bf16_valued(torch, shape, gen):
    """Random values that bf16 holds exactly, as a CPU bf16 tensor."""
    return (torch.randn(shape, generator=gen) * 3.0).to(torch.bfloat16)


def check_int8_lm_shapes(torch, dev, gen) -> float:
    """The LM path's int8 transfers against the plain versions: one bf16
    feature tensor through ``int8_quantize_many`` and
    ``int8_dequantize_many(dtype=bf16)`` (one launch a direction) against
    the plain per-tensor loop with the same f32 cast and bf16 cast back,
    q, scale, zp and the bf16 x' bit-equal; a 4-client cohort of bf16
    features (as f32 rows) through int8_roundtrip against its plain
    version. -> the roundtrip's max abs error."""
    from repro_torch.kernels.comm_fused import kernel as cf
    from repro_torch.kernels.int8_quant import kernel as iq
    from repro_torch.kernels.int8_quant import ops as iq_ops
    x = bf16_valued(torch, LM_FEATURES, gen).to(dev)
    before = dict(iq.LAUNCHES)
    [(q, s, z, shape)] = iq_ops.int8_quantize_many([x])
    [y] = iq_ops.int8_dequantize_many([(q, s, z, shape)],
                                      dtype=torch.bfloat16)
    moved = {k: iq.LAUNCHES[k] - before[k] for k in before}
    flat = x.to(torch.float32).reshape(-1)
    [(qp, sp, zp)] = iq.int8_quantize_segments_plain([flat], [iq_ops.GROUP])
    [yp] = iq.int8_dequantize_segments_plain([qp], [sp], [zp], [flat.numel()])
    yp = yp.reshape(LM_FEATURES).to(torch.bfloat16)
    torch.cuda.synchronize()
    if tuple(q.shape) != (LM_FEATURE_ROWS, iq_ops.GROUP) \
            or y.dtype != torch.bfloat16 or tuple(y.shape) != LM_FEATURES:
        fail(f"int8 LM features: q {tuple(q.shape)}, x' {y.dtype} "
             f"{tuple(y.shape)}")
    if not (torch.equal(q, qp) and torch.equal(s, sp) and torch.equal(z, zp)
            and torch.equal(y, yp)):
        fail(f"int8 LM features: the list kernels differ from the plain "
             f"loop: q {int((q != qp).sum())}, x' {int((y != yp).sum())} "
             f"values")
    if moved != {"int8_quantize": 1, "int8_dequantize": 1}:
        fail(f"int8 LM features: launches {moved}, want one a direction")
    xc = bf16_valued(torch, (LM_COHORT_ROWS, iq_ops.GROUP), gen).to(
        dev, torch.float32)
    err = float((cf.int8_roundtrip(xc) - cf.int8_roundtrip_plain(xc))
                .abs().max())
    emit("int8_lm_shapes", features=list(LM_FEATURES),
         feature_rows=LM_FEATURE_ROWS, cohort_rows=LM_COHORT_ROWS,
         features_bit_equal=True, roundtrip_max_abs_err=err)
    return err


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
    legs at splits 3 (the row's own) and 2, vgg16's feature transfers of
    (2048, 256) and (4096, 256) rows and internlm2-1.8b's of (16384, 256)
    (bf16 values as f32; lists of one), beside the time of an empty
    kernel (``torch.cuda._sleep(0)``) in the same harness, the launch
    floor. -> {kernel name: (kern, plain, shape, bound, extra)}"""
    from repro_torch.kernels.int8_quant import kernel as iq
    from repro_torch.kernels.int8_quant import ops as iq_ops
    lists = {"leg_split3": vgg16_leg(dev, 3), "leg_split2": vgg16_leg(dev, 2)}
    for r in (2048, 4096):
        lists[f"features_{r}_rows"] = [
            (torch.randn(r * 256, generator=gen) * 3.0).to(dev)]
    lists[f"features_{LM_FEATURE_ROWS}_rows"] = [
        bf16_valued(torch, LM_FEATURE_ROWS * 256, gen).to(dev, torch.float32)]
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
    worst["int8_roundtrip"] = max(worst["int8_roundtrip"],
                                  check_int8_lm_shapes(torch, dev, gen))
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
    # group rows per device); int8_roundtrip also at internlm2-1.8b's
    # cohort (4 x 16384 rows of bf16 features as f32), in the same turns
    xc = (torch.randn(8192, 256, generator=gen) * 3.0).to(dev)
    xl = bf16_valued(torch, (LM_COHORT_ROWS, 256), gen).to(dev, torch.float32)
    y, mask, scale = sparse_inputs(dev, gen)[3]
    nc, ns = xc.numel(), y.numel()
    lm_rt, lm_rt_plain = (lambda: cf.int8_roundtrip(xl),
                          lambda: cf.int8_roundtrip_plain(xl))
    p1, k1, k2, p2 = (device_ms(f, True, 20)
                      for f in (lm_rt_plain, lm_rt, lm_rt, lm_rt_plain))
    cohort = {f"cohort_{LM_COHORT_ROWS}_rows": {
        "shape": [LM_COHORT_ROWS, 256], "ms": min(k1, k2),
        "plain_ms": min(p1, p2), "warm_l2_ms": device_ms(lm_rt, False, 20),
        "bound_ms": bound(xl.numel() * 8, xl.numel() * 9)[0],
        "device_ms_runs": [k1, k2], "plain_device_ms_runs": [p1, p2]}}
    rows = int8_list_rows(torch, dev, gen)
    rows.update({
        "int8_roundtrip": (
            lambda: cf.int8_roundtrip(xc),
            lambda: cf.int8_roundtrip_plain(xc), (8192, 256),
            bound(nc * 8, nc * 9), cohort),
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


def _grouped(events, groups_by) -> tuple:
    """Device ms and launches by kernel group of a profile's events (by
    name; what no group names is elementwise), and the top 10 kernels."""
    groups = {g: 0.0 for g, _ in groups_by}
    groups["elementwise"] = 0.0
    launches = dict.fromkeys(groups, 0)
    for e in events:
        low = e.key.lower()
        g = next((g for g, keys in groups_by
                  if any(k in low for k in keys)), "elementwise")
        groups[g] += e.self_device_time_total / 1e3
        launches[g] += e.count
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:10]
    return groups, launches, [[e.key[:80], e.self_device_time_total / 1e3,
                               e.count] for e in top]


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
    groups, launches, top = _grouped(events, TRAIN_GROUPS)
    busy = sum(groups.values())
    emit("train_int8_profile", device_ms_by_group=groups,
         launches_by_group=launches, device_busy_ms=busy, wall_ms=wall_ms,
         idle_share=max(0.0, 1.0 - busy / wall_ms),
         kernels_seen=len(events), top_kernels_ms=top)


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


# ---------------------------------- slice 9: S²FL training of the LMs
INTERNLM = "internlm2-1.8b"
# the full-width run: internlm2-1.8b as its config gives it (24 layers,
# d_model 2048, vocab 92544, 1.889 B f32 params, bf16 activations),
# split points (3, 6, 12), the trainer's seq 64 and batch 32, int8 with
# error feedback on the feature legs; the model legs stay fp32 (int8
# model legs with feedback would hold up to two f32 residuals per client
# portion, ~30 GB more: the reduced-depth parity runs take them)
LM_FULL = ["--arch", INTERNLM, "--rounds", "2", "--clients", "8",
           "--per-round", "4", "--batch-size", "32", "--seq-len", "64",
           "--n-train", "1000", "--alpha", "0.5", "--eval-every", "1000",
           "--seed", "0", "--codec", "int8", "--error-feedback"]
# the run's simulated clock and wire bytes, pinned from the first card
# run (NVIDIA H100 80GB HBM3, 700.00 W): Eq. 1 over the analytic costs
# and the metered bytes, which do not depend on the device
LM_CLOCK, LM_COMM = 3186.34285896672, 30319706176.0
# kernel groups of an LM training profile: its matmuls are cuBLAS's
# (sm90_xmma / nvjet / cutlass kernels), its norms and softmax reductions
LM_TRAIN_GROUPS = (
    ("int8_kernels", ("quantize",)),
    ("gemm", ("gemm", "cutlass", "nvjet", "xmma")),
    ("reductions", ("reduce_kernel", "softmax")),
    ("copies", ("memcpy", "memset", "copy")),
)


def phase_train_lm(torch, tmp):
    """internlm2-1.8b at full width through ``repro_torch.launch.train``,
    2 rounds of 4 clients, int8 + EF on the feature legs. Launches: each
    of the 8 client-rounds (4 clients, 2 rounds, one local step, no
    faults) sends its features up and gets their gradient back, each
    transfer one quantize and one dequantize launch of one tensor (the
    features ``h``; the aux scalar rides as 4 bytes); the fp32 model legs
    are a passthrough with no launch: exactly 16 + 16. Losses finite,
    clock and comm pinned; host wall a round, peak memory, the
    evaluation's loss (500 sequences in batches of 256 at vocab 92544).

    train_lm_profile: round 2 (the warm round) runs under the profiler:
    device ms by kernel group (the int8 list kernels, cuBLAS's GEMMs,
    reductions and softmaxes, copies and memsets, the other elementwise
    kernels) beside the round's host-clock wall, and the share of it the
    card was idle. Round 1's wall is unprofiled, round 2's profiled."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.engine import S2FLEngine
    reset_launches()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.time()
    box = {}
    with Capture() as cap:
        timed_round = S2FLEngine.run_round

        def run_round(eng):
            if len(cap.round_s) != 1:
                return timed_round(eng)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                rec = timed_round(eng)
            box["prof"] = prof
            return rec
        S2FLEngine.run_round = run_round
        res = run_train([*LM_FULL, "--device", "cuda"], tmp, "train_lm")
    torch.cuda.synchronize()
    wall = time.time() - t0
    eng = cap.engines[-1]
    cfg = eng.model.cfg
    cap.engines.clear()
    del eng
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    counts = launches()
    if (cfg.n_layers, cfg.d_model, cfg.vocab_size, cfg.dtype,
            cfg.param_dtype) != (24, 2048, 92544, "bfloat16", "float32"):
        fail(f"train_lm: not the full-width config {cfg}")
    losses = [h["loss"] for h in res["history"]]
    if len(losses) != 2 or not all(math.isfinite(v) for v in losses):
        fail(f"train_lm: losses {losses}")
    if not math.isfinite(res["final"]["loss"]):
        fail(f"train_lm: non-finite eval loss {res['final']}")
    want = {"int8_quantize": 16, "int8_dequantize": 16}
    for k, v in want.items():
        if counts[k] != v:
            fail(f"train_lm: {k} launched {counts[k]} times, want {v}")
    for k in ("int8_roundtrip", "sparse_combine", "flash_attention",
              "ssd_scan", "moe_gmm"):
        if counts[k]:
            fail(f"train_lm: {k} launched on the sequential int8 path")
    if (res["clock"], res["comm"]) != (LM_CLOCK, LM_COMM):
        fail(f"train_lm: clock {res['clock']} comm {res['comm']}, want "
             f"{LM_CLOCK} {LM_COMM}")
    if "prof" not in box:
        fail("train_lm: round 2 was not profiled")
    emit("train_lm", args=LM_FULL, launches=counts, losses=losses,
         eval=res["final"], clock=res["clock"], comm=res["comm"],
         splits=cap.splits, round_wall_s=cap.round_s,
         round_profiled=[False, True], wall_s=wall, peak_mem_gb=peak_gb)
    events = [e for e in box["prof"].key_averages()
              if e.self_device_time_total > 0]
    groups, by_group, top = _grouped(events, LM_TRAIN_GROUPS)
    busy, wall_ms = sum(groups.values()), cap.round_s[1] * 1e3
    emit("train_lm_profile", window="round 2 of train_lm",
         device_ms_by_group=groups, launches_by_group=by_group,
         device_busy_ms=busy, wall_ms=wall_ms,
         idle_share=max(0.0, 1.0 - busy / wall_ms),
         kernels_seen=len(events), top_kernels_ms=top)
    return res, counts


def phase_train_lm_fused(torch, tmp, seq):
    """The train_lm run on the fused cohort path (``--fused-comm``).
    Launches: each round stacks its cohort's 4 feature tensors into one
    buffer and sends it up through one int8_roundtrip launch, and their 4
    gradients back through another; the fp32 model legs launch nothing:
    exactly 4 int8_roundtrip (2 rounds x 2 directions) and no launch of
    the int8 pair. Clock and comm must equal train_lm's, and the losses
    be within 1e-3 of them."""
    reset_launches()
    torch.cuda.empty_cache()
    with Capture() as cap:
        res = run_train([*LM_FULL, "--device", "cuda", "--fused-comm"],
                        tmp, "train_lm_fused")
    cap.engines.clear()
    counts = launches()
    want = {"int8_roundtrip": 4, "int8_quantize": 0, "int8_dequantize": 0}
    for k, v in want.items():
        if counts[k] != v:
            fail(f"train_lm_fused: {k} launched {counts[k]} times, want {v}")
    if (res["clock"], res["comm"]) != (seq["clock"], seq["comm"]):
        fail(f"train_lm_fused: clock {res['clock']} comm {res['comm']} != "
             f"train_lm's {seq['clock']} {seq['comm']}")
    dl = max(abs(a["loss"] - b["loss"])
             for a, b in zip(seq["history"], res["history"]))
    if not dl <= LOSS_TOL:
        fail(f"train_lm_fused: losses differ from train_lm's by {dl}")
    emit("train_lm_fused", args=[*LM_FULL, "--fused-comm"],
         launches=counts, losses=[h["loss"] for h in res["history"]],
         max_loss_diff=dl, clock=res["clock"], comm=res["comm"],
         round_wall_s=cap.round_s)
    return counts


LM_SMALL = ["--reduced", "--rounds", "2", "--clients", "6",
            "--batch-size", "8", "--seq-len", "32", "--n-train", "120",
            "--alpha", "0.3", "--eval-every", "1000", "--seed", "0"]
PARITY_LM = (
    # (tag, arch, flags, kernel that must launch on the card)
    ("dense_int8", INTERNLM,
     ["--per-round", "3", "--codec", "int8", "--dispatch-codec", "int8",
      "--error-feedback"], "int8_quantize"),
    ("hybrid_fused_topk", "zamba2-1.2b",
     ["--per-round", "3", "--fused-comm", "--codec", "topk",
      "--error-feedback"], "sparse_combine"),
    ("moe_fused_server", "deepseek-v2-lite-16b",
     ["--per-round", "4", "--fused-server"], None),
)


def phase_parity_lm(tmp):
    """Reduced internlm2 (int8 on every leg, EF), zamba2 (shared
    attention; fused top-k cohort path) and deepseek (MoE + MLA; the
    multi-group server step, which must batch) on the card and on the
    CPU: clock, comm and splits exactly equal, losses within 1e-3; the
    named kernel must launch on the card."""
    out = {}
    for tag, arch, flags, kernel in PARITY_LM:
        runs = {}
        for dev in ("cuda", "cpu"):
            reset_launches()
            with Capture() as cap:
                res = run_train(["--arch", arch, *LM_SMALL, *flags,
                                 "--device", dev], tmp,
                                f"parity_lm_{tag}_{dev}")
            cap.engines.clear()
            runs[dev] = (res, cap, launches())
        (g, cg, lg), (c, cc, _) = runs["cuda"], runs["cpu"]
        for k, x, y in (("clock", g["clock"], c["clock"]),
                        ("comm", g["comm"], c["comm"]),
                        ("splits", cg.splits, cc.splits)):
            if x != y:
                fail(f"parity_lm {tag}: {k} card {x} != cpu {y}")
        if kernel is not None and lg[kernel] <= 0:
            fail(f"parity_lm {tag}: {kernel} never launched on the card")
        if "--fused-server" in flags and not cg.multi:
            fail(f"parity_lm {tag}: the server step never batched")
        losses = {d: [h["loss"] for h in r[0]["history"]]
                  for d, r in runs.items()}
        dl = max(abs(a - b) for a, b in zip(losses["cuda"], losses["cpu"]))
        if not dl <= LOSS_TOL:
            fail(f"parity_lm {tag}: losses differ by {dl}: {losses}")
        out[tag] = dict(arch=arch, args=flags, clock=g["clock"],
                        comm=g["comm"], splits=cg.splits,
                        losses_cuda=losses["cuda"], losses_cpu=losses["cpu"],
                        max_loss_diff=dl, batched_server_calls=cg.multi,
                        card_launches={k: v for k, v in lg.items() if v})
    emit("parity_lm", **out)
    return out


def phase_lm_grad_refusal(torch, dev):
    """A kernel has no backward: the flash wrapper, given CUDA tensors
    that require a gradient under grad mode, must raise before it
    launches (the same inputs under no_grad launch once)."""
    from repro_torch.kernels.flash_attention.kernel import (
        LAUNCHES, flash_attention_bhsd)
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((1, 2, 64, 64), generator=gen, device=dev,
                           dtype=torch.bfloat16) for _ in range(3))
    before = LAUNCHES["flash_attention"]
    try:
        flash_attention_bhsd(q.requires_grad_(True), k, v)
    except RuntimeError as e:
        msg = str(e)
    else:
        fail("lm_grad_refusal: the flash wrapper took a gradient input")
    if "no backward" not in msg or LAUNCHES["flash_attention"] != before:
        fail(f"lm_grad_refusal: wrong refusal {msg!r}")
    with torch.no_grad():
        flash_attention_bhsd(q, k, v)
    torch.cuda.synchronize()
    if LAUNCHES["flash_attention"] != before + 1:
        fail("lm_grad_refusal: the flash wrapper did not launch under "
             "no_grad")
    emit("lm_grad_refusal", refused=msg)


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
                            "float32", "model", "wgmma", False),
    "decode_f32_weights": (64, 8, 2048, 1408, "silu", "bfloat16", "float32",
                           "model", "stream", False),
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
# the stream / wgmma threshold sweep: C at E 64, d 2048, F 1408, with
# bf16 and with f32 weights
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
        if xdt == "bfloat16" and wdt == "float32" and want != "mma":
            extra.update(gmm_beside_mma(x, wg, wu, wd, act, want, row))
        return row, extra

    def gmm_beside_mma(x, wg, wu, wd, act, want, row):
        """f32 weights: the mma pair they took before on the same inputs
        (cold, twice, right after the row's own pair), both pairs' worst
        error against the plain version, and three f32 torch.bmm with x
        upcast (cuBLAS SGEMM, TF32 off; a yardstick only)."""
        E, C, d = x.shape
        Fd = wg.shape[-1]
        plain = gmm.moe_gmm_plain(x, wg, wu, wd, act=act).float()
        errs = {p: float((gmm._launch(x, wg, wu, wd, act, p).float()
                          - plain).abs().max()) for p in (want, "mma")}
        del plain
        mma = [device_ms(lambda: gmm._launch(x, wg, wu, wd, act, "mma"),
                         True, 5) for _ in range(2)]
        h = torch.empty((E, C, Fd), dtype=torch.float32, device=x.device)
        bmm = min(device_ms(
            lambda: (torch.bmm(x.float(), wg), torch.bmm(x.float(), wu),
                     torch.bmm(h, wd)), True, 5) for _ in range(2))
        return {"mma_ms": min(mma), "mma_device_ms_runs": mma,
                f"{want}_max_abs_err": errs[want],
                "mma_max_abs_err": errs["mma"], "bmm3_f32_ms": bmm,
                "faster_than_mma": row["ms"] < min(mma),
                "faster_than_bmm3_f32": row["ms"] < bmm}

    def gmm_sweep(label):
        """Cold device time of the stream and wgmma pairs at each C of
        GMM_SWEEP_C with the weights of GMM_CASES[label], in turns
        (stream, wgmma, wgmma, stream; the better of each pair); the
        stream kernels take C up to 64."""
        E, _, d, Fd = GMM_CASES[label][:4]
        w = gmm_inputs(torch, (E, 1) + GMM_CASES[label][2:], gen)[1:]
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
        return {"shape": [E, "C", d, Fd], "w_dtype": GMM_CASES[label][6],
                "stream_max_c": gmm.STREAM_MAX_C, "rows": rows}

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
        # moe_gmm rows keep their yardsticks for the kernels line
        timed[name] = {**row, **{k: v for k, v in extra.items() if k in (
            "path", "mma_ms", "bmm3_bf16_ms", "bmm3_f32_ms")}}
        emit("kernel", name=name, **row, **extra)
        torch.cuda.empty_cache()
    for label in ("decode", "decode_f32_weights"):
        emit("moe_gmm_threshold_sweep", **gmm_sweep(label))
        torch.cuda.empty_cache()
    return timed


ZAMBA = "zamba2-1.2b"
DEEPSEEK = "deepseek-v2-lite-16b"
INTERNVL = "internvl2-1b"
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


def phase_serve_moe_f32(torch, dev):
    """deepseek-v2-lite-16b at full width at its configured dtypes: bf16
    activations, f32 params (15.7 B values, 62.8 GB), drawn on the card
    once serve_moe's bf16 params are gone; batch 4, prompt 2048, 32
    greedy tokens, as serve_moe (uncut). One prefill must launch moe_gmm 26 times and flash 27, all on their
    wgmma paths; the generate moe_gmm 26 + 832 times, the decode steps'
    on the path ``_path`` picks at C 8 with f32 weights."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels.moe_gmm import kernel as gmm
    cfg = dataclasses.replace(get_config(DEEPSEEK), attn_impl="pallas")
    n_moe = sum(f == "moe" for _, f in cfg.pattern())
    if not (cfg.n_layers == 27 and n_moe == 26 and cfg.d_model == 2048
            and cfg.n_experts == 64 and cfg.top_k == 6 and cfg.mla
            and cfg.vocab_size == 102400 and cfg.dtype == "bfloat16"
            and cfg.param_dtype == "float32"):
        fail(f"serve_moe_f32: {DEEPSEEK} is not the full-width config at "
             f"its dtypes: {cfg}")
    held_gb = torch.cuda.memory_allocated() / 1e9
    if not held_gb < 1.0:
        fail(f"serve_moe_f32: the card holds {held_gb} GB before the draw")
    steps = 32
    decode = gmm._path(torch.bfloat16, torch.float32, 8, cfg.d_model,
                       cfg.moe_d_ff, True)
    flash = {"flash_attention": cfg.n_layers,
             "flash_attention_wgmma": cfg.n_layers}
    prefill = {"moe_gmm": n_moe, "moe_gmm_wgmma": n_moe}
    whole = {**prefill, "moe_gmm": n_moe * (1 + steps), **flash}
    whole[f"moe_gmm_{decode}"] = (whole.get(f"moe_gmm_{decode}", 0)
                                  + n_moe * steps)
    return serve_full(torch, dev, cfg, "serve_moe_f32",
                      {**prefill, **flash}, whole, draw_on_device=True)


def serve_parity(torch, dev, cfg, tag, batch=2, prompt=200, steps=8,
                 tol=SERVE_TOL, paths=None):
    """Card vs CPU on a reduced config: prefill and decode logits, both
    sides stepped with the CPU's greedy tokens; within ``tol`` (f32), or
    within ``tol`` of the largest |logit| when cfg.dtype is bf16.
    ``paths``: {phase: {moe_gmm path: launches}} the prefill and the
    decode steps must take on the card."""
    from repro_torch.models import SplitModel
    from repro_torch.models import transformer as tf
    from repro_torch.utils.tree import tree_map
    p_cpu = SplitModel(cfg).init(0, device="cpu")
    p_gpu = tree_map(lambda t: t.to(dev), p_cpu)
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt),
                           generator=torch.Generator().manual_seed(3))
    reset_launches()
    by_phase = {}
    with torch.no_grad():
        lc, cc, n = tf.prefill(cfg, p_cpu, tokens, prompt + steps)
        lg, cg, _ = tf.prefill(cfg, p_gpu, tokens.to(dev), prompt + steps)
        by_phase["prefill"] = gmm_paths()
        worst = float((lg.float().cpu() - lc.float()).abs().max())
        scale = float(lc.float().abs().max())
        for t in range(steps):
            tok = torch.argmax(lc[:, -1, :cfg.vocab_size], -1)[:, None]
            lc, cc = tf.decode_step(cfg, p_cpu, tok, cc, n + t)
            lg, cg = tf.decode_step(cfg, p_gpu, tok.to(dev), cg, n + t)
            worst = max(worst, float((lg.float().cpu() - lc.float())
                                     .abs().max()))
            scale = max(scale, float(lc.float().abs().max()))
    after = gmm_paths()
    by_phase["decode"] = {p: after[p] - by_phase["prefill"][p]
                          for p in after}
    rel = cfg.dtype == "bfloat16"
    emit(tag, arch=cfg.name, n_layers=cfg.n_layers,
         pattern=[list(k) for k in cfg.pattern()], dtype=cfg.dtype,
         param_dtype=cfg.param_dtype, batch=batch, prompt=prompt,
         steps=steps, max_abs_logit_diff=worst, tol=tol,
         tol_relative_to_logit_scale=rel, logit_scale=scale,
         moe_gmm_paths=by_phase,
         card_launches={k: v for k, v in launches().items() if v})
    if not worst <= tol * (scale if rel else 1.0):
        fail(f"{tag}: card vs CPU logits differ by {worst} (scale "
             f"{scale})")
    for phase, want in (paths or {}).items():
        got = {p: v for p, v in by_phase[phase].items() if v}
        if got != want:
            fail(f"{tag}: the {phase} ran moe_gmm {got}, want {want}")


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
    """Reduced deepseek: MLA in both layers, a dense and an MoE FFN; in
    float32, then with bf16 activations and f32 params (the full config's
    dtypes): its prefill (C 250) must take the wgmma pair and its decode
    steps (C 8) the stream pair, with f32 weights."""
    import dataclasses
    from repro_torch.configs import get_config, make_reduced
    cfg = dataclasses.replace(make_reduced(get_config(DEEPSEEK)),
                              attn_impl="pallas")
    if (cfg.dtype != "float32" or not cfg.mla
            or {f for _, f in cfg.pattern()} != {"dense", "moe"}):
        fail(f"serve_moe_parity: unexpected reduced config {cfg}")
    serve_parity(torch, dev, cfg, "serve_moe_parity")
    mixed = dataclasses.replace(cfg, dtype="bfloat16")
    steps, n_moe = 8, sum(f == "moe" for _, f in cfg.pattern())
    if mixed.param_dtype != "float32":
        fail(f"serve_moe_parity: params {mixed.param_dtype}, want float32")
    serve_parity(torch, dev, mixed, "serve_moe_parity_bf16_f32_params",
                 steps=steps, tol=SERVE_BF16_TOL,
                 paths={"prefill": {"wgmma": n_moe},
                        "decode": {"stream": n_moe * steps}})



# ------------------------------------------------------------ SPMD layer
# the SPMD steps run on a 1 x 1 DeviceMesh over a process group of one
# rank (NCCL); the only cut of each path is its batch, to one card's share
SPMD_TRAIN_BATCH = 8               # train_4k's global batch is 256
SPMD_GROUPS, SPMD_LR = 4, 0.01
SPMD_LOOP_TOL = 1e-4               # mesh step vs a hand-written group loop
SPMD_PLAIN_TOL = 1e-6              # mesh step vs the host path, relative
REMAT_SEQ = 1024                   # remat off does not fit at 4096
SPMD_PREFILL_BATCH = 2             # prefill_32k's global batch is 32
SPMD_DECODE_BATCH = 16             # decode_32k's global batch is 128
SPMD_PROMPT = 512                  # prompt before the decode steps
SERVE_BF16_TOL = 2e-2              # pallas vs xla bf16 logits, relative
                                   # to the largest |logit|


def spmd_mesh(torch, tmp: Path):
    """One rank over NCCL (a file store, no port) and a 1 x 1 mesh."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp / 'pg'}",
                            rank=0, world_size=1)
    return make_host_mesh(1, 1, device="cuda")


def _tree_rel(torch, a, b) -> float:
    """max |a - b| over max |b|, leaf by leaf (DTensors as local)."""
    from repro_torch.utils.tree import tree_leaves
    worst = 0.0
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        x = x.to_local() if hasattr(x, "to_local") else x
        y = y.to_local() if hasattr(y, "to_local") else y
        d = float((x.float() - y.float()).abs().max())
        worst = max(worst, d / max(float(y.float().abs().max()), 1e-30))
    return worst


def _tree_abs(torch, a, b) -> float:
    from repro_torch.utils.tree import tree_leaves
    worst = 0.0
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        x = x.to_local() if hasattr(x, "to_local") else x
        worst = max(worst, float((x.float() - y.float()).abs().max()))
    return worst


def _timed(torch, fn):
    """-> (result, host wall s, peak GB above what was allocated before)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return (out, time.time() - t0,
            (torch.cuda.max_memory_allocated() - base) / 1e9)


def _card_garbage_gb(torch) -> float:
    """Card memory (GB) that only the cyclic collector frees, collected:
    what the code run since the last collection left in reference
    cycles. A training loop does not collect between steps, so a step
    must leave none."""
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    gc.collect()
    return (held - torch.cuda.memory_allocated()) / 1e9


def group_loop_step(torch, cfg, params, batch, split, n_groups, lr):
    """The E=1 reference of the fused step, by hand (the counterpart of
    the reference's ``tests/test_engine.py:152``): client forward,
    ``h[perm]``, a loop over the groups' server losses, their mean plus
    the client's aux, autograd, ``w - lr * g``."""
    from repro_torch.models import SplitModel
    from repro_torch.utils.tree import tree_flatten, tree_unflatten
    model = SplitModel(cfg)
    leaves, skel = tree_flatten(params)
    leaves = [w.detach().requires_grad_(True) for w in leaves]
    p = tree_unflatten(skel, leaves)
    perm = batch["perm"].long()
    feats = model.client_forward(p, {"tokens": batch["tokens"]}, split)
    h, t_p, l_p = feats["h"][perm], batch["tokens"][perm], \
        batch["labels"][perm]
    gb = h.shape[0] // n_groups
    zero = torch.zeros((), device=h.device)
    losses = [model.server_loss(p, {"h": h[g * gb:(g + 1) * gb],
                                    "aux": zero},
                                {"tokens": t_p[g * gb:(g + 1) * gb],
                                 "labels": l_p[g * gb:(g + 1) * gb]},
                                split)[0] for g in range(n_groups)]
    loss = torch.stack(losses).mean() + feats["aux"]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    with torch.no_grad():
        new = [w.detach() if g is None else w.detach() - lr * g
               for w, g in zip(leaves, grads)]
    return tree_unflatten(skel, new), float(loss.detach())


def phase_spmd_train(torch, dev, mesh):
    """internlm2-1.8b at full width through ``build_train_step`` at
    train_4k's seq 4096 (batch 8: the one cut), 4 groups, split
    ``default_split`` (12), lr 0.01, remat forced by the builder: two
    steps on the mesh. Step 1 against the same step on the host path
    (``dp_axes=None``: bit-equal or within 1e-6 relative) and against a
    hand-written loop over the groups (within 1e-4); the first loss near
    ln(vocab). Then remat off / full / dots at seq 1024: equal losses
    and params within 1e-6; each one's peak and wall."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.configs import get_config
    from repro_torch.core.round_step import make_s2fl_train_step
    from repro_torch.launch.steps import (SHAPES, build_train_step,
                                          default_split, train_config)
    from repro_torch.models import SplitModel
    from repro_torch.models.sharding import model_param_specs, shard_params
    cfg = get_config(INTERNLM)
    if (cfg.n_layers, cfg.d_model, cfg.vocab_size, cfg.dtype,
            cfg.param_dtype) != (24, 2048, 92544, "bfloat16", "float32"):
        fail(f"spmd_train: not the full-width config {cfg}")
    seq, B = SHAPES["train_4k"]["seq"], SPMD_TRAIN_BATCH
    step, (_, bpl), _, _ = build_train_step(cfg, mesh, n_groups=SPMD_GROUPS,
                                            lr=SPMD_LR)
    tcfg = train_config(cfg, mesh)
    split = default_split(tcfg)
    if not tcfg.remat or split != 12:
        fail(f"spmd_train: remat {tcfg.remat}, split {split}")
    gen = torch.Generator().manual_seed(4)

    def batch(s):
        return {"tokens": torch.randint(0, cfg.vocab_size, (B, s),
                                        generator=gen, dtype=torch.int32)
                .to(dev),
                "labels": torch.randint(0, cfg.vocab_size, (B, s),
                                        generator=gen, dtype=torch.int32)
                .to(dev),
                "perm": torch.randperm(B, generator=gen)
                .to(torch.int32).to(dev)}

    def on_mesh(b):
        return {k: distribute_tensor(v, mesh, bpl[k]) for k, v in b.items()}
    garbage_in = _card_garbage_gb(torch)       # the earlier phases'
    params = SplitModel(tcfg).init(0, device=dev, draw_on_device=True)
    torch.cuda.synchronize()
    params_gb = torch.cuda.memory_allocated() / 1e9
    sharded = shard_params(params, model_param_specs(tcfg, mesh), mesh)
    b1, b2 = batch(seq), batch(seq)
    (new1, l1), wall1, peak1 = _timed(torch, lambda: step(sharded,
                                                          on_mesh(b1)))
    abs1 = torch.cuda.max_memory_allocated() / 1e9
    plain = make_s2fl_train_step(tcfg, split, SPMD_GROUPS, SPMD_LR)
    (p1, pl1), plain_wall, plain_peak = _timed(torch,
                                               lambda: plain(params, b1))
    l1 = float(l1.full_tensor())
    loss_rel = abs(l1 - float(pl1)) / abs(float(pl1))
    params_rel = _tree_rel(torch, new1, p1)
    bit_equal = loss_rel == 0.0 and params_rel == 0.0
    del p1
    torch.cuda.empty_cache()
    (loop_new, loop_loss), loop_wall, _ = _timed(
        torch, lambda: group_loop_step(torch, tcfg, params, b1, split,
                                       SPMD_GROUPS, SPMD_LR))
    loop_params_abs = _tree_abs(torch, new1, loop_new)
    loop_loss_abs = abs(l1 - loop_loss)
    del loop_new
    torch.cuda.empty_cache()
    (new2, l2), wall2, peak2 = _timed(torch, lambda: step(new1, on_mesh(b2)))
    abs2 = torch.cuda.max_memory_allocated() / 1e9
    l2 = float(l2.full_tensor())
    del new1, new2
    torch.cuda.empty_cache()
    # step 1 once more, from the same params and batch: is step 1's
    # higher peak its being first, or its inputs?
    (new3, l3), _, peak3 = _timed(torch, lambda: step(sharded, on_mesh(b1)))
    abs3 = torch.cuda.max_memory_allocated() / 1e9
    l3 = float(l3.full_tensor())
    del new3
    garbage_left = _card_garbage_gb(torch)     # the steps' own
    torch.cuda.empty_cache()
    ln_v = math.log(cfg.vocab_size)
    out = {"arch": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab_size, "seq": seq,
           "batch": B, "cut": "global batch 256 -> 8",
           "groups": SPMD_GROUPS, "split": split, "lr": SPMD_LR,
           "remat_forced": tcfg.remat, "mesh": dict(zip(mesh.mesh_dim_names,
                                                 mesh.shape)),
           "losses": [l1, l2], "ln_vocab": ln_v,
           "mesh_vs_plain": {"bit_equal": bit_equal, "loss_rel": loss_rel,
                             "params_rel": params_rel,
                             "tol_rel": SPMD_PLAIN_TOL},
           "group_loop": {"loss_abs": loop_loss_abs,
                          "params_abs": loop_params_abs,
                          "tol": SPMD_LOOP_TOL, "wall_s": loop_wall},
           "step_wall_s": [wall1, wall2], "plain_step_wall_s": plain_wall,
           "tokens_per_s": B * seq / wall2, "params_gb": params_gb,
           "step_peak_gb_above_inputs": [peak1, peak2],
           "plain_step_peak_gb_above_inputs": plain_peak,
           "step_peak_gb": [abs1, abs2],
           "step1_again": {"loss": l3, "peak_gb_above_inputs": peak3,
                           "peak_gb": abs3},
           "cyclic_garbage_gb": {"before_params": garbage_in,
                                 "after_steps": garbage_left}}
    if not (math.isfinite(l1) and math.isfinite(l2)
            and abs(l1 - ln_v) < 1.0):
        fail(f"spmd_train: losses {l1} {l2}, ln(vocab) {ln_v}")
    if not (bit_equal or max(loss_rel, params_rel) <= SPMD_PLAIN_TOL):
        fail(f"spmd_train: mesh vs host step {loss_rel} {params_rel}")
    if garbage_left > 0:
        fail(f"spmd_train: the steps left {garbage_left} GB on the card in "
             f"reference cycles")
    if not max(loop_loss_abs, loop_params_abs) <= SPMD_LOOP_TOL:
        fail(f"spmd_train: vs the group loop {loop_loss_abs} "
             f"{loop_params_abs}")

    # remat off / full / dots at seq 1024, from the same params and batch
    b3 = batch(REMAT_SEQ)
    variants = {"off": {"remat": False}, "full": {},
                "dots": {"remat_policy": "dots"}}
    steps = {k: build_train_step(cfg, mesh, n_groups=SPMD_GROUPS,
                                 lr=SPMD_LR, **kw)[0]
             for k, kw in variants.items()}
    remat, ref = {}, None
    for k, st in steps.items():
        # once untimed: cuBLAS and DTensor's dispatch caches warm at the
        # new shapes, then the timed step
        st(sharded, on_mesh(b3))
        (new, loss), wall, peak = _timed(torch, lambda: st(sharded,
                                                           on_mesh(b3)))
        loss = float(loss.full_tensor())
        if ref is None:
            ref = (new, loss)
        remat[k] = {"loss": loss, "wall_s": wall,
                    "peak_gb_above_inputs": peak,
                    "loss_rel_vs_off": abs(loss - ref[1]) / abs(ref[1]),
                    "params_rel_vs_off": _tree_rel(torch, new, ref[0])}
        del new
        torch.cuda.empty_cache()
    out["remat_seq"], out["remat_sweep"] = REMAT_SEQ, remat
    emit("spmd_train", **out)
    for k, r in remat.items():
        if not max(r["loss_rel_vs_off"], r["params_rel_vs_off"]) <= 1e-6:
            fail(f"spmd_train: remat {k} differs from remat off: {r}")
    del sharded, params, ref
    torch.cuda.empty_cache()
    return out


def phase_spmd_serve(torch, dev, mesh):
    """zamba2-1.2b at full width, attn_impl="pallas", through the step
    builders on the mesh. ``build_prefill_step`` at prefill_32k (seq
    32768, batch 2: the cut): exactly 6 flash and 32 SSD launches, all on
    wgmma; its last-token logits within 2e-2 (relative to the largest)
    of the same step under attn_impl="xla". ``build_decode_step`` at
    decode_32k (cache 32768, batch 16: the cut) after a 512-token
    prefill, 4 steps, and at long_500k (cache 524288, batch 1, uncut),
    2 steps. -> (launch counts of the 32k prefill, the readings)."""
    import dataclasses
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import (SHAPES, build_decode_step,
                                          build_prefill_step)
    from repro_torch.models import SplitModel
    from repro_torch.models.sharding import model_param_specs, shard_params
    cfg = dataclasses.replace(get_config(ZAMBA), attn_impl="pallas")
    if not (cfg.n_layers == 38 and cfg.d_model == 2048
            and cfg.vocab_size == 32000 and cfg.dtype == "bfloat16"):
        fail(f"spmd_serve: {ZAMBA} is not the full-width config: {cfg}")
    xla = dataclasses.replace(cfg, attn_impl="xla")
    garbage_in = _card_garbage_gb(torch)       # the earlier phases'
    before = torch.cuda.memory_allocated()
    params = SplitModel(cfg).init(0, device=dev, draw_on_device=True)
    torch.cuda.synchronize()
    params_gb = (torch.cuda.memory_allocated() - before) / 1e9
    sharded = shard_params(params, model_param_specs(cfg, mesh), mesh)
    gen = torch.Generator().manual_seed(6)

    def tokens(b, s):
        return torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                             dtype=torch.int32).to(dev)
    out = {"arch": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "params_gb": params_gb, "prefill": {},
           "decode": {}, "cyclic_garbage_gb_before_params": garbage_in}
    seq = SHAPES["prefill_32k"]["seq"]
    toks = tokens(SPMD_PREFILL_BATCH, seq)
    last = {}
    with torch.no_grad():
        for c in (cfg, xla):
            pstep, (_, pin), _, _ = build_prefill_step(c, mesh)
            reset_launches()
            (logits, caches), wall, peak = _timed(torch, lambda: pstep(
                sharded, {"tokens": distribute_tensor(toks, mesh,
                                                      pin["tokens"])}))
            counts = {k: v for k, v in launches().items() if v}
            last[c.attn_impl] = logits.to_local()
            del caches, logits
            torch.cuda.empty_cache()
            out["prefill"][c.attn_impl] = {
                "seq": seq, "batch": SPMD_PREFILL_BATCH,
                "cut": "global batch 32 -> 2", "prefill_s": wall,
                "tokens_per_s": SPMD_PREFILL_BATCH * seq / wall,
                "peak_gb_above_inputs": peak, "launches": counts,
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        diff = float((last["pallas"].float() - last["xla"].float())
                     .abs().max())
        scale = float(last["xla"].float().abs().max())
        out["last_logits"] = {"max_abs_diff": diff, "logit_scale": scale,
                              "tol_rel": SERVE_BF16_TOL,
                              "finite": bool(torch.isfinite(
                                  last["pallas"].float()).all())}
        for shape, b, n_steps in (("decode_32k", SPMD_DECODE_BATCH, 4),
                                  ("long_500k", 1, 2)):
            cache_len = SHAPES[shape]["seq"]
            pstep, (_, pin), _, _ = build_prefill_step(cfg, mesh,
                                                       shape=shape)
            dstep, (_, din), _, _ = build_decode_step(cfg, mesh,
                                                      shape=shape)
            prompt = tokens(b, SPMD_PROMPT)
            (logits, caches), pre_s, _ = _timed(torch, lambda: pstep(
                sharded, {"tokens": distribute_tensor(prompt, mesh,
                                                      pin["tokens"])}))
            cache_gb = sum(t.to_local().numel() * t.to_local().element_size()
                           for layer in caches for t in layer.values()) / 1e9
            walls, sample = [], []
            reset_launches()
            for i in range(n_steps):
                tok = torch.argmax(logits.to_local()[:, -1, :cfg.vocab_size],
                                   -1)[:, None].to(torch.int32)
                sample.append(int(tok[0, 0]))
                (logits, caches), wall, _ = _timed(torch, lambda: dstep(
                    sharded, {"token": distribute_tensor(tok, mesh,
                                                         din["token"]),
                              "index": distribute_tensor(
                                  torch.tensor(SPMD_PROMPT + i,
                                               dtype=torch.int32,
                                               device=dev),
                                  mesh, din["index"]),
                              "caches": caches}))
                walls.append(wall)
            finite = bool(torch.isfinite(logits.to_local().float()).all())
            out["decode"][shape] = {
                "batch": b, "cache_len": cache_len, "prompt": SPMD_PROMPT,
                "cut": ("global batch 128 -> 16" if shape == "decode_32k"
                        else "none"),
                "cache_gb": cache_gb, "prefill_s": pre_s,
                "step_wall_s": walls, "launches": {
                    k: v for k, v in launches().items() if v},
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                "finite": finite, "sample": sample}
            del logits, caches
            torch.cuda.empty_cache()
            if not finite:
                fail(f"spmd_serve: {shape} decode logits not finite")
    emit("spmd_serve", **out)
    counts = out["prefill"]["pallas"]["launches"]
    want = {"flash_attention": 6, "flash_attention_wgmma": 6,
            "ssd_scan": 32, "ssd_scan_wgmma": 32}
    if counts != want:
        fail(f"spmd_serve: the 32k prefill launched {counts}, want {want}")
    if out["prefill"]["xla"]["launches"]:
        fail(f"spmd_serve: the xla prefill launched "
             f"{out['prefill']['xla']['launches']}")
    lg = out["last_logits"]
    if not (lg["finite"] and lg["max_abs_diff"]
            <= SERVE_BF16_TOL * lg["logit_scale"]):
        fail(f"spmd_serve: pallas vs xla last-token logits {lg}")
    del sharded, params
    torch.cuda.empty_cache()
    return counts, out


def _once_ms(torch, fn) -> float:
    """CUDA events around one call (a plain version of 0.2-1.3 s, whose
    own length swamps the launch path)."""
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b)


def row_32k(torch, kern, plain, lib, shape, bnd, n_ops, err) -> dict:
    """Plain, kernel, kernel, plain in turns (the better of each pair):
    the kernel's cold device time (``device_ms``, 5 calls a run), the
    plain version's from one call each; the library yardstick's cold
    time."""
    p1 = _once_ms(torch, plain)
    k1, k2 = device_ms(kern, True, 5), device_ms(kern, True, 5)
    p2 = _once_ms(torch, plain)
    lib_ms = (min(device_ms(lib, True, 5) for _ in range(2))
              if lib is not None else None)
    ms = min(k1, k2)
    return {"shape": shape, "ms": ms, "plain_ms": min(p1, p2),
            "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": lib_ms,
            "max_abs_err": err, "device_ms_runs": [k1, k2],
            "plain_ms_runs": [p1, p2],
            "warm_l2_ms": device_ms(kern, False, 5),
            "achieved_tflops": n_ops / (ms * 1e-3) / 1e12}


def phase_kernels_32k(torch):
    """flash and the SSD scan alone at the 32k prefill's shapes, each
    against its plain version (flash's per (batch, head) slice: the
    scores of one slice are 4.3 GB in f32), with the cold device time,
    the plain version's, the bound and, for flash, SDPA's. -> rows."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import kernel as ss
    gen = torch.Generator().manual_seed(7)
    seq, B = 32768, SPMD_PREFILL_BATCH
    rows = {}

    case = (B, seq, 32, 32, 64, 64, True, 0)      # zamba2's shared attn
    q, k, v = fa_inputs(torch, case, torch.bfloat16, gen)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    qc, kc, vc = (t.contiguous() for t in (qh, kh, vh))
    H = case[2]

    def kern():
        return fa_ops.flash_attention(q, k, v, causal=True)

    def plain():
        return [fa.attention_plain(qh[b:b + 1, h:h + 1], kh[b:b + 1, h:h + 1],
                                   vh[b:b + 1, h:h + 1], causal=True)
                for b in range(B) for h in range(H)]
    before = flash_paths()
    o = kern()
    torch.cuda.synchronize()
    path = path_taken(flash_paths, before)
    err, ex = 0.0, -1.0
    oh = o.transpose(1, 2)
    for b in range(B):
        for h in range(H):
            ref = fa.attention_plain(qh[b:b + 1, h:h + 1],
                                     kh[b:b + 1, h:h + 1],
                                     vh[b:b + 1, h:h + 1], causal=True)
            got = oh[b:b + 1, h:h + 1]
            err = max(err, float((got.float() - ref.float()).abs().max()))
            ex = max(ex, excess(got, ref, *FA_TOL["bfloat16"]))
            del ref
    if path != "wgmma" or not ex <= 0:
        fail(f"flash at 32k: path {path}, max abs err {err}")
    n_bytes = (q.numel() + k.numel() + v.numel() + B * seq * H * 64) * 2
    n_ops = 2 * B * H * (64 + 64) * kept_pairs(seq, seq, True, 0)
    row = row_32k(
        torch, kern, plain,
        lambda: F.scaled_dot_product_attention(qc, kc, vc, is_causal=True),
        [B * H, seq, 64, 64], bound(n_bytes, n_ops, BF16_OPS_PER_S), n_ops,
        err)
    rows["flash_attention"] = {**row, "path": path,
                               "plain": "per (batch, head) slice",
                               "sdpa_tflops": n_ops / (row["library_ms"]
                                                       * 1e-3) / 1e12}
    emit("kernel_32k", name="flash_attention", **rows["flash_attention"])
    del q, k, v, qh, kh, vh, qc, kc, vc, o, oh
    torch.cuda.empty_cache()

    sc = (B, seq, 64, 64, 64, 128, True, "wgmma")  # zamba2's SSM layers
    x, dtt, A, Bm, Cm, init = ssd_inputs(torch, sc, torch.bfloat16, gen)
    b_, s_, h_, p_, n_, l_ = sc[:6]
    before = ssd_paths()
    y, f = ss.ssd_scan(x, dtt, A, Bm, Cm, chunk=l_, initial_state=init)
    torch.cuda.synchronize()
    path = path_taken(ssd_paths, before)
    yp, fp = ss.ssd_scan_plain(x, dtt, A, Bm, Cm, chunk=l_,
                               initial_state=init)
    err = max(float((y.float() - yp.float()).abs().max()),
              float((f.float() - fp.float()).abs().max()))
    ex = max(excess(y, yp, *SSD_TOL["bfloat16"]),
             excess(f, fp, *SSD_TOL["bfloat16"]))
    if path != "wgmma" or not ex <= 0:
        fail(f"ssd_scan at 32k: path {path}, outside {SSD_TOL['bfloat16']} "
             f"by {ex}")
    del y, f, yp, fp
    nc = s_ // l_
    n_bytes = (2 * x.numel() * 2 + dtt.numel() * 4 + A.numel() * 4
               + 2 * Bm.numel() * 2 + 2 * init.numel() * 2)
    n_ops = (b_ * nc * 2 * l_ * l_ * n_
             + b_ * h_ * nc * (2 * (l_ * (l_ + 1) // 2) * p_
                               + 2 * l_ * n_ * p_ + 2 * l_ * p_ * n_))
    rows["ssd_scan"] = {**row_32k(
        torch,
        lambda: ss.ssd_scan(x, dtt, A, Bm, Cm, chunk=l_, initial_state=init),
        lambda: ss.ssd_scan_plain(x, dtt, A, Bm, Cm, chunk=l_,
                                  initial_state=init),
        None, list(sc[:6]), bound(n_bytes, n_ops, BF16_OPS_PER_S), n_ops,
        err), "path": path}
    emit("kernel_32k", name="ssd_scan", **rows["ssd_scan"])
    del x, dtt, A, Bm, Cm, init
    torch.cuda.empty_cache()
    return rows


# the dryrun phase: (arch, shape) on the (16, 16) fake mesh, full width
DRYRUN_PAIRS = ((INTERNLM, "train_4k"), (INTERNLM, "prefill_32k"),
                (INTERNLM, "decode_32k"), (ZAMBA, "train_4k"),
                (ZAMBA, "prefill_32k"), (ZAMBA, "decode_32k"),
                (ZAMBA, "long_500k"), (DEEPSEEK, "train_4k"),
                (DEEPSEEK, "prefill_32k"), (DEEPSEEK, "decode_32k"),
                # a modality frontend: the embedding's partial sum reduced
                # before the prefix is concatenated
                (INTERNVL, "train_4k"))
DRYRUN_WORKERS = 5                 # of the host's 8 cores
DRYRUN_TIMEOUT_S = 600
# the two steps spmd_train and spmd_serve time, on a 1 x 1 fake mesh
DRYRUN_CHECKS = {
    "spmd_train": ["--arch", INTERNLM, "--shape", "train_4k", "--mesh",
                   "1x1", "--batch", str(SPMD_TRAIN_BATCH), "--groups",
                   str(SPMD_GROUPS)],
    "spmd_serve_xla": ["--arch", ZAMBA, "--shape", "prefill_32k", "--mesh",
                       "1x1", "--batch", str(SPMD_PREFILL_BATCH),
                       "--attn-impl", "xla"],
}
DRYRUN_KEYS = ("arch", "shape", "chips", "t_compute_s", "t_memory_s",
               "t_collective_s", "dominant", "hlo_flops", "hlo_bytes",
               "coll_bytes", "model_flops", "useful_ratio",
               "flops_estimated", "multi_pod", "lower_s", "compile_s",
               "bytes_per_device", "argument_bytes", "output_bytes",
               "peak_bytes", "coll_counts")


def _dryrun_jobs(tmp: Path) -> dict:
    """tag -> the dry-run CLI's arguments (each its own process: one
    process group a process, and this process holds the NCCL one)."""
    jobs = {f"{a}|{s}": ["--arch", a, "--shape", s] for a, s in DRYRUN_PAIRS}
    jobs[f"{INTERNLM}|train_4k|multi_pod"] = ["--arch", INTERNLM, "--shape",
                                             "train_4k", "--multi-pod"]
    jobs.update(DRYRUN_CHECKS)
    return {tag: [sys.executable, "-m", "repro_torch.launch.dryrun",
                  "--device", "cuda", *args, "--json",
                  str(tmp / f"{i}.json")]
            for i, (tag, args) in enumerate(jobs.items())}


def _dryrun(cmd: list, env: dict) -> tuple:
    """One dry-run CLI call -> (its records, exit code, wall s, log
    tail); killed at ``DRYRUN_TIMEOUT_S``."""
    out = cmd[cmd.index("--json") + 1]
    t0 = time.time()
    with open(out + ".log", "w") as log:
        try:
            rc = subprocess.run(cmd, cwd=ROOT, env=env, stdout=log,
                                stderr=log, timeout=DRYRUN_TIMEOUT_S
                                ).returncode
        except subprocess.TimeoutExpired:
            rc = "timeout"
    recs = json.loads(Path(out).read_text()) if Path(out).exists() else []
    return recs, rc, time.time() - t0, Path(out + ".log").read_text()[-2000:]


def run_dryruns(tmp: Path) -> dict:
    """All dry-runs, ``DRYRUN_WORKERS`` at a time, the trains first;
    -> tag -> (record, wall s). A run that fails ends the smoke (once
    the runs under way have ended)."""
    import os
    from concurrent.futures import ThreadPoolExecutor, as_completed
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    jobs = _dryrun_jobs(tmp)
    done = {}
    with ThreadPoolExecutor(DRYRUN_WORKERS) as pool:
        runs = {pool.submit(_dryrun, jobs[tag], env): tag
                for tag in sorted(jobs, key=lambda t: "train" not in t)}
        for f in as_completed(runs):
            tag = runs[f]
            recs, rc, secs, tail = f.result()
            if rc != 0 or len(recs) != 1 or "error" in recs[0]:
                pool.shutdown(cancel_futures=True)
                fail(f"dryrun {tag}: exit {rc}: {tail}")
            done[tag] = (recs[0], secs)
    return done


def phase_dryrun(trained: dict, served: dict):
    """The production-mesh dry-run (``repro_torch.launch.dryrun``) in
    subprocesses on this host: the eleven (arch, shape) pairs of
    ``DRYRUN_PAIRS`` on the (16, 16) mesh of a fake 256-rank group and
    internlm2-1.8b x train_4k on the (2, 16, 16) mesh of a 512-rank one,
    at full width: a line each with the roofline terms, the collectives
    and the peak. Then the two steps that spmd_train and spmd_serve ran
    on the card, dry-run on a 1 x 1 fake mesh: their predicted peak,
    arguments and FLOPs beside what the card measured (its peak
    allocation, its parameters' bytes, FLOPs over the measured wall)."""
    with tempfile.TemporaryDirectory() as d:
        t0 = time.time()
        done = run_dryruns(Path(d))
        wall = time.time() - t0
    for tag, (rec, secs) in done.items():
        if tag in DRYRUN_CHECKS:
            continue
        missing = [k for k in DRYRUN_KEYS if k not in rec]
        if missing or not (rec["hlo_flops"] > 0 and rec["hlo_bytes"] > 0
                           and rec["peak_bytes"] > 0):
            fail(f"dryrun {tag}: record {rec} (missing {missing})")
        if rec["shape"] == "train_4k" and not rec["coll_bytes"] > 0:
            fail(f"dryrun {tag}: a train step moved no bytes between ranks")
        emit("dryrun", mesh=rec["mesh"], wall_s=secs,
             **{k: rec[k] for k in DRYRUN_KEYS})

    gb = 1e9
    tr, _ = done["spmd_train"]
    sv, _ = done["spmd_serve_xla"]
    step2 = trained["step_wall_s"][1]
    xla = served["prefill"]["xla"]
    checks = {
        "spmd_train": {
            "step": (f"{INTERNLM} build_train_step, seq 4096, batch "
                     f"{SPMD_TRAIN_BATCH}, {SPMD_GROUPS} groups, 1 x 1"),
            "argument_gb": {"predicted": tr["argument_bytes"] / gb,
                            "measured_params": trained["params_gb"]},
            "peak_gb_above_inputs": {
                "predicted": tr["bytes_per_device"] / gb,
                "measured_step1": trained["step_peak_gb_above_inputs"][0],
                "measured_step2": trained["step_peak_gb_above_inputs"][1],
                "measured_step1_again":
                    trained["step1_again"]["peak_gb_above_inputs"]},
            "peak_gb": {"predicted": tr["peak_bytes"] / gb,
                        "measured_step1": trained["step_peak_gb"][0],
                        "measured_step2": trained["step_peak_gb"][1],
                        "measured_step1_again":
                            trained["step1_again"]["peak_gb"]},
            "tflops": {"flops": tr["hlo_flops"], "wall_s": step2,
                       "measured": tr["hlo_flops"] / step2 / 1e12,
                       "peak": hlo_peak_tflops()},
            "predicted_s": {"compute": tr["t_compute_s"],
                            "memory": tr["t_memory_s"]}},
        "spmd_serve_xla": {
            "step": (f"{ZAMBA} build_prefill_step, seq 32768, batch "
                     f"{SPMD_PREFILL_BATCH}, attn_impl xla, 1 x 1"),
            "argument_gb": {"predicted": sv["argument_bytes"] / gb,
                            "measured_params": served["params_gb"]},
            "peak_gb_above_inputs": {
                "predicted": sv["bytes_per_device"] / gb,
                "measured": xla["peak_gb_above_inputs"]},
            "peak_gb": {"predicted": sv["peak_bytes"] / gb,
                        "measured": xla["peak_gb"]},
            "tflops": {"flops": sv["hlo_flops"], "wall_s": xla["prefill_s"],
                       "measured": sv["hlo_flops"] / xla["prefill_s"] / 1e12,
                       "peak": hlo_peak_tflops()},
            "predicted_s": {"compute": sv["t_compute_s"],
                            "memory": sv["t_memory_s"]}},
    }
    for c in checks.values():
        for v in c.values():
            if isinstance(v, dict) and "predicted" in v:
                v["ratio"] = {k: v["predicted"] / m for k, m in v.items()
                              if k.startswith("measured") and m}
        c["tflops"]["share_of_peak"] = (c["tflops"]["measured"]
                                        / c["tflops"]["peak"])
    emit("dryrun_cross_check", wall_s=wall, **checks)
    return checks


def hlo_peak_tflops() -> float:
    from repro_torch.utils import hlo
    return hlo.PEAK_FLOPS / 1e12


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
        lm_seq, lm_counts = phase_train_lm(torch, tmp)
        lm_fused = phase_train_lm_fused(torch, tmp, lm_seq)
        phase_parity_lm(tmp)
        phase_lm_grad_refusal(torch, dev)
        torch.cuda.empty_cache()
    timed.update(phase_lm_kernels(torch))
    served = phase_serve(torch, dev)
    phase_serve_parity(torch, dev)
    served_moe = phase_serve_moe(torch, dev)
    served_moe_f32 = phase_serve_moe_f32(torch, dev)
    phase_serve_moe_parity(torch, dev)
    with tempfile.TemporaryDirectory() as d:
        mesh = spmd_mesh(torch, Path(d))
        try:
            spmd_trained = phase_spmd_train(torch, dev, mesh)
            spmd_served, spmd_serve_out = phase_spmd_serve(torch, dev, mesh)
        finally:
            torch.distributed.destroy_process_group()
    at_32k = phase_kernels_32k(torch)
    torch.cuda.empty_cache()
    phase_dryrun(spmd_trained, spmd_serve_out)

    flash_by_serve = {"serve": served["flash_attention"],
                      "serve_moe": served_moe["flash_attention"],
                      "serve_moe_f32": served_moe_f32["flash_attention"],
                      "spmd_serve": spmd_served["flash_attention"]}
    gmm_by_serve = {"serve_moe": served_moe, "serve_moe_f32": served_moe_f32}
    ssd_by_serve = {"serve": served["ssd_scan"],
                    "spmd_serve": spmd_served["ssd_scan"]}
    main_path = {"int8_quantize": seq["int8_quantize"],
                 "int8_dequantize": seq["int8_dequantize"],
                 "int8_roundtrip": f_int8["int8_roundtrip"],
                 "sparse_combine": f_topk["sparse_combine"],
                 "flash_attention": sum(flash_by_serve.values()),
                 "ssd_scan": sum(ssd_by_serve.values()),
                 "moe_gmm": sum(c["moe_gmm"] for c in gmm_by_serve.values())}
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
                      + served_moe_f32[f"flash_attention_{p}"]
                      + spmd_served.get(f"flash_attention_{p}", 0)
                      for p in ("wgmma", "fp32")}
    also = {"flash_attention": {"launches_by_path": flash_by_serve,
                                "launches_by_kernel_path": by_kernel_path,
                                "mla": timed["flash_attention_mla"],
                                "prefill_32k": at_32k["flash_attention"]},
            "moe_gmm": {"launches_by_path": {
                tag: {p: c[f"moe_gmm_{p}"] for p in gmm_paths()}
                for tag, c in gmm_by_serve.items()},
                "decode": timed["moe_gmm_decode"],
                "prefill_f32_weights": timed["moe_gmm_prefill_f32_weights"],
                "decode_f32_weights": timed["moe_gmm_decode_f32_weights"]},
            "ssd_scan": {"launches_by_path": ssd_by_serve,
                         "launches_by_kernel_path": {
                             p: served[f"ssd_scan_{p}"]
                             + spmd_served.get(f"ssd_scan_{p}", 0)
                             for p in ssd_paths()},
                         "prefill_32k": at_32k["ssd_scan"]}}
    for k in ("int8_quantize", "int8_dequantize"):
        also[k] = {key: v for key, v in timed[k].items()
                   if key.startswith(("leg_", "features_", "launch_floor",
                                      "warm_l2"))}
        also[k]["launches_train_lm"] = lm_counts[k]
    also["int8_roundtrip"] = {
        **{key: v for key, v in timed["int8_roundtrip"].items()
           if key.startswith("cohort_")},
        "launches_train_lm_fused": lm_fused["int8_roundtrip"]}
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
