"""S²FL training rounds through ``S2FLEngine.run_round``, the engine
built as ``repro_torch.launch.train`` builds it.

Set-up draws the federated data and the weights from the seed, builds
one engine (its cohort and batch-row draws, and the clients' device
kinds, come from the mix's own seeds, so that every seed runs the same
sequence of rounds on other data and weights) and runs its first
``checked_rounds`` rounds: the sliding split's K warm-up rounds (they
also build the int8 kernels) and the first rounds of its steady state,
in which each client gets a split of its own. It keeps each round's
loss, the per-leaf norms of the first round's update over the learning
rate and of the change after the checked rounds, and the simulated clock
and wire bytes. The same engine then runs rounds for the window. After
the window the plain reference follows the checked rounds from the same
weights and data, and ``correct`` compares them.

The window's tokens are the mix's: every client holds at least a batch
of rows, so a round trains ``per_round x batch x seq_len x
local_steps`` tokens.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import statistics
import sys
import time

import torch

from portbench import tracing, traffic, weights
from portbench.cell import Check, Outcome
from portbench.reference import lm
from portbench.reference import s2fl as ref

RANGES = (
    ("repro_torch.core.engine", "S2FLEngine._client_fwd", "client_fwd"),
    ("repro_torch.core.engine", "S2FLEngine._server_step", "server_step"),
    ("repro_torch.core.engine", "S2FLEngine._client_update",
     "client_update"),
    ("repro_torch.core.engine", "_sgd", "sgd"),
    ("repro_torch.core.engine", "aggregate", "aggregate"),
    ("repro_torch.comm.channel", "CommChannel.uplink_features", "uplink"),
    ("repro_torch.comm.channel", "CommChannel.downlink_grads", "downlink"),
)


def round_tokens(mix: dict) -> int:
    """Client tokens a round trains."""
    return (mix["per_round"] * mix["batch"] * mix["seq_len"]
            * mix["local_steps"])


def _engine(cfg, mix, data, w0, device):
    from repro_torch.configs import CommConfig, DriverConfig
    from repro_torch.core.engine import EngineConfig, S2FLEngine
    from repro_torch.core.simulation import make_device_grid
    from repro_torch.models import SplitModel

    class GivenWeights(SplitModel):
        """The port's model, initialised to the benchmark's weights."""

        def init(self, seed, *, device, draw_on_device=False):
            return w0

    ecfg = EngineConfig(
        mode="s2fl", rounds=0, clients_per_round=mix["per_round"],
        batch_size=mix["batch"], local_steps=mix["local_steps"],
        lr=mix["lr"], seed=mix["schedule_seed"], use_balance=True,
        use_sliding=True,
        group_size=mix["group_size"], split_k=mix["split_k"],
        n_classes=mix["domains"],
        comm=CommConfig(codec=mix["codec"],
                        error_feedback=mix["error_feedback"]),
        driver=DriverConfig())
    devices = make_device_grid(len(data), seed=mix["device_seed"])
    return S2FLEngine(GivenWeights(cfg), data, ecfg, devices=devices,
                      device=device)


def _norms(a, b, scale=1.0):
    """{leaf path: ||a - b|| * scale} of two params trees."""
    bl = dict(weights.leaves(b))
    return {p: float(torch.linalg.vector_norm(
        (x.float() - bl[p].float()).double())) * scale
        for p, x in weights.leaves(a)}


def leaf_gap(prog: dict, refn: dict, ref_grad: dict) -> tuple:
    """Worst leaf's |prog - ref| over max(ref, median ref), over leaves
    whose reference first-round gradient is at least 1e-3 of the median
    leaf's -> (gap, leaf)."""
    med_g = statistics.median(ref_grad.values())
    med = statistics.median(refn.values())
    worst, at = 0.0, None
    for p, r in refn.items():
        if ref_grad[p] < 1e-3 * med_g:
            continue
        gap = abs(prog[p] - r) / max(r, med)
        if not gap <= worst:
            worst, at = gap, p
    return worst, at


def run(cell, cfg, seed, seconds, trace, device, t_process, *,
        break_step=None):
    """One run of the cell. ``break_step`` (tests and calibration only)
    plants a fault in the timed path: it is handed the engine before the
    checked rounds."""
    from repro_torch.kernels.int8_quant.kernel import LAUNCHES
    from repro_torch.models.transformer import model_defs
    mix = cell.mix
    cfg = dataclasses.replace(cfg, attn_impl=mix["attn_impl"])
    data = traffic.federated_lm(mix, seed)
    w0 = weights.make_weights(model_defs(cfg), seed, cfg.param_dtype,
                              device)
    eng = _engine(cfg, mix, data, w0, device)
    if break_step is not None:
        break_step(eng)

    checked = mix["checked_rounds"]
    losses, grad_n, change_n = [], None, None
    for r in range(checked):
        losses.append(eng.run_round()["loss"])
        if r == 0:
            grad_n = _norms(w0, eng.params, 1.0 / mix["lr"])
    change_n = _norms(eng.params, w0)
    clock, comm = eng.clock, eng.comm
    del w0
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    # ---- the window: rounds until the time is up
    launches0 = dict(LAUNCHES)
    alloc0 = tracing.allocator_counts(device)
    rounds, failed, steps, cpu = 0, 0, [], []
    with tracing.traced(trace, RANGES) as (rec, prof):
        with rec.span("window"):
            setup_s = time.perf_counter() - t_process
            t0 = time.perf_counter()
            while True:
                ts, cs = time.perf_counter(), time.process_time()
                with rec.span("round"):
                    loss = eng.run_round()["loss"]
                    if device.type == "cuda":
                        torch.cuda.synchronize()
                steps.append(time.perf_counter() - ts)
                cpu.append(time.process_time() - cs)
                rounds += 1
                failed += not math.isfinite(loss)
                if time.perf_counter() - t0 >= seconds:
                    break
            wall = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() if device.type == "cuda"
            else 0)
    launches = {k: LAUNCHES[k] - launches0[k] for k in LAUNCHES}
    alloc = {k: v - alloc0[k]
             for k, v in tracing.allocator_counts(device).items()}
    window_tokens = rounds * round_tokens(mix)
    del eng
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # ---- the plain reference follows the checked rounds
    t_ref = time.perf_counter()
    checks, splits = compare(cell, cfg, data, seed, device, losses, grad_n,
                             change_n, clock, comm)
    print(f"reference: {len(splits)} rounds in "
          f"{time.perf_counter() - t_ref:.1f} s; splits a round "
          f"{splits}", file=sys.stderr)
    return Outcome(
        e2e={"train_tokens_per_s": window_tokens / wall},
        setup_s=setup_s, attempted=rounds, failed=failed, checks=checks,
        memory_peak_bytes=peak,
        trace=tracing.trace_of(prof, rec) if trace else None,
        context={"kind": "train", "cfg": cfg, "rounds": rounds,
                 "tokens": window_tokens, "seq_len": mix["seq_len"],
                 "wall_s": wall, "launches": launches, "steps_s": steps,
                 "steps_cpu_s": cpu, "window_allocator": alloc})


def reference_readings(cell, cfg, data, seed, device, rnd=None):
    """The reference's losses, per-leaf norms, clock, bytes and splits
    of the checked rounds, from the seed's weights."""
    from repro_torch.models.transformer import model_defs
    mix = cell.mix
    w0 = weights.make_weights(model_defs(cfg), seed, cfg.param_dtype,
                              device)
    with lm.exact_f32():
        outs = ref.rounds(
            cfg, w0, data, seed=mix["schedule_seed"],
            rounds=mix["checked_rounds"],
            per_round=mix["per_round"], batch=mix["batch"], lr=mix["lr"],
            group_size=mix["group_size"],
            split_points=split_points(cfg.n_layers, mix["split_k"]),
            n_classes=mix["domains"], local_steps=mix["local_steps"],
            device_seed=mix["device_seed"], device=device,
            **({"rnd": rnd} if rnd is not None else {}))
    flat0 = dict(weights.leaves(w0))
    lr = mix["lr"]
    grad = {p: float(torch.linalg.vector_norm(
        (flat0[p].float() - outs[0]["params"][p]).double())) / lr
        for p in flat0}
    change = {p: float(torch.linalg.vector_norm(
        (outs[-1]["params"][p] - flat0[p].float()).double()))
        for p in flat0}
    return {"losses": [o["loss"] for o in outs], "grad": grad,
            "change": change, "clock": outs[-1]["clock"],
            "comm": outs[-1]["comm"], "splits": [o["splits"] for o in outs]}


def split_points(n_units: int, k: int) -> tuple:
    """The K split points in the shallow half: n/8, n/4, n/2, filled up
    with the lowest free indices on shallow stacks (the method's default
    plan)."""
    fr = (0.125, 0.25, 0.5)[:k]
    pts = sorted({max(1, round(n_units * f)) for f in fr})
    nxt = 1
    while len(pts) < k and nxt <= n_units:
        if nxt not in pts:
            pts.append(nxt)
        nxt += 1
    return tuple(sorted(pts)[:k])


def readings(prog: dict, refr: dict) -> list:
    """[(name, value)] of the numbers ``correct`` compares."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                   refr["losses"]))
    grad, _ = leaf_gap(prog["grad"], refr["grad"], refr["grad"])
    change, _ = leaf_gap(prog["change"], refr["change"], refr["grad"])
    return [("loss_gap", loss), ("grad_gap", grad), ("change_gap", change),
            ("clock_gap", abs(prog["clock"] - refr["clock"])),
            ("bytes_gap", abs(prog["comm"] - refr["comm"]))]


def control_readings(cell, cfg, seed, device) -> list:
    """The control: the reference in float8 (e4m3, per-tensor scales) in
    the program's place, judged against the float32 reference."""
    cfg = dataclasses.replace(cfg, attn_impl=cell.mix["attn_impl"])
    data = traffic.federated_lm(cell.mix, seed)
    refr = reference_readings(cell, cfg, data, seed, device)
    ctrl = reference_readings(cell, cfg, data, seed, device, rnd=lm.fp8)
    return readings(ctrl, refr)


def compare(cell, cfg, data, seed, device, losses, grad_n, change_n, clock,
            comm):
    refr = reference_readings(cell, cfg, data, seed, device)
    prog = {"losses": losses, "grad": grad_n, "change": change_n,
            "clock": clock, "comm": comm}
    return ([Check(n, v, float(cell.limits[n])) for n, v in
             readings(prog, refr)], refr["splits"])
