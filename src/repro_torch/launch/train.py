"""End-to-end S²FL training driver on PyTorch (the card by default).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch vgg16 \
      --mode s2fl --rounds 50 --alpha 0.5 --codec int8
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --arch resnet8 --rounds 3 --n-train 240 --clients 6
  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \
      --rounds 2 --clients 8 --per-round 4 --codec int8 --error-feedback
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --arch internlm2-1.8b --reduced --rounds 2 --n-train 120 --seq-len 16

The parser is the reference trainer's, flag for flag, and every flag
works on the CNN and the LM families. An LM trains on the plain
(differentiable) attention, SSM and expert paths, ``attn_impl="xla"``
as in the reference; ``--reduced`` cuts an LM config to its CPU-sized
variant (``make_reduced``) and leaves a CNN as it is.

Restartable service loop: ``--checkpoint-every N`` snapshots the FULL
training state (model + driver timeline + channel + scheduler + rng —
checkpoint/state.py) every N rounds into ``--checkpoint-dir``; a
crashed run resumes with ``--resume-from <snapshot.npz>`` and replays
the remaining rounds bit-exactly on the fp32 sync path (on the CPU).
``--fault-plan`` / ``--fault-kill-prob`` arm churn injection
(core/faults.py) for chaos drills against the same loop.
"""
from __future__ import annotations

import argparse
import json
import os
import time

from repro_torch.configs import (CommConfig, DriverConfig, get_config,
                                 make_reduced)
from repro_torch.core.engine import EngineConfig, S2FLEngine
from repro_torch.data.partition import federate
from repro_torch.data.synthetic import make_image_dataset, make_lm_dataset
from repro_torch.models import SplitModel


def build_data(cfg, *, n_train: int, n_test: int, n_clients: int, alpha,
               seq_len: int, seed: int = 0):
    if getattr(cfg, "arch_type", "") == "cnn" or hasattr(cfg, "family"):
        train = make_image_dataset(n_train, n_classes=cfg.n_classes,
                                   image_size=cfg.image_size, seed=seed)
        test = make_image_dataset(n_test, n_classes=cfg.n_classes,
                                  image_size=cfg.image_size, seed=seed + 1)
        n_classes = cfg.n_classes
    else:
        vocab = min(cfg.vocab_size, 256)
        train = make_lm_dataset(n_train, seq_len=seq_len, vocab=vocab,
                                seed=seed)
        test = make_lm_dataset(n_test, seq_len=seq_len, vocab=vocab,
                               seed=seed + 1)
        n_classes = 10
    fed = federate(train, n_clients, alpha=alpha, seed=seed)
    return fed, test, n_classes


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the models train; cuda raises when no "
                         "card is there (no fallback to the CPU)")
    ap.add_argument("--arch", default="resnet8")
    ap.add_argument("--mode", default="s2fl",
                    choices=["s2fl", "sfl", "fedavg"])
    ap.add_argument("--rounds", type=int, default=50)
    ap.add_argument("--clients", type=int, default=20)
    ap.add_argument("--per-round", type=int, default=5)
    ap.add_argument("--alpha", type=float, default=None,
                    help="Dirichlet alpha; omit for IID")
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--local-steps", type=int, default=1)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--n-train", type=int, default=4000)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced model variant (CPU-friendly)")
    ap.add_argument("--no-balance", action="store_true")
    ap.add_argument("--no-sliding", action="store_true")
    ap.add_argument("--eval-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--history-out", default=None,
                    help="dump engine.history (per-round records) as "
                         "JSON to this path")
    # observability (repro_torch.observe)
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome trace-event JSON of the run "
                         "(open in https://ui.perfetto.dev); also "
                         "embeds the full recorder dump for "
                         "benchmarks/trace_report.py")
    ap.add_argument("--metrics-out", default=None,
                    help="stream one JSON line per emission (round "
                         "record + live metrics snapshot) to this "
                         "path — the long-running-service feed")
    ap.add_argument("--metrics-every", type=int, default=1,
                    help="emit a metrics line every N rounds "
                         "(with --metrics-out)")
    # transport (repro_torch.comm)
    codecs = ["fp32", "bf16", "fp16", "int8", "topk", "randk"]
    ap.add_argument("--codec", "--uplink-codec", dest="codec",
                    default="fp32", choices=codecs,
                    help="uplink feature codec")
    ap.add_argument("--grad-codec", "--downlink-codec", dest="grad_codec",
                    default="", choices=[""] + codecs,
                    help="downlink dfx codec (default: same as --codec)")
    ap.add_argument("--dispatch-codec", default="fp32", choices=codecs,
                    help="model-leg codec: Wc dispatch/collect (and the "
                         "FedAvg broadcast + QSGD-style update upload); "
                         "fp32 = the seed's uncompressed legs")
    ap.add_argument("--error-feedback", action="store_true",
                    help="per-(device, tensor) residual accumulators: "
                         "compression error is added back before the "
                         "next round's encode")
    ap.add_argument("--topk-frac", type=float, default=0.1,
                    help="kept fraction for the topk/randk sparsifiers")
    ap.add_argument("--link-trace", default="",
                    help="JSON LinkTrace file (default: static Table-1)")
    ap.add_argument("--latency", type=float, default=0.0,
                    help="per-message link latency in seconds (four "
                         "messages per device-round)")
    ap.add_argument("--latency-dist", default="constant",
                    choices=["constant", "uniform", "lognormal", "exp"],
                    help="per-(device, round) latency distribution "
                         "around the --latency mean (deterministic "
                         "draw per device-round)")
    ap.add_argument("--latency-jitter", type=float, default=0.5,
                    help="spread of the non-constant latency "
                         "distributions (uniform half-width / "
                         "lognormal sigma, as a fraction of the mean)")
    ap.add_argument("--latency-seed", type=int, default=0,
                    help="seed of the latency draw stream")
    ap.add_argument("--contention", type=float, default=0.0,
                    help="shared Main-Server uplink capacity in Table-1 "
                         "elements/s (0 = uncontended); concurrent "
                         "uploads contend for it under --pipeline")
    ap.add_argument("--downlink-contention", type=float, default=0.0,
                    help="shared Main-Server downlink (egress) capacity "
                         "in Table-1 elements/s (0 = uncontended); "
                         "concurrent dfx downloads contend for it "
                         "under --pipeline")
    # round loop (repro_torch.core.driver)
    ap.add_argument("--exec-mode", default="sync",
                    choices=["sync", "semi_async"],
                    help="round clock: Eq.-1 barrier vs event-queue "
                         "straggler overlap")
    ap.add_argument("--staleness-cap", type=int, default=1,
                    help="semi_async: max rounds an update may lag "
                         "(0 degenerates to sync)")
    ap.add_argument("--quorum", type=float, default=0.5,
                    help="semi_async: arrival fraction that closes the "
                         "aggregation window")
    ap.add_argument("--predictive", action="store_true",
                    help="sliding scheduler forecasts the link rate at "
                         "the projected completion time")
    ap.add_argument("--pipeline", action="store_true",
                    help="phase-level event pipeline: upload / server "
                         "compute / download phases overlap across "
                         "devices and groups")
    ap.add_argument("--server-slots", type=int, default=0,
                    help="max concurrent group backwards on the Main "
                         "Server GPU (FIFO queue; 0 = unbounded); only "
                         "observable under --pipeline")
    ap.add_argument("--fused-comm", action="store_true",
                    help="flush each direction's whole cohort through "
                         "one fused kernel call (comm/fused.py): bytes "
                         "metered bit-equal to the sequential path, "
                         "tensors within 1e-6")
    ap.add_argument("--fused-server", action="store_true",
                    help="stack same-signature concurrent groups' "
                         "server backwards into one vmapped step "
                         "(numerics may drift ~1e-4)")
    ap.add_argument("--gate-redispatch", action="store_true",
                    help="a device waits out its own draining download "
                         "before its next upload may start (off = the "
                         "semi-async queue's overcommit optimism); "
                         "only observable under --pipeline")
    # resource-aware control plane (core/control.py)
    ap.add_argument("--resource-aware", action="store_true",
                    help="price candidate splits against live driver "
                         "state (server queue depth, fluid-link "
                         "backlogs, draining flows, learned horizon "
                         "band) instead of the link model's mean rate")
    ap.add_argument("--scheduler", default="median",
                    choices=["median", "mintime", "joint"],
                    help="split policy: paper median matching, "
                         "per-device mintime, or joint split x batch-"
                         "fraction tuning (joint needs "
                         "--resource-aware to price fractions)")
    ap.add_argument("--batch-fracs", default="",
                    help="comma list of candidate batch fractions for "
                         "--scheduler joint (default 1.0,0.75,0.5)")
    ap.add_argument("--auto-knobs", action="store_true",
                    help="probe nearby (quorum, staleness_cap) pairs "
                         "and lock the fastest (semi-async only)")
    # batched million-device fleets (core/fleet.py)
    ap.add_argument("--fleet-size", type=int, default=0,
                    help="simulate this many devices as batched (P,) "
                         "population tables: cohorts are fleet-sampled "
                         "each round and Device objects materialize "
                         "only for sampled cids (0 = the object grid "
                         "sized by --clients)")
    ap.add_argument("--clusters", type=int, default=0,
                    help="edge clusters for hierarchical aggregation "
                         "(devices -> clusters -> main server); <= 1 "
                         "keeps the flat aggregation window")
    ap.add_argument("--cluster-quorum", type=float, default=1.0,
                    help="per-cluster close quantile: each cluster "
                         "closes at this fraction of its members' "
                         "arrivals, then --quorum applies over the "
                         "cluster close times")
    # fault injection + restartable service loop (core/faults.py,
    # checkpoint/state.py)
    ap.add_argument("--fault-plan", default="",
                    help="JSON FaultPlan file of seeded kill/rejoin "
                         "events (core/faults.py to_file format)")
    ap.add_argument("--fault-kill-prob", type=float, default=0.0,
                    help="random-process churn: per-round kill "
                         "probability per alive device (> 0 generates "
                         "a seeded FaultPlan; ignored with "
                         "--fault-plan)")
    ap.add_argument("--fault-rejoin-prob", type=float, default=0.5,
                    help="per-round rejoin probability per dead device "
                         "(random-process churn)")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed of the random fault process")
    ap.add_argument("--fault-server-policy", default="cancel",
                    choices=["cancel", "orphan"],
                    help="a dead device's server job: 'cancel' frees "
                         "the slot at the kill instant, 'orphan' lets "
                         "an already-fed backward run to completion "
                         "(result dropped either way)")
    ap.add_argument("--fault-residual-policy", default="restore",
                    choices=["restore", "discard"],
                    help="a rejoining device's quarantined "
                         "error-feedback residuals: restored, or "
                         "discarded with their L2 mass metered")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="snapshot the FULL training state every N "
                         "rounds into --checkpoint-dir (0 = off)")
    ap.add_argument("--checkpoint-dir", default="checkpoints",
                    help="where --checkpoint-every writes "
                         "round<NNNNN>.npz snapshots")
    ap.add_argument("--resume-from", default="",
                    help="resume a crashed/stopped run from a "
                         "checkpoint/state.py snapshot; the remaining "
                         "rounds replay bit-exactly on the fp32 sync "
                         "path")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced and not hasattr(cfg, "family"):
        cfg = make_reduced(cfg)
    model = SplitModel(cfg)
    fed, test, n_classes = build_data(
        cfg, n_train=args.n_train, n_test=max(500, args.n_train // 8),
        n_clients=args.clients, alpha=args.alpha, seq_len=args.seq_len,
        seed=args.seed)

    ccfg = CommConfig(codec=args.codec, grad_codec=args.grad_codec,
                      dispatch_codec=args.dispatch_codec,
                      error_feedback=args.error_feedback,
                      topk_frac=args.topk_frac,
                      link="trace" if args.link_trace else "static",
                      trace_file=args.link_trace, latency=args.latency,
                      latency_dist=args.latency_dist,
                      latency_jitter=args.latency_jitter,
                      latency_seed=args.latency_seed,
                      uplink_capacity=args.contention,
                      downlink_capacity=args.downlink_contention)
    dcfg = DriverConfig(exec_mode=args.exec_mode,
                        staleness_cap=args.staleness_cap,
                        quorum=args.quorum, predictive=args.predictive,
                        pipeline=args.pipeline,
                        server_concurrency=args.server_slots,
                        gate_redispatch=args.gate_redispatch,
                        resource_aware=args.resource_aware,
                        auto_knobs=args.auto_knobs,
                        fleet_size=args.fleet_size,
                        clusters=args.clusters,
                        cluster_quorum=args.cluster_quorum)
    fracs = tuple(float(f) for f in args.batch_fracs.split(",")
                  if f.strip()) if args.batch_fracs else ()
    ecfg = EngineConfig(
        mode=args.mode, rounds=args.rounds,
        clients_per_round=args.per_round, batch_size=args.batch_size,
        local_steps=args.local_steps, lr=args.lr, seed=args.seed,
        use_balance=not args.no_balance, use_sliding=not args.no_sliding,
        scheduler=args.scheduler, batch_fracs=fracs,
        n_classes=n_classes, comm=ccfg, driver=dcfg,
        fused_comm=args.fused_comm, fused_server=args.fused_server)

    # churn: an explicit plan file wins; otherwise a seeded random
    # process over the federation's cids (deterministic per seed, so a
    # resumed run sees the identical schedule)
    fault_plan = None
    if args.fault_plan:
        from repro_torch.core.faults import FaultPlan
        fault_plan = FaultPlan.from_file(args.fault_plan)
    elif args.fault_kill_prob > 0:
        from repro_torch.core.faults import FaultPlan
        fault_plan = FaultPlan.random(
            sorted(fed), args.rounds, seed=args.fault_seed,
            kill_prob=args.fault_kill_prob,
            rejoin_prob=args.fault_rejoin_prob,
            server_policy=args.fault_server_policy,
            residual_policy=args.fault_residual_policy)

    # observability: one recorder feeds the driver's flight/window
    # hooks, the channel's wire counters, and (when streaming) the live
    # metrics registry — absent flags, nothing is built and every hook
    # stays a dead branch
    recorder, registry, sink = None, None, None
    if args.trace_out or args.metrics_out:
        from repro_torch.observe import JsonlSink, MetricsRegistry, Recorder
        registry = MetricsRegistry() if args.metrics_out else None
        recorder = Recorder(metrics=registry)
        if args.metrics_out:
            sink = JsonlSink(args.metrics_out)

    eng = S2FLEngine(model, fed, ecfg, recorder=recorder,
                     fault_plan=fault_plan, device=args.device)

    # service loop: resume restores the FULL state (history included —
    # its length is the next round index) and replays the remainder
    start_round = 0
    if args.resume_from:
        from repro_torch.checkpoint import restore_run_state
        restore_run_state(args.resume_from, eng)
        start_round = len(eng.history)
        print(f"== resumed {args.resume_from} at round {start_round} ==")

    emitted = 0

    def on_round(rec):
        nonlocal emitted
        if sink is not None \
                and rec["round"] % max(args.metrics_every, 1) == 0:
            sink.emit({"kind": "round", **rec,
                       "metrics": registry.snapshot()})
            emitted += 1
        done = rec["round"] + 1
        if args.checkpoint_every and done % args.checkpoint_every == 0:
            from repro_torch.checkpoint import save_run_state
            os.makedirs(args.checkpoint_dir, exist_ok=True)
            path = os.path.join(args.checkpoint_dir,
                                f"round{done:05d}.npz")
            save_run_state(path, eng)
            print(f"  checkpoint   {path}")

    t0 = time.time()
    eng.run(rounds=max(args.rounds - start_round, 0), eval_data=test,
            eval_every=args.eval_every, verbose=True, on_round=on_round)
    final = eng.evaluate(test)
    wall = time.time() - t0

    summary = {
        "mode": args.mode, "arch": args.arch, "rounds": args.rounds,
        "clients": args.clients, "per_round": args.per_round,
        "device": str(eng.device),
        "final_loss": final["loss"], "final_acc": final["acc"],
        "sim_clock_s": eng.clock, "comm_bytes": eng.comm,
        "dispatched": eng.driver.n_dispatched,
        "committed": eng.driver.n_committed,
        "abandoned": eng.driver.n_abandoned,
        "wall_s": wall,
    }
    print("== run summary ==")
    for k, v in summary.items():
        if isinstance(v, float):
            print(f"  {k:<12} {v:.6g}")
        else:
            print(f"  {k:<12} {v}")

    if sink is not None:
        sink.emit({"kind": "summary", **summary,
                   "metrics": registry.snapshot()})
        sink.close()
        print(f"  metrics      {args.metrics_out} "
              f"({emitted + 1} records)")
    if args.trace_out:
        from repro_torch.observe import summarize, write_chrome_trace
        write_chrome_trace(recorder, args.trace_out)
        crit = summarize(recorder)
        print(f"  trace        {args.trace_out} "
              f"({len(recorder.flights)} flights, "
              f"{crit['windows']} windows, "
              f"top straggler {crit['top_straggler']})")
    if args.history_out:
        with open(args.history_out, "w") as f:
            json.dump(eng.history, f, indent=1)
        print(f"  history      {args.history_out}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"history": eng.history, "final": final,
                       "clock": eng.clock, "comm": eng.comm,
                       "summary": summary}, f, indent=1)


if __name__ == "__main__":
    main()
