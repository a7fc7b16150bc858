"""End-to-end S²FL training driver on PyTorch (the card by default).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch vgg16 \
      --mode s2fl --rounds 50 --alpha 0.5 --codec int8
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --arch resnet8 --rounds 3 --n-train 240 --clients 6

The parser is the reference trainer's, flag for flag. Flags whose
modules are later slices of the port (observability, fault injection,
checkpoints, the control plane, fleets, the vmapped server step, the LM
families) raise before any work is done; they are never ignored.
"""
from __future__ import annotations

import argparse
import json
import time

from repro_torch.configs import (CNNConfig, CommConfig, DriverConfig,
                                 get_config)
from repro_torch.core.engine import EngineConfig, S2FLEngine
from repro_torch.data.partition import federate
from repro_torch.data.synthetic import make_image_dataset
from repro_torch.models import SplitModel

# flags whose modules are not ported yet: any non-default value raises
NOT_PORTED = ("trace_out", "metrics_out", "metrics_every",
              "fused_server", "resource_aware", "batch_fracs",
              "auto_knobs", "fleet_size", "clusters", "cluster_quorum",
              "fault_plan", "fault_kill_prob", "fault_rejoin_prob",
              "fault_seed", "fault_server_policy",
              "fault_residual_policy", "checkpoint_every",
              "checkpoint_dir", "resume_from")


def build_data(cfg, *, n_train: int, n_test: int, n_clients: int, alpha,
               seed: int = 0):
    train = make_image_dataset(n_train, n_classes=cfg.n_classes,
                               image_size=cfg.image_size, seed=seed)
    test = make_image_dataset(n_test, n_classes=cfg.n_classes,
                              image_size=cfg.image_size, seed=seed + 1)
    fed = federate(train, n_clients, alpha=alpha, seed=seed)
    return fed, test, cfg.n_classes


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
    # observability (not yet ported)
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
                         "server backwards into one vmapped, donated "
                         "step (numerics may drift ~1e-4)")
    ap.add_argument("--gate-redispatch", action="store_true",
                    help="a device waits out its own draining download "
                         "before its next upload may start (off = the "
                         "semi-async queue's overcommit optimism); "
                         "only observable under --pipeline")
    # resource-aware control plane (not yet ported)
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
    # batched million-device fleets (not yet ported)
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
    # fault injection + restartable service loop (not yet ported)
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


def check_ported(ap: argparse.ArgumentParser, args) -> None:
    """Raise on every flag whose module is not ported yet."""
    bad = [f"--{k.replace('_', '-')}" for k in NOT_PORTED
           if getattr(args, k) != ap.get_default(k)]
    if args.scheduler == "joint":
        bad.append("--scheduler joint")
    if bad:
        raise NotImplementedError(
            f"{' '.join(bad)}: not yet ported (a later slice of the "
            f"port)")


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    check_ported(ap, args)
    cfg = get_config(args.arch)
    if not isinstance(cfg, CNNConfig):   # every LM arch, MoE / MLA too
        raise NotImplementedError(
            f"--arch {args.arch}: S²FL training of the LM families is not "
            f"yet ported (a later slice); serve it with "
            f"repro_torch.launch.serve")
    # --reduced is a no-op for the CNN families, as in the reference

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
                        gate_redispatch=args.gate_redispatch)
    ecfg = EngineConfig(
        mode=args.mode, rounds=args.rounds,
        clients_per_round=args.per_round, batch_size=args.batch_size,
        local_steps=args.local_steps, lr=args.lr, seed=args.seed,
        use_balance=not args.no_balance, use_sliding=not args.no_sliding,
        scheduler=args.scheduler, n_classes=cfg.n_classes, comm=ccfg,
        driver=dcfg, fused_comm=args.fused_comm)

    model = SplitModel(cfg)
    fed, test, _ = build_data(
        cfg, n_train=args.n_train, n_test=max(500, args.n_train // 8),
        n_clients=args.clients, alpha=args.alpha, seed=args.seed)
    eng = S2FLEngine(model, fed, ecfg, device=args.device)

    t0 = time.time()
    eng.run(rounds=args.rounds, eval_data=test,
            eval_every=args.eval_every, verbose=True)
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
