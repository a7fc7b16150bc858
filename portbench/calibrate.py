"""Readings that set a cell's limits of ``correct``, on the card at the
cell's own size (not run by the benchmark's runs):

    python3 -m portbench.calibrate --workload <name> --seeds 1,2,3 \\
        [--control-seeds 4,5,6] [--faults 7,8,9] [--fault-names a,b] \
        [--seconds 2]

For each of ``--seeds`` one run of the cell with a short window gives the
program's readings (the lower end of each limit); for each of
``--control-seeds`` the control (the reference in float8 in the
program's place) and for each of ``--faults`` every planted fault of
the cell's kind (or those of ``--fault-names``) give the upper end. One
JSON line each; all in one process, so that the kernels are built once.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from portbench import faults  # noqa: E402
from portbench.cell import ROOT, find_cell  # noqa: E402


def _seeds(s: str) -> list:
    return [int(x) for x in s.split(",") if x.strip()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-names", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = find_cell(args.workload)
    # limits are what is being set: report every reading
    cell.limits = {k: float("inf") for k in cell.limits}
    cfg = cell.build_config()
    drv = cell.driver()

    def emit(kind, seed, values, **extra):
        print(json.dumps({"workload": args.workload, "kind": kind,
                          "seed": seed, "readings": dict(values), **extra}),
              flush=True)

    def sound(seed, name="program", step=None):
        t = time.perf_counter()
        out = drv.run(cell, cfg, seed, args.seconds, False, device, t,
                      break_step=step)
        emit(name, seed, [(c.name, c.value) for c in out.checks],
             e2e=out.e2e, setup_s=out.setup_s,
             peak=out.memory_peak_bytes)
        del out
        gc.collect()
        torch.cuda.empty_cache()

    for seed in _seeds(args.seeds):
        sound(seed)
    for seed in _seeds(args.control_seeds):
        emit("control", seed, drv.control_readings(cell, cfg, seed, device))
        gc.collect()
        torch.cuda.empty_cache()
    planted = faults.BY_KIND[cell.mix["kind"]]
    names = [n for n in args.fault_names.split(",") if n] or list(planted)
    for seed in _seeds(args.faults):
        for name in names:
            sound(seed, "fault:" + name, planted[name])
    return 0


if __name__ == "__main__":
    sys.exit(main())
