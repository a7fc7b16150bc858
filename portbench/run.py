"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout. It needs as many CUDA cards as the cell
asks for, and exits with code 2, printing no result, without them. It
loads the cell, draws the inputs and weights from the seed, warms up,
measures for ``--seconds``, checks what the window produced against the
plain reference, and prints, as the last line of standard output, one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``: each number compared beside its limit, which also end
standard error. It exits with code 3, printing no result, where the
process has loaded JAX or the JAX package.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from portbench import tracing  # noqa: E402
from portbench.cell import ROOT, find_cell, metric_reader  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unread ({e.__class__.__name__})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "unread"


def result_line(cell, outcome, trace: bool, device: dict) -> dict:
    metrics = {}
    if trace:
        for m in cell.per_layer:
            v = metric_reader(m["name"])(outcome)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = dict(outcome.e2e, setup_s=outcome.setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    out = {"correct": outcome.correct, "attempted": outcome.attempted,
           "failed": outcome.failed, "metrics": metrics, "device": device}
    if trace and outcome.trace is not None:
        tr = outcome.trace
        out["device"] = dict(device, busy_s=tr.busy_s, window_s=tr.window_s)
        out["breakdown"] = tr.breakdown()
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                     for c in outcome.checks}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = find_cell(args.workload)
    src = ROOT / "src"
    if str(src) not in sys.path:
        sys.path.insert(0, str(src))
    # the port builds its kernels inside the checkout (build/kernels/);
    # nothing here may load JAX through a library
    os.environ.setdefault("USE_FLAX", "0")
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: the cell needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    cfg = cell.build_config()
    outcome = cell.driver().run(cell, cfg, args.seed, args.seconds,
                                bool(args.trace), device, T_PROCESS)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the process loaded {bad}", file=sys.stderr)
        return 3
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": cell.chips,
           "memory_peak_bytes": outcome.memory_peak_bytes,
           "card": power_limit()}
    line = result_line(cell, outcome, bool(args.trace), dev)
    ctx = outcome.context
    for key, what in (("steps_s", "s a step"), ("steps_cpu_s",
                                                 "host cpu s a step")):
        steps = ctx.get(key, [])
        if steps:
            order = sorted(steps)
            print(f"window: {len(steps)} steps, {what} min {order[0]!r} "
                  f"median {order[len(order) // 2]!r} max {order[-1]!r}; "
                  f"in turn " + " ".join(f"{t:.3f}" for t in steps),
                  file=sys.stderr)
    counts = [("process", tracing.allocator_counts(device))]
    if "window_allocator" in ctx:
        counts.append(("window", ctx["window_allocator"]))
    for what, c in counts:
        print(f"allocator ({what}): "
              + " ".join(f"{k} {v}" for k, v in c.items()), file=sys.stderr)
    for c in outcome.checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
