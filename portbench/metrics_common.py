"""What several per-layer readers share: each reads ``run.trace`` (the
traced window) and ``run.context`` (the window's counts from ``drivers/``);
a reader that finds nothing to read returns None."""
from __future__ import annotations

from portbench import yardstick


def idle_share(run):
    tr = run.trace
    if tr is None or not tr.kernels:
        return None
    return yardstick.pct((tr.window_s - tr.busy_s) / tr.window_s)


def glue_ms(run, per: str):
    tr, n = run.trace, run.context.get(per)
    if tr is None or not tr.kernels or not n:
        return None
    by = tr.device_s_by(yardstick.kernel_group)
    return 1e3 * by.get("glue", 0.0) / n


def kernel_share(run, group: str, least_per_call: float):
    """The least time of the window's calls over the group's device
    time, %; None where the group ran no kernel."""
    tr, calls = run.trace, run.context.get("calls")
    if tr is None or not calls:
        return None
    dev = tr.device_s_by(yardstick.kernel_group).get(group, 0.0)
    if dev <= 0.0:
        return None
    return yardstick.pct(calls * least_per_call / dev)
