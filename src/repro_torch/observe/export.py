"""Chrome trace-event export — load the file in Perfetto
(https://ui.perfetto.dev) or ``chrome://tracing`` and see the pipelined
round: one track per device (client pre/post compute), one lane-packed
track group each for the shared uplink, the server slots, and the shared
downlink, window spans on a timeline track, and counter tracks for every
gauge the recorder sampled.

The format is the JSON Object Format of the Trace Event spec:
``{"traceEvents": [...]}`` with "X" (complete) events carrying ``ts`` /
``dur`` in microseconds and "M" (metadata) events naming processes and
threads. Extra top-level keys are explicitly allowed, so the full
recorder dump rides along under ``"s2fl"`` — one artifact is both
human-viewable and machine-readable (``benchmarks/trace_report.py``
reads it back via ``Recorder.from_json``).
"""
from __future__ import annotations

import json
import math

# process ids = track groups (Perfetto renders one group per pid)
PID_TIMELINE = 0
PID_DEVICES = 1
PID_UPLINK = 2
PID_SERVER = 3
PID_DOWNLINK = 4

_US = 1e6          # simulated seconds -> trace microseconds


def _lanes(spans):
    """Greedy lane assignment for overlapping [start, end) spans:
    each span takes the lowest lane that is free at its start. Returns
    the spans' lane indices (in input order)."""
    order = sorted(range(len(spans)), key=lambda i: spans[i][0])
    free: list = []            # lane -> last end
    out = [0] * len(spans)
    for i in order:
        s, e = spans[i]
        for lane, busy_until in enumerate(free):
            if busy_until <= s + 1e-12:
                free[lane] = e
                out[i] = lane
                break
        else:
            out[i] = len(free)
            free.append(e)
    return out


def _x(name, pid, tid, t0, t1, args=None):
    ev = {"name": name, "ph": "X", "pid": pid, "tid": tid,
          "ts": t0 * _US, "dur": max(t1 - t0, 0.0) * _US, "cat": "s2fl"}
    if args:
        ev["args"] = args
    return ev


def _meta(pid, tid, what, name):
    return {"name": what, "ph": "M", "pid": pid, "tid": tid,
            "args": {"name": name}}


def _fin(*xs):
    return all(isinstance(x, (int, float)) and math.isfinite(x)
               for x in xs)


def chrome_trace(rec) -> dict:
    """Recorder -> Trace Event JSON object (Perfetto-loadable)."""
    events = [
        _meta(PID_TIMELINE, 0, "process_name", "timeline"),
        _meta(PID_DEVICES, 0, "process_name", "devices"),
        _meta(PID_UPLINK, 0, "process_name", "uplink"),
        _meta(PID_SERVER, 0, "process_name", "server"),
        _meta(PID_DOWNLINK, 0, "process_name", "downlink"),
        _meta(PID_TIMELINE, 0, "thread_name", "aggregation windows"),
    ]

    # -- aggregation windows on the timeline track
    for w in rec.windows:
        events.append(_x(f"window r{w['round']}"
                         + (" (flush)" if w["kind"] == "flush" else ""),
                         PID_TIMELINE, 0, w["t0"], w["t_close"],
                         {"committed": len(w["committed"]),
                          "pending": w["pending"]}))

    # -- per-device client compute + atomic lumps
    flights = sorted(rec.flights.values(), key=lambda f: f["uid"])
    cids = sorted({f["cid"] for f in flights}
                  | {c for a in rec.atomics for c in a["cids"]}, key=str)
    tid_of = {c: i for i, c in enumerate(cids)}
    for c, tid in tid_of.items():
        events.append(_meta(PID_DEVICES, tid, "thread_name",
                            f"device {c}"))
    for fl in flights:
        tid = tid_of[fl["cid"]]
        r = fl["round"]
        if _fin(fl["dispatch"], fl["up_start"]):
            events.append(_x(f"pre r{r}", PID_DEVICES, tid,
                             fl["dispatch"], fl["up_start"]))
        if _fin(fl["dl_xfer_end"], fl["dl_end"]):
            events.append(_x(f"post r{r}", PID_DEVICES, tid,
                             fl["dl_xfer_end"], fl["dl_end"]))
    for a in rec.atomics:
        for c in a["cids"]:
            events.append(_x(f"round r{a['round']}", PID_DEVICES,
                             tid_of[c], a["start"], a["end"],
                             {"key": str(a["key"])}))

    # -- lane-packed resource tracks: uplink flows, server jobs,
    #    contended downlink transfers
    def _resource(pid, label, spans):
        if not spans:
            return
        lanes = _lanes([(s, e) for s, e, *_ in spans])
        for lane in range(max(lanes) + 1):
            events.append(_meta(pid, lane, "thread_name",
                                f"{label} {lane}"))
        for (s, e, name, args), lane in zip(spans, lanes):
            events.append(_x(name, pid, lane, s, e, args))

    _resource(PID_UPLINK, "flow", [
        (f["up_start"], f["up_end"],
         f"up c{f['cid']} r{f['round']}",
         {"bytes": f["up_bytes"]})
        for f in flights if _fin(f["up_start"], f["up_end"])])
    _resource(PID_SERVER, "slot", [
        (f["srv_start"], f["srv_end"],
         f"srv c{f['cid']} r{f['round']}", None)
        for f in flights if _fin(f["srv_start"], f["srv_end"])])
    _resource(PID_DOWNLINK, "flow", [
        (f["srv_end"], f["dl_xfer_end"],
         f"down c{f['cid']} r{f['round']}", None)
        for f in flights
        if _fin(f["srv_end"], f["dl_xfer_end"])
        and f["dl_xfer_end"] > f["srv_end"] + 1e-12])

    # -- gauge time series as counter tracks
    for name, samples in sorted(rec.gauges.items()):
        for t, v in samples:
            events.append({"name": name, "ph": "C", "pid": PID_TIMELINE,
                           "tid": 0, "ts": t * _US,
                           "args": {"value": v}})

    return {"traceEvents": events, "displayTimeUnit": "ms",
            "s2fl": rec.to_json()}


def write_chrome_trace(rec, path: str) -> dict:
    doc = chrome_trace(rec)
    with open(path, "w") as f:
        json.dump(doc, f)
    return doc


def load_recorder(path: str):
    """Read a trace file written by ``write_chrome_trace`` back into a
    ``Recorder`` (via the embedded ``"s2fl"`` dump)."""
    from repro_torch.observe.trace import Recorder
    with open(path) as f:
        doc = json.load(f)
    if "s2fl" not in doc:
        raise ValueError(f"{path}: no embedded s2fl recorder dump")
    return Recorder.from_json(doc["s2fl"])
