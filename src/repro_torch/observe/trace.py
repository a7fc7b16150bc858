"""Flight-level tracing of the event pipeline.

``TraceRecorder`` is the protocol the ``RoundDriver``'s (and
``CommChannel``'s) observability hooks talk to — and simultaneously the
no-op default: every method is a ``pass``, so a driver built without a
recorder (or with the base class) pays nothing and the bit-exact
clock/comm goldens are untouched. ``Recorder`` is the recording
implementation; it captures

  * one **flight record** per pipelined device-round, upserted on every
    round's resource re-solve (latest estimate wins — exactly the
    semantics of the driver's own ``_Flight`` revisions, so once a
    flight's window has closed its record is final).  Span schema (all
    absolute simulated seconds):

        dispatch      phase start (round dispatch clock + gate wait)
        up_start      uplink flow submitted  (= dispatch + t_pre)
        up_end        uplink flow finished (fluid max-min fair solve)
        srv_start     server-compute start (= srv_end - t_srv; the gap
                      up_end → srv_start is FIFO queue wait)
        srv_end       the COMMIT event
        dl_xfer_end   contended dfx transfer landed
        dl_end        download fully drained (client bwd + Wc collect)

  * **atomic records** for device-rounds that do not phase-decompose
    (the non-pipelined path, FedAvg baselines): one (start, end) lump
    per work key;
  * one **window record** per aggregation window (and one per
    ``flush()``): dispatch clock, close clock, committed keys with
    their staleness, events still pending;
  * **gauge samples** (server-queue depth, per-direction link
    utilization and live-flow counts, window staleness, error-feedback
    residual mass, …) and **counters** (messages/bytes per channel
    direction, fluid-solve calls, …).

``critical.py`` turns these records into per-window critical-path
decompositions; ``export.py`` turns them into a Chrome trace-event
(Perfetto-loadable) JSON. ``to_json``/``from_json`` round-trip the full
recorder state, which is how a trace file carries everything the
``benchmarks/trace_report.py`` summarizer needs.
"""
from __future__ import annotations

import numbers


def _jsonable(x):
    """Coerce work keys / cids (possibly numpy scalars, tuples) to
    JSON-safe values that still compare equal after a round-trip."""
    if isinstance(x, bool) or x is None or isinstance(x, str):
        return x
    if isinstance(x, numbers.Integral):
        return int(x)
    if isinstance(x, numbers.Real):
        return float(x)
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    return str(x)


class TraceRecorder:
    """The hook protocol AND the zero-overhead default. Driver /
    channel hook sites guard on ``recorder is not None and
    recorder.enabled``, so with the default recorder (or none at all)
    not even the argument dicts are built."""

    enabled = False

    def flight(self, uid, **fields):
        """Upsert the span record of pipelined flight ``uid``."""

    def atomic(self, key, round, cids, start, end):  # noqa: A002
        """One non-decomposed (atomic Eq.-1) work item."""

    def window(self, round, t0, t_close, committed, pending,  # noqa: A002
               kind="round"):
        """One aggregation window (``kind='flush'`` for the shutdown
        drain). ``committed``: {work key: staleness in rounds}."""

    def gauge(self, name, t, value):
        """Sample a time-series gauge at simulated time ``t``."""

    def count(self, name, n=1.0):
        """Increment a monotone counter."""


NullRecorder = TraceRecorder


class Recorder(TraceRecorder):
    """The recording implementation. Pass ``metrics=`` a
    ``MetricsRegistry`` to additionally forward every gauge sample and
    counter increment into the streaming-metrics registry."""

    enabled = True

    def __init__(self, metrics=None):
        self.flights: dict = {}      # uid -> span record (upserted)
        self.atomics: list = []      # non-decomposed work items
        self.windows: list = []      # aggregation windows, in order
        self.gauges: dict = {}       # name -> [(t, value), ...]
        self.counters: dict = {}     # name -> total
        self.metrics = metrics

    # ------------------------------------------------------------ hooks
    def flight(self, uid, **fields):
        rec = self.flights.setdefault(uid, {"uid": uid})
        rec.update(fields)

    def atomic(self, key, round, cids, start, end):  # noqa: A002
        self.atomics.append({"key": key, "round": round,
                             "cids": list(cids),
                             "start": start, "end": end})

    def window(self, round, t0, t_close, committed, pending,  # noqa: A002
               kind="round"):
        self.windows.append({"round": round, "t0": t0,
                             "t_close": t_close,
                             "committed": dict(committed),
                             "pending": pending, "kind": kind})

    def gauge(self, name, t, value):
        self.gauges.setdefault(name, []).append((t, value))
        if self.metrics is not None:
            self.metrics.set_gauge(name, value, t)

    def count(self, name, n=1.0):
        self.counters[name] = self.counters.get(name, 0.0) + n
        if self.metrics is not None:
            self.metrics.inc(name, n)

    # ---------------------------------------------------------- persist
    def to_json(self) -> dict:
        """JSON-safe dump of the full recorder state (work keys and
        cids coerced; committed dicts stored as pair lists)."""
        return {
            "flights": [
                {k: _jsonable(v) for k, v in fl.items()}
                for _, fl in sorted(self.flights.items())],
            "atomics": [{k: _jsonable(v) for k, v in a.items()}
                        for a in self.atomics],
            "windows": [
                {"round": w["round"], "t0": w["t0"],
                 "t_close": w["t_close"], "pending": w["pending"],
                 "kind": w["kind"],
                 "committed": [[_jsonable(k), int(s)]
                               for k, s in w["committed"].items()]}
                for w in self.windows],
            "gauges": {k: [[t, v] for t, v in vs]
                       for k, vs in self.gauges.items()},
            "counters": dict(self.counters),
        }

    @classmethod
    def from_json(cls, doc: dict) -> "Recorder":
        rec = cls()
        for fl in doc.get("flights", ()):
            fl = dict(fl, key=_key(fl.get("key")))
            rec.flights[fl["uid"]] = fl
        rec.atomics = [dict(a, key=_key(a.get("key")))
                       for a in doc.get("atomics", ())]
        rec.windows = [
            {"round": w["round"], "t0": w["t0"],
             "t_close": w["t_close"], "pending": w["pending"],
             "kind": w.get("kind", "round"),
             "committed": {_key(k): s for k, s in w["committed"]}}
            for w in doc.get("windows", ())]
        rec.gauges = {k: [(t, v) for t, v in vs]
                      for k, vs in doc.get("gauges", {}).items()}
        rec.counters = dict(doc.get("counters", {}))
        return rec


def _key(k):
    """JSON arrays came back as lists; keys must be hashable again."""
    return tuple(k) if isinstance(k, list) else k
