"""Streaming metrics — a small counters / gauges / histograms registry
with a JSONL sink.

The registry is deliberately tiny (no labels, no exposition format): a
name maps to one counter (monotone float), one gauge (last value + the
simulated time it was sampled at), or one histogram (count / sum / min /
max + power-of-two bucket counts). ``snapshot()`` returns a plain dict,
and ``JsonlSink`` appends one JSON object per line to a file — the
long-running-service shape: ``launch/train.py --metrics-out m.jsonl
--metrics-every N`` emits a merged (round record + registry snapshot)
line every N rounds, so a tail -f / ingestion pipeline sees live
progress without waiting for the run to finish.

A ``trace.Recorder`` built with ``metrics=registry`` forwards every
gauge sample and counter increment it receives from the driver hooks
into the registry, so the same hook feeds both the flight-level trace
and the streaming metrics.
"""
from __future__ import annotations

import json
import math


class Histogram:
    """Power-of-two bucketed histogram of positive-ish values (values
    <= 0 land in the underflow bucket ``"-inf"``)."""

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.buckets: dict = {}      # bucket exponent (str) -> count

    def observe(self, value: float):
        v = float(value)
        self.count += 1
        self.total += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        b = "-inf" if v <= 0.0 else str(int(math.floor(math.log2(v))))
        self.buckets[b] = self.buckets.get(b, 0) + 1

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def to_dict(self) -> dict:
        return {"count": self.count, "sum": self.total,
                "min": self.min if self.count else None,
                "max": self.max if self.count else None,
                "mean": self.mean, "buckets": dict(self.buckets)}


class MetricsRegistry:
    """Counters (monotone), gauges (last value wins) and histograms,
    keyed by plain string names. All operations are O(1) upserts."""

    def __init__(self):
        self._counters: dict = {}
        self._gauges: dict = {}      # name -> (value, t)
        self._histos: dict = {}

    # ------------------------------------------------------------ write
    def inc(self, name: str, n: float = 1.0):
        self._counters[name] = self._counters.get(name, 0.0) + float(n)

    def set_gauge(self, name: str, value: float, t: float = None):
        self._gauges[name] = (float(value),
                              float(t) if t is not None else None)

    def observe(self, name: str, value: float):
        if name not in self._histos:
            self._histos[name] = Histogram()
        self._histos[name].observe(value)

    # ------------------------------------------------------------- read
    def counter(self, name: str) -> float:
        return self._counters.get(name, 0.0)

    def gauge(self, name: str):
        """(value, sample_time) or None when never set."""
        return self._gauges.get(name)

    def snapshot(self) -> dict:
        """Plain-dict view of everything in the registry — what the
        JSONL stream carries per emission."""
        return {
            "counters": dict(self._counters),
            "gauges": {k: {"value": v, "t": t}
                       for k, (v, t) in self._gauges.items()},
            "histograms": {k: h.to_dict() for k, h in self._histos.items()},
        }


class JsonlSink:
    """Append-one-JSON-object-per-line sink with per-record flush, so a
    reader following the file sees each record as soon as it is
    emitted (the streaming contract of the service mode)."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "w")
        self.emitted = 0

    def emit(self, record: dict):
        self._f.write(json.dumps(record) + "\n")
        self._f.flush()
        self.emitted += 1

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
