"""Observability for the event pipeline: flight-level tracing
(``trace``), streaming metrics (``metrics``), Chrome trace-event export
(``export``) and per-window critical-path attribution (``critical``).

Everything is dependency-injected and default-off: build a
``Recorder``, pass it to ``RoundDriver``/``S2FLEngine`` (and set it on
the ``CommChannel``), and the driver's hooks populate it; without one
the hooks are dead branches and the simulated timeline is bit-exact
with the un-instrumented seed (golden-tested).
"""
from repro_torch.observe.critical import (summarize, verify_reconstruction,
                                    window_breakdown)
from repro_torch.observe.export import (chrome_trace, load_recorder,
                                  write_chrome_trace)
from repro_torch.observe.metrics import Histogram, JsonlSink, MetricsRegistry
from repro_torch.observe.trace import NullRecorder, Recorder, TraceRecorder

__all__ = [
    "TraceRecorder", "NullRecorder", "Recorder",
    "MetricsRegistry", "JsonlSink", "Histogram",
    "chrome_trace", "write_chrome_trace", "load_recorder",
    "window_breakdown", "summarize", "verify_reconstruction",
]
