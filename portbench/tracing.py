"""The traced run: the profiler's device timeline over the window, host
ranges that the harness puts around calls into the port's layers, and
what the per-layer readers and the result's ``breakdown`` take from
them.

The profiler records the card's activity only (CUPTI): recording every
host-side op as well slowed the training loop's host threefold. Host
ranges are kept by the harness on ``time.perf_counter`` and put on the
trace's clock by one marker kernel launched as the trace opens. Ranges
are set by wrapping module attributes of the port from outside
(``ranges``), in the traced run only; an attribute the port no longer
has loses its range, and the ``breakdown`` names it under
``missing_ranges``, without failing the run. Spans inside the port's
functions are the port's own business (none exist yet).
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import time
from collections import defaultdict


@dataclasses.dataclass
class Trace:
    """Device kernels and host ranges of one traced window, times in
    seconds on the profiler's clock."""
    kernels: list            # [(name, start_s, dur_s)]
    ranges: list             # [(name, start_s, end_s)] host ranges
    window: tuple            # (start_s, end_s) of the traced window
    missing: tuple = ()      # ranges whose attribute the port lacks

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_intervals(self) -> list:
        """Merged intervals in which a kernel ran, clipped to the window."""
        lo, hi = self.window
        spans = sorted((max(s, lo), min(s + d, hi))
                       for _, s, d in self.kernels if s + d > lo and s < hi)
        merged = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def device_s_by(self, key) -> dict:
        """{key(name): device seconds} summed over the window's kernels."""
        lo, hi = self.window
        out = defaultdict(float)
        for name, s, dur in self.kernels:
            if lo <= s < hi:
                out[key(name)] += dur
        return dict(out)

    def idle_gaps(self) -> dict:
        """{host range: idle seconds}: each gap between busy intervals
        (and at the window's ends) goes to the innermost host range open
        at its midpoint, 'other' where none is."""
        lo, hi = self.window
        edges = [lo]
        for s, e in self.busy_intervals():
            edges += [s, e]
        edges.append(hi)
        out = defaultdict(float)
        for s, e in zip(edges[::2], edges[1::2]):
            if e <= s:
                continue
            mid = 0.5 * (s + e)
            inner = [r for r in self.ranges if r[1] <= mid < r[2]]
            name = max(inner, key=lambda r: r[1])[0] if inner else "other"
            out[name] += e - s
        return dict(out)

    def breakdown(self) -> dict:
        """The result's ``breakdown``: the 10 device operations that took
        most time and the 10 longest idle shares by host range."""
        ops = sorted(self.device_s_by(lambda n: n).items(),
                     key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.idle_gaps().items(), key=lambda kv: -kv[1])[:10]
        out = {"device_ops": [[n[:120], s] for n, s in ops],
               "idle_gaps": [[n, s] for n, s in gaps]}
        if self.missing:
            out["missing_ranges"] = list(self.missing)
        return out


class Recorder:
    """Host ranges on ``time.perf_counter``: the window, each request or
    round, and the wrapped layers' calls."""

    def __init__(self):
        self.ranges = []         # [(name, start, end)]
        self.mark = None         # host time of the marker kernel's launch
        self.missing = []        # ranges whose attribute was not found

    @contextlib.contextmanager
    def span(self, name):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.ranges.append((name, t, time.perf_counter()))


class _Off:
    """What an untraced run records: nothing."""

    @contextlib.contextmanager
    def span(self, name):
        yield


OFF = _Off()


ALLOCATOR_KEYS = ("num_alloc_retries", "num_ooms", "num_device_alloc",
                  "num_device_free")


def allocator_counts(device) -> dict:
    """The caching allocator's counts of retries, OOMs and calls to
    cudaMalloc / cudaFree so far (zeros off the card)."""
    import torch
    ms = (torch.cuda.memory_stats(device) if device.type == "cuda"
          else {})
    return {k: ms.get(k, 0) for k in ALLOCATOR_KEYS}


def _is_device(ev) -> bool:
    return "CUDA" in str(ev.device_type())


def trace_of(prof, rec: Recorder) -> Trace:
    """A Trace from a finished profile of the card's activity and the
    harness's host ranges (one of them named 'window'); the first
    kernel is the marker."""
    kernels = []
    if prof is not None:
        for ev in prof.profiler.kineto_results.events():
            if _is_device(ev):
                kernels.append((ev.name(), ev.start_ns() * 1e-9,
                                ev.duration_ns() * 1e-9))
    kernels.sort(key=lambda k: k[1])
    off = kernels[0][1] - rec.mark if kernels else 0.0
    kernels = kernels[1:]                      # the marker is not work
    ranges = [(n, s + off, e + off) for n, s, e in rec.ranges]
    window = next((s, e) for n, s, e in ranges if n == "window")
    return Trace(kernels=kernels,
                 ranges=[r for r in ranges if r[0] != "window"],
                 window=window, missing=tuple(rec.missing))


@contextlib.contextmanager
def traced(enabled: bool, spec=()):
    """Yields (recorder, profile): with ``enabled``, a Recorder whose
    spans and ``spec``'s wrapped attributes are recorded, and the
    profiler over the card's activity, opened with the marker kernel
    (None without a card); otherwise (OFF, None)."""
    if not enabled:
        yield OFF, None
        return
    import torch
    rec = Recorder()
    with ranges(spec, rec):
        if not torch.cuda.is_available():
            rec.mark = time.perf_counter()
            yield rec, None
            return
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            rec.mark = time.perf_counter()
            torch.zeros(1, device="cuda")      # the marker kernel
            torch.cuda.synchronize()
            yield rec, prof


@contextlib.contextmanager
def ranges(spec, rec):
    """Wrap each ``(module, attribute or Class.method, range name)`` of
    ``spec`` in a span of ``rec`` while the block runs, and put the
    attributes back after it; one that is not there is left out and its
    range name kept in ``rec.missing``."""
    saved = []
    try:
        for modname, path, name in spec:
            try:
                owner = importlib.import_module(modname)
                *outer, attr = path.split(".")
                for part in outer:             # a class's method
                    owner = getattr(owner, part)
                fn = getattr(owner, attr)
            except (ImportError, AttributeError):
                rec.missing.append(name)
                continue

            def wrapped(*a, _fn=fn, _name=name, **kw):
                with rec.span(_name):
                    return _fn(*a, **kw)
            saved.append((owner, attr, fn))
            setattr(owner, attr, wrapped)
        yield
    finally:
        for owner, attr, fn in reversed(saved):
            setattr(owner, attr, fn)
