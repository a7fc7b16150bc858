"""The port's observability (observe/{trace,metrics,critical,export}.py)
held against the reference's on one recorded run.

A pipelined semi-async run of the golden config
(tests/torch_engine_golden.py), int8 on the wire, with latency, link
contention and two server slots, recorded by each package's
``Recorder`` with a ``MetricsRegistry``: flights, atomics, windows,
gauges, counters, ``summarize``, the Chrome trace JSON and the metrics
snapshot are EXACTLY equal — everything there comes from the simulated
clock and the byte counts, which match exactly. Error feedback is off:
its residual-mass gauge is an L2 norm of tensors, a float of the
arithmetic, not of the clock. ``load_recorder`` round-trips."""
import json

import pytest

from torch_engine_golden import compare, run_pair
from repro_torch.observe import (JsonlSink, MetricsRegistry, Recorder,
                                 chrome_trace, load_recorder, summarize,
                                 verify_reconstruction, write_chrome_trace)


@pytest.fixture(scope="module")
def recorded():
    return run_pair(
        comm={"codec": "int8", "latency": 0.01, "uplink_capacity": 2.0e5,
              "downlink_capacity": 2.0e5},
        driver={"exec_mode": "semi_async", "pipeline": True,
                "server_concurrency": 2},
        recorder=lambda observe: observe.Recorder(
            metrics=observe.MetricsRegistry()))


def test_recorded_run_matches_reference(recorded):
    ref, port = recorded
    compare(ref, port, loss_tol=1e-4, param_tol=1e-4)
    rr, pr = ref.recorder, port.recorder
    assert isinstance(pr, Recorder)
    assert pr.flights and pr.windows
    assert pr.flights == rr.flights
    assert pr.atomics == rr.atomics
    assert pr.windows == rr.windows
    assert pr.gauges == rr.gauges
    assert pr.counters == rr.counters
    assert pr.metrics.snapshot() == rr.metrics.snapshot()
    assert pr.metrics.counter("comm.up.msgs") > 0   # channel hooks fired
    assert json.dumps(pr.to_json(), sort_keys=True) \
        == json.dumps(rr.to_json(), sort_keys=True)


def test_summaries_and_chrome_trace_match_reference(recorded):
    from repro.observe import chrome_trace as ref_chrome
    from repro.observe import summarize as ref_summarize
    from repro.observe import verify_reconstruction as ref_verify
    ref, port = recorded
    assert summarize(port.recorder) == ref_summarize(ref.recorder)
    assert verify_reconstruction(port.recorder) \
        == ref_verify(ref.recorder) <= 1e-6
    assert json.dumps(chrome_trace(port.recorder), sort_keys=True) \
        == json.dumps(ref_chrome(ref.recorder), sort_keys=True)


def test_load_recorder_round_trips(recorded, tmp_path):
    from repro.observe import load_recorder as ref_load
    _, port = recorded
    path = str(tmp_path / "trace.json")
    write_chrome_trace(port.recorder, path)
    back = load_recorder(path)
    assert back.to_json() == port.recorder.to_json()
    assert summarize(back) == summarize(port.recorder)
    # the reference reads the port's trace file as its own
    assert ref_load(path).to_json() == port.recorder.to_json()


def test_metrics_registry_and_sink_match_reference(tmp_path):
    from repro.observe import JsonlSink as RefSink
    from repro.observe import MetricsRegistry as RefRegistry
    regs = (MetricsRegistry(), RefRegistry())
    for reg in regs:
        reg.inc("a", 2.0)
        reg.set_gauge("g", 1.5, t=3.0)
        for v in (0.3, 1.0, 7.0, 1e3):
            reg.observe("h", v)
    assert regs[0].snapshot() == regs[1].snapshot()
    paths = [tmp_path / "port.jsonl", tmp_path / "ref.jsonl"]
    for sink_cls, reg, path in zip((JsonlSink, RefSink), regs, paths):
        with sink_cls(str(path)) as sink:
            sink.emit({"kind": "round", "metrics": reg.snapshot()})
            sink.emit({"kind": "summary"})
    assert paths[0].read_text() == paths[1].read_text()
    assert len(paths[0].read_text().splitlines()) == 2
