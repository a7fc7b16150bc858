"""The result's last line: its keys, which metrics a run reports, the
checks last; and a run without a card prints no result (CPU)."""
import json

import pytest

from portbench import run as run_mod
from portbench.cell import Check, Outcome, find_cell
from portbench.tracing import Trace

PREFILL = "prefill.deepseek-v2-lite-16b.f32w.b8x2048"
TRAIN = "s2fl_train.internlm2-1.8b.int8ef"
DEVICE = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
          "memory_peak_bytes": 1}


def _outcome(cfg, trace):
    tr = Trace(kernels=[("flash_fwd_wgmma_kernel", 0.0, 0.2),
                        ("void (anonymous namespace)::gmm_wgmma_kernel",
                         0.3, 0.4),
                        ("nvjet_tst_gemm", 0.75, 0.1),
                        ("elementwise_kernel", 0.9, 0.05)],
               ranges=[("request", 0.0, 1.0), ("moe", 0.7, 0.76)],
               window=(0.0, 1.0)) if trace else None
    return Outcome(
        e2e={"prefill_tokens_per_s": 30000.5, "ttft_p90_ms": 500.25},
        setup_s=20.125, attempted=16, failed=0,
        checks=[Check("logits_err", 0.01, 0.03),
                Check("cache_err", 0.02, 0.05)],
        memory_peak_bytes=1, trace=tr,
        context={"kind": "prefill", "cfg": cfg, "calls": 1, "batch": 8,
                 "prompt_len": 2048, "wall_s": 1.0})


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(trace):
    cell = find_cell(PREFILL)
    line = run_mod.result_line(cell, _outcome(cell.build_config(), trace),
                               trace, dict(DEVICE))
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert line["correct"] is True
    assert line["checks"]["logits_err"] == {"value": 0.01, "limit": 0.03}
    json.loads(json.dumps(line))
    if not trace:
        assert set(line["metrics"]) == {"prefill_tokens_per_s",
                                        "ttft_p90_ms", "setup_s"}
        assert line["metrics"]["setup_s"] == {"value": 20.125, "unit": "s"}
        assert "breakdown" not in line
    else:
        assert set(line["metrics"]) == {m["name"] for m in cell.per_layer}
        assert line["device"]["busy_s"] == pytest.approx(0.75)
        assert line["device"]["window_s"] == 1.0
        assert line["metrics"]["idle_share.prefill"]["value"] == \
            pytest.approx(25.0)
        b = line["breakdown"]
        assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
        assert dict(map(tuple, b["idle_gaps"]))["moe"] == pytest.approx(
            0.05)
        for name in ("flash_roofline.prefill", "moe_gmm_roofline.prefill"):
            assert 0 < line["metrics"][name]["value"] < 100


def test_a_reader_that_finds_nothing_reports_nothing():
    cell = find_cell(TRAIN)
    out = Outcome(e2e={"train_tokens_per_s": 1.0}, setup_s=1.0,
                  attempted=1, failed=0, checks=[], memory_peak_bytes=0,
                  trace=Trace(kernels=[], ranges=[], window=(0.0, 1.0)),
                  context={"kind": "train", "rounds": 1})
    line = run_mod.result_line(cell, out, True, dict(DEVICE))
    assert line["metrics"] == {} and line["correct"] is False


def test_no_card_no_result(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for machines "
                    "without one")
    rc = run_mod.main(["--workload", TRAIN, "--seed", str(2 ** 31 + 5),
                       "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc == 2 and out.out == "" and "CUDA" in out.err


def test_a_range_the_port_lacks_is_left_out_and_named():
    """A wrapped attribute that the port renamed loses its range, and
    the breakdown names it, without failing the run."""
    from portbench import tracing
    rec = tracing.Recorder()
    spec = (("portbench.yardstick", "kernel_group", "group"),
            ("portbench.yardstick", "no_such_function", "gone"),
            ("portbench.no_such_module", "f", "nowhere"))
    with tracing.ranges(spec, rec):
        from portbench import yardstick
        yardstick.kernel_group("nvjet_tst_gemm")
    assert rec.missing == ["gone", "nowhere"]
    assert [r[0] for r in rec.ranges] == ["group"]
    rec.mark = 0.0
    rec.ranges.append(("window", 0.0, 1.0))
    b = tracing.trace_of(None, rec).breakdown()
    assert b["missing_ranges"] == ["gone", "nowhere"]
    assert "missing_ranges" not in Trace(
        kernels=[], ranges=[], window=(0.0, 1.0)).breakdown()


def test_train_tokens_come_from_the_mix():
    from portbench.drivers import s2fl_train
    mix = find_cell(TRAIN).mix
    assert s2fl_train.round_tokens(mix) == 4 * 32 * 128 * 1
