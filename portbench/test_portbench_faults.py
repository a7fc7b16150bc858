"""A run's ``correct`` at a size the CPU holds, through ``drivers/`` with
everything but the look for a card: true for the port as it is, false
for the control and for each planted fault of the cell's kind. The
limits are the cells' own (``limits/<workload>.json``)."""
import dataclasses
import time

import pytest
import torch

from portbench import faults
from portbench.cell import Check, find_cell

DEV = torch.device("cpu")
TRAIN = "s2fl_train.internlm2-1.8b.int8ef"
PREFILLS = ["prefill.deepseek-v2-lite-16b.f32w.b8x2048",
            "prefill.internlm2-1.8b.b16x2048"]


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _small(workload):
    from repro_torch.configs import make_reduced
    cell = find_cell(workload)
    cfg = cell.build_config()
    if cell.mix["kind"] == "s2fl_train":
        cfg = make_reduced(cfg, n_layers=8, d_model=256)
        cell.mix = dict(cell.mix, sequences=160, seq_len=16, batch=8)
    else:
        cfg = make_reduced(cfg, n_layers=2, d_model=256)
        cell.mix = dict(cell.mix, batch=4, prompt_len=128,
                        distinct_batches=4)
    return cell, dataclasses.replace(cfg, dtype="bfloat16")


def _run(workload, seed, step=None):
    cell, cfg = _small(workload)
    return cell, cell.driver().run(cell, cfg, seed, 0.05, False, DEV,
                                   time.perf_counter(), break_step=step)


@pytest.mark.parametrize("workload", [TRAIN] + PREFILLS)
def test_the_port_is_correct(workload):
    _, out = _run(workload, 2 ** 31 + 11)
    assert out.correct, out.checks


@pytest.mark.parametrize("workload,fault", [
    *[(TRAIN, f) for f in faults.TRAIN],
    *[(w, f) for w in PREFILLS for f in faults.PREFILL]])
def test_a_planted_fault_is_not_correct(workload, fault):
    kind = find_cell(workload).mix["kind"]
    _, out = _run(workload, 2 ** 31 + 13, faults.BY_KIND[kind][fault])
    assert not out.correct, out.checks


@pytest.mark.parametrize("workload", [TRAIN] + PREFILLS)
def test_the_control_is_not_correct(workload):
    cell, cfg = _small(workload)
    values = cell.driver().control_readings(cell, cfg, 2 ** 31 + 17, DEV)
    checks = [Check(n, v, float(cell.limits[n])) for n, v in values]
    assert not all(c.ok for c in checks), checks
