"""The port's fault plans (core/faults.py) held against the reference's,
and a chaos run of the engine under one.

A ``FaultPlan.random`` from one seed gives the same events in both
packages, and either package reads the other's file. Under the plan, a
semi-async pipelined int8 run with error feedback on the golden config
(tests/torch_engine_golden.py) has the reference's exactly-once ledger
(dispatched, committed, abandoned, with work abandoned), clock, wire
bytes, splits and quarantined devices EXACTLY; losses and params within
1e-4 (measured, 1 and 8 CPU threads: 2.8e-5 / 2.1e-5 at most)."""
import dataclasses

import pytest

import repro.core.faults as ref_faults
import repro_torch.core.faults as port_faults
from torch_engine_golden import compare, run_pair

TOL = 1e-4


def _random(faults, **kw):
    return faults.FaultPlan.random(
        list(range(6)), 4, seed=11, kill_prob=0.3, rejoin_prob=0.6,
        mid_flight_frac=0.8, **kw)


def _events(plan):
    return [dataclasses.asdict(e) for e in plan.events]


@pytest.mark.parametrize("policies", [
    dict(server_policy="cancel", residual_policy="restore"),
    dict(server_policy="orphan", residual_policy="discard"),
])
def test_random_plan_matches_reference_and_round_trips(policies, tmp_path):
    ref, port = _random(ref_faults, **policies), _random(port_faults,
                                                         **policies)
    assert len(port) > 0 and _events(port) == _events(ref)
    assert port.to_dict() == ref.to_dict()
    for r in range(4):
        assert [dataclasses.asdict(e) for e in port.for_round(r)] \
            == [dataclasses.asdict(e) for e in ref.for_round(r)]
    port.to_file(str(tmp_path / "port.json"))
    ref.to_file(str(tmp_path / "ref.json"))
    assert (tmp_path / "port.json").read_text() \
        == (tmp_path / "ref.json").read_text()
    back = port_faults.FaultPlan.from_file(str(tmp_path / "ref.json"))
    assert back.to_dict() == port.to_dict()
    assert ref_faults.FaultPlan.from_file(
        str(tmp_path / "port.json")).to_dict() == ref.to_dict()


def test_invalid_events_raise_like_the_reference():
    for bad in (dict(round=-1, cid=0, kind="kill"),
                dict(round=0, cid=0, kind="explode"),
                dict(round=0, cid=0, kind="kill", at=1.5)):
        with pytest.raises(ValueError):
            ref_faults.FaultEvent(**bad)
        with pytest.raises(ValueError):
            port_faults.FaultEvent(**bad)


def test_chaos_run_matches_reference():
    ref, port = run_pair(
        rounds=4, comm={"codec": "int8", "error_feedback": True},
        driver={"exec_mode": "semi_async", "pipeline": True,
                "quorum": 0.5, "staleness_cap": 2},
        fault_plan=lambda FaultPlan: FaultPlan.random(
            list(range(6)), 4, seed=11, kill_prob=0.3, rejoin_prob=0.6,
            mid_flight_frac=0.8))
    rd, pd = ref.driver, port.driver
    assert (pd.n_dispatched, pd.n_committed, pd.n_abandoned) \
        == (rd.n_dispatched, rd.n_committed, rd.n_abandoned)
    assert pd.n_abandoned > 0                   # the plan bit
    assert pd.n_committed + pd.n_abandoned == pd.n_dispatched
    compare(ref, port, loss_tol=TOL, param_tol=TOL)
    assert set(port.channel._quarantine) == set(ref.channel._quarantine)
    assert set(port.channel._residuals) == set(ref.channel._residuals)
    assert abs(port.channel.ef_discarded_mass
               - ref.channel.ef_discarded_mass) <= 1e-6
