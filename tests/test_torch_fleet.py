"""The port's batched population tables (core/fleet.py) held against the
reference's: the Table-1 tables bit for bit, the seeded cohort draws
under churn and diurnal availability, the state round trip, the tables
as tensors, and a fleet engine run (10 000 devices in 4 edge clusters)
whose clock, wire bytes and every round's splits are EXACTLY the
reference's; losses and params within 1e-4 (measured: 2.4e-7 /
8.5e-7)."""
import json

import numpy as np
import pytest
import torch

from repro.core.fleet import Fleet as RefFleet
from repro_torch.core.fleet import Fleet
from torch_engine_golden import compare, run_pair

TABLES = ("comp", "rate", "phase", "residual_mass")
CHURN = dict(churn_kill_prob=0.08, churn_rejoin_prob=0.4, diurnal_period=6,
             diurnal_duty=0.8)


@pytest.mark.parametrize("n,composition", [(1000, None),
                                           (257, {"high": 5, "mid": 3,
                                                  "low": 2})])
def test_table1_is_bit_equal_to_reference(n, composition):
    ref = RefFleet.table1(n, seed=5, composition=composition, clusters=4)
    port = Fleet.table1(n, seed=5, composition=composition, clusters=4)
    for k in TABLES:
        a, b = getattr(ref, k), getattr(port, k)
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    assert [port.cluster_of(c) for c in range(20)] \
        == [ref.cluster_of(c) for c in range(20)]
    for c in (0, 7, n - 1):
        p, r = port.device(c), ref.device(c)
        assert (p.cid, p.comp, p.rate) == (r.cid, r.comp, r.rate)


def test_sample_cohort_matches_reference_under_churn():
    ref = RefFleet.table1(500, seed=13, **CHURN)
    port = Fleet.table1(500, seed=13, **CHURN)
    for r in range(10):
        assert port.sample_cohort(r, 20) == ref.sample_cohort(r, 20)
        assert port.dead_set() == ref.dead_set()
    assert np.array_equal(port.availability_mask(10),
                          ref.availability_mask(10))
    assert port.export_state() == ref.export_state()


def test_state_round_trip_replays_identical_trace():
    mk = lambda: Fleet.table1(500, seed=13, **CHURN)
    a = mk()
    for r in range(6):
        a.sample_cohort(r, 20)
    a.note_residual(17, 123.5)
    st = json.loads(json.dumps(a.export_state()))
    b = mk()
    b.restore_state(st)
    assert b.dead_set() == a.dead_set()
    assert b.residual_mass[17] == 123.5
    for r in range(6, 12):
        assert a.sample_cohort(r, 20) == b.sample_cohort(r, 20)
    # the reference restores the port's state and draws the same trace
    ref = RefFleet.table1(500, seed=13, **CHURN)
    ref.restore_state(st)
    c = mk()
    c.restore_state(st)
    for r in range(6, 12):
        assert ref.sample_cohort(r, 20) == c.sample_cohort(r, 20)
    with pytest.raises(ValueError):
        Fleet.table1(10, seed=13).restore_state(st)  # population mismatch


def test_as_torch_equals_the_numpy_tables():
    fleet = Fleet.table1(300, seed=2, **CHURN)
    fleet.note_residual(3, 2.5)
    out = fleet.as_torch("cpu")
    assert set(out) == set(TABLES)
    for k in TABLES:
        t = out[k]
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        assert np.array_equal(t.numpy(), getattr(fleet, k))


def test_fleet_engine_matches_reference():
    ref, port = run_pair(driver={"fleet_size": 10_000, "clusters": 4})
    assert port.fleet is not None and port.devices == []
    compare(ref, port, loss_tol=1e-4, param_tol=1e-4)
    # fleet cids fold onto the six federated shards
    assert any(c not in port.data for sp, _ in port.rounds for c in sp)
    assert port.fleet.export_state() == ref.fleet.export_state()
