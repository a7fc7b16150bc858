"""The port's control plane (core/control.py, observe/history.py) held
against the live reference.

Engine runs on the golden config (tests/torch_engine_golden.py):
``resource_aware`` forecasts, ``scheduler="joint"`` with batch
fractions, and ``auto_knobs`` under ``semi_async``. Clock, wire bytes
and every round's chosen splits and batch fractions are EXACTLY equal;
losses and params within 1e-4 (measured: 6.0e-7 / 5.2e-6 at most). The
aggregation controller's settings, lock, rejections and every
round-time field of ``export_state()`` are exactly equal; its loss
fields (sums of the per-round losses) within 1e-4.

Unit checks: the driver's ``RoundTimeTracker`` and ``ResourceView``, and
``resource_aware_forecast`` for every device and split, on one driver
trace that both packages replay from the same analytic costs."""
import numpy as np
import pytest

from torch_engine_golden import compare, run_pair

TOL = 1e-4


def _controller_equal(ref_kc, port_kc):
    rs, ps = ref_kc.export_state(), port_kc.export_state()
    assert set(rs) == set(ps)
    for k in rs:
        if k in ("loss_sums", "last_loss"):
            r = np.asarray(rs[k], dtype=float)
            p = np.asarray(ps[k], dtype=float)
            assert np.array_equal(np.isnan(r), np.isnan(p)), k
            assert np.nanmax(np.abs(r - p), initial=0.0) <= TOL, k
        else:
            assert ps[k] == rs[k], k
    assert port_kc.settings == ref_kc.settings
    assert port_kc.locked == ref_kc.locked
    assert port_kc.rejected == ref_kc.rejected


SEMI = {"exec_mode": "semi_async", "pipeline": True}


@pytest.mark.parametrize("name,kw", [
    ("resource_aware", dict(driver={**SEMI, "resource_aware": True,
                                    "server_concurrency": 1}, rounds=5)),
    ("joint", dict(driver={**SEMI, "resource_aware": True},
                   scheduler="joint", batch_fracs=(1.0, 0.75, 0.5),
                   rounds=5)),
])
def test_control_plane_matches_reference(name, kw):
    ref, port = run_pair(**kw)
    compare(ref, port, loss_tol=TOL, param_tol=TOL)
    if name == "joint":
        # past the warm-up the fractions were priced and one was taken
        assert any(f != 1.0 for _, fr in port.rounds for f in fr.values())
    assert port.driver._history.export_state() \
        == ref.driver._history.export_state()


def test_auto_knobs_match_reference():
    """17 rounds: four settings probed four windows each, then locked."""
    ref, port = run_pair(driver={"exec_mode": "semi_async",
                                 "auto_knobs": True}, rounds=17)
    compare(ref, port, loss_tol=TOL, param_tol=TOL)
    _controller_equal(ref.driver.knob_controller,
                      port.driver.knob_controller)
    assert port.driver.knob_controller.locked is not None
    assert (port.driver.quorum, port.driver.staleness_cap) \
        == (ref.driver.quorum, ref.driver.staleness_cap)


# --------------------------------------------------------------- units
def _driver_pair(seed):
    """The same resource-aware pipelined driver in both packages, run
    for 4 rounds on the same cohorts."""
    import repro.comm as rcomm
    import repro.core.driver as rdrv
    import repro.core.scheduler as rsch
    import repro.core.simulation as rsim
    import repro.core.split as rsplit
    import repro_torch.comm as tcomm
    import repro_torch.core.driver as tdrv
    import repro_torch.core.scheduler as tsch
    import repro_torch.core.simulation as tsim
    import repro_torch.core.split as tsplit

    rng = np.random.default_rng(seed)
    costs = {s: dict(wc_size=float(rng.uniform(1e4, 2e6)),
                     feat_size=float(rng.uniform(1e2, 2e4)),
                     fc=float(rng.uniform(1e7, 3e9)),
                     fs=float(rng.uniform(1e7, 3e9))) for s in (1, 2, 4)}
    cohorts = [sorted(rng.choice(6, size=4, replace=False).tolist())
               for _ in range(4)]
    out = []
    for comm, drv, sch, sim, split in (
            (rcomm, rdrv, rsch, rsim, rsplit),
            (tcomm, tdrv, tsch, tsim, tsplit)):
        plan = split.SplitPlan(n_units=8, split_points=(1, 2, 4))
        devices = sim.make_device_grid(6, seed=seed)
        ch = comm.CommChannel(codec="fp32", uplink_capacity=2e5,
                              downlink_capacity=2e5)
        d = drv.RoundDriver(sch.MinTimeScheduler(plan),
                            drv.AnalyticCost(ch, costs, p=32), devices,
                            mode="semi_async", pipeline=True, quorum=0.5,
                            staleness_cap=1, resource_aware=True,
                            server_concurrency=1, gate_redispatch=True)
        for c in cohorts:
            d.run_round([devices[i] for i in c])
        out.append((d, devices))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_history_and_view_and_forecast_match_reference(seed):
    from repro.core.control import resource_aware_forecast as ref_fc
    from repro_torch.core.control import resource_aware_forecast as port_fc
    (rd, rdev), (pd, pdev) = _driver_pair(seed)
    assert pd.clock == rd.clock
    rh, ph = rd._history, pd._history
    assert ph.export_state() == rh.export_state()
    for dev in rdev:
        assert ph.band(dev.cid) == rh.band(dev.cid)
        assert ph.ema_of(dev.cid) == rh.ema_of(dev.cid)
        assert ph.quantile(dev.cid, 0.9) == rh.quantile(dev.cid, 0.9)
    rv, pv = rd.view, pd.view
    assert pv.server_depth() == rv.server_depth()
    assert pv.uplink_backlog() == rv.uplink_backlog()
    assert pv.downlink_backlog() == rv.downlink_backlog()
    assert pv.gated == rv.gated and pv.server_slots == rv.server_slots
    for r_dev, p_dev in zip(rdev, pdev):
        c = r_dev.cid
        assert pv.busy_until(c) == rv.busy_until(c)
        assert pv.last_split(c) == rv.last_split(c)
        assert pv.horizon_band(c, 1.0) == rv.horizon_band(c, 1.0)
        for s in (1, 2, 4):
            for frac in (1.0, 0.5):
                assert port_fc(pv, pd.cost, p_dev, s, 1.0, frac=frac) \
                    == ref_fc(rv, rd.cost, r_dev, s, 1.0, frac=frac)
    pd.flush()
    rd.flush()
    assert pd.clock == rd.clock


def test_controller_unit_trace_matches_reference():
    """The same round times and losses fed to both controllers."""
    from repro.core.control import AggregationController as Ref
    from repro.core.control import default_knob_grid as ref_grid
    from repro_torch.core.control import AggregationController as Port
    from repro_torch.core.control import default_knob_grid as port_grid
    assert port_grid(0.5, 1) == ref_grid(0.5, 1)
    rng = np.random.default_rng(4)
    ref, port = Ref(ref_grid(0.5, 1)), Port(port_grid(0.5, 1))
    loss = 3.0
    for _ in range(20):
        t = float(rng.uniform(0.5, 2.0))
        loss += float(rng.uniform(-0.3, 0.1))
        for kc in (ref, port):
            kc.observe(t)
            kc.observe_loss(loss)
        assert port.current() == ref.current()
    assert port.export_state() == ref.export_state()
    clone = Port(port_grid(0.5, 1))
    clone.restore_state(port.export_state())
    assert clone.export_state() == port.export_state()
