"""Critical-path extraction: where did each aggregation window's
wall-clock go?

Every window closes on the ready time of some committed event (or does
not advance the clock at all) — see ``RoundDriver._close_window``.
``window_breakdown`` finds that *critical* event among the window's
committed keys, walks the flight record behind it, and decomposes the
window makespan ``t_close - t0`` into additive components:

    dispatch_lag     critical flight's dispatch minus the window's
                     dispatch clock — gate wait (>= 0) for this round's
                     flights, NEGATIVE for a carried straggler that was
                     dispatched in an earlier window
    client_pre       Wc dispatch transfer + client forward (+ latency)
    uplink_xfer      feature payload at the device's OWN link rate
    uplink_wait      extra time the fluid max-min fair schedule charged
                     on the shared ingress (contention stall)
    queue_wait       FIFO wait for a free server slot
    server_compute   the group-backward share (ends at the COMMIT)
    downlink_drain   commit -> download fully drained; nonzero only
                     when the window closed on a download (the flush
                     drain), since downloads never gate round windows
    atomic           the whole lump, for non-decomposed events
    unattributed     makespan with no matching record (should not
                     happen for recorded runs; kept as an honest
                     fallback rather than a silent zero)

The components sum to the makespan *exactly* (floating-point assoc
aside) — the reconstruction property ``tests/test_observe.py`` asserts
on the reference (``tests/test_torch_observe.py`` holds the port's
records to it) at 1e-6 relative tolerance over randomized (uplink, downlink, slots,
latency-dist) regimes. ``summarize`` aggregates the per-window rows
into component totals/fractions and per-device straggler attribution —
the columns ``benchmarks/sweeps.py`` and ``benchmarks/trace_report.py``
surface.
"""
from __future__ import annotations

COMPONENTS = ("dispatch_lag", "client_pre", "uplink_xfer", "uplink_wait",
              "queue_wait", "server_compute", "downlink_drain", "atomic",
              "unattributed")


def flight_components(fl: dict) -> dict:
    """Additive phase decomposition of one flight record, dispatch →
    commit (``downlink_drain`` is appended by the caller only when the
    critical event is the download end, not the commit)."""
    up_xfer = (fl["up_bytes"] / fl["up_rate"]) if fl["up_bytes"] else 0.0
    return {
        "client_pre": fl["t_pre"],
        "uplink_xfer": up_xfer,
        "uplink_wait": (fl["up_end"] - fl["up_start"]) - up_xfer,
        "queue_wait": fl["srv_start"] - fl["up_end"],
        "server_compute": fl["srv_end"] - fl["srv_start"],
    }


def _index(rec):
    """(dispatch round, work key) -> flight records / atomic record."""
    flights: dict = {}
    for fl in rec.flights.values():
        flights.setdefault((fl["round"], fl["key"]), []).append(fl)
    atomics = {(a["round"], a["key"]): a for a in rec.atomics}
    return flights, atomics


def _critical_event(w, flights, atomics):
    """The committed event whose ready time closed the window: among
    the window's committed keys (dispatch round = window round minus
    staleness), the one with the latest commit; for flush windows a
    draining download may be the closer instead."""
    best = None                      # (ready, kind, record)
    for key, stale in w["committed"].items():
        r_d = w["round"] - stale
        cand = None
        fls = flights.get((r_d, key))
        if fls:
            fl = max(fls, key=lambda f: f["srv_end"])
            cand = (fl["srv_end"], "flight", fl)
        a = atomics.get((r_d, key))
        if a is not None and (cand is None or a["end"] > cand[0]):
            # a group may mix pipelined flights with atomic members
            # (e.g. a cost model that only phase-decomposes some
            # devices) — the later ready wins, exactly as the driver's
            # group max does
            cand = (a["end"], "atomic", a)
        if cand is not None and (best is None or cand[0] > best[0]):
            best = cand
    if w["kind"] == "flush":
        # the flush clock waits out draining downloads too — any
        # flight's download end may exceed every commit
        for fls in flights.values():
            for fl in fls:
                if fl["dl_end"] <= w["t_close"] + 1e-12 and (
                        best is None or fl["dl_end"] > best[0]):
                    best = (fl["dl_end"], "drain", fl)
    return best


def window_breakdown(rec) -> list:
    """One row per recorded window: round, t0/t_close, makespan, the
    critical device/key, and the additive component decomposition
    (``sum(components) == makespan`` up to float association)."""
    flights, atomics = _index(rec)
    rows = []
    for w in rec.windows:
        mk = w["t_close"] - w["t0"]
        row = {"round": w["round"], "kind": w["kind"], "t0": w["t0"],
               "t_close": w["t_close"], "makespan": mk,
               "n_committed": len(w["committed"]),
               "critical_cid": None, "critical_key": None,
               "components": {}}
        tol = 1e-9 * max(abs(w["t_close"]), 1.0)
        if mk > tol:
            best = _critical_event(w, flights, atomics)
            if best is None or abs(best[0] - w["t_close"]) > 1e-6 * max(
                    abs(w["t_close"]), 1.0):
                row["components"] = {"unattributed": mk}
            else:
                _, kind, ev = best
                if kind == "atomic":
                    row["critical_key"] = ev["key"]
                    row["critical_cid"] = (ev["cids"][0]
                                           if len(ev["cids"]) == 1
                                           else None)
                    row["components"] = {
                        "dispatch_lag": ev["start"] - w["t0"],
                        "atomic": ev["end"] - ev["start"]}
                else:
                    comp = flight_components(ev)
                    comp["dispatch_lag"] = ev["dispatch"] - w["t0"]
                    comp["downlink_drain"] = (
                        ev["dl_end"] - ev["srv_end"]
                        if kind == "drain" else 0.0)
                    row["critical_cid"] = ev["cid"]
                    row["critical_key"] = ev["key"]
                    row["components"] = comp
        row["reconstructed"] = sum(row["components"].values())
        rows.append(row)
    return rows


def verify_reconstruction(rec, rel: float = 1e-6) -> float:
    """Max relative reconstruction error over all windows (raises
    AssertionError when any window exceeds ``rel``) — the acceptance
    property, also asserted by the benchmark surfaces so a trace that
    stops reconstructing fails loudly."""
    worst = 0.0
    for row in window_breakdown(rec):
        scale = max(abs(row["makespan"]), 1.0)
        err = abs(row["reconstructed"] - row["makespan"]) / scale
        worst = max(worst, err)
        assert err <= rel, (row, err)
    return worst


def summarize(rec) -> dict:
    """Aggregate the per-window rows: total/fractional time per
    component across all windows, per-device straggler counts (how
    often each device's flight was the critical one), and the worst
    reconstruction error."""
    rows = window_breakdown(rec)
    totals = {}
    stragglers: dict = {}
    straggler_time: dict = {}
    total_mk = 0.0
    worst = 0.0
    for row in rows:
        total_mk += row["makespan"]
        scale = max(abs(row["makespan"]), 1.0)
        worst = max(worst,
                    abs(row["reconstructed"] - row["makespan"]) / scale)
        for k, v in row["components"].items():
            totals[k] = totals.get(k, 0.0) + v
        cid = row["critical_cid"]
        if cid is not None and row["makespan"] > 0.0:
            stragglers[cid] = stragglers.get(cid, 0) + 1
            straggler_time[cid] = straggler_time.get(cid, 0.0) \
                + row["makespan"]
    fractions = {k: (v / total_mk if total_mk > 0 else 0.0)
                 for k, v in totals.items()}
    top = max(straggler_time, key=straggler_time.get) \
        if straggler_time else None
    return {"windows": len(rows), "total_makespan": total_mk,
            "totals": totals, "fractions": fractions,
            "stragglers": stragglers, "straggler_time": straggler_time,
            "top_straggler": top, "max_reconstruction_err": worst}
