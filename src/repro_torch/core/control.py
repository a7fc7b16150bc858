"""Resource-aware control plane: price candidate splits against the
simulator's actual physics instead of a naive link-rate model.

The blind predictive forecast (``AnalyticCost.forecast_time``) sees one
number — the link's mean rate over the projected window, capped by
``capacity / cohort`` — and nothing else. But the world it schedules
into is stateful (PR 5–8): a finite FIFO server queue, duplex
``FluidLink`` contention with cross-window in-flight carry, re-dispatch
gating, and error-feedback residual state a re-split would discard.
This module closes the loop:

``ResourceView``
    a READ-ONLY window onto the live ``RoundDriver`` state — server
    queue depth (``_ServerQueue.depth_at``), per-direction link backlog
    and live-flow counts (``FluidLink.backlog_at``), each device's own
    draining downloads (``_dev_busy``), its last dispatched split, its
    error-feedback residual mass, and the observed per-device
    round-time history (``observe.history.RoundTimeTracker``). Queries
    that re-solve a fluid schedule are cached per (round, clock) so a
    round's whole candidate sweep pays for one solve.

``resource_aware_forecast``
    the forecast formula (see src/repro/core/README.md §Control plane):

        T(s) = gate_wait                      # own draining download
             + t_pre(s)                       # Wc leg + client fwd
             + up(s) / min(r, C_up/(L+A)) + B_up / C_up
             + ahead · (d̄ + t_srv(s)) / slots + t_srv(s)
             + down(s) / min(r, C_dn/(L+A')) + B_dn / C_dn
             + behind · down(s) / C_dn        # downlink externality
             + t_post(s)                      # client bwd + Wc collect

    with r the link's mean rate over the projected horizon, L the
    cohort size, A/B the live-flow count and backlog bytes already
    draining on the shared link, ahead = depth + (L-1)/2 the jobs
    expected to share the server queue, and d̄ their mean live
    duration. The ``ahead · t_srv(s) / slots`` piece is marginal-cost
    (Pigouvian) pricing of the FIFO slot — the delay the candidate's
    own service time imposes on the jobs behind it — which is what
    makes a cohort of per-device argmins drain a contended server
    instead of piling onto it (every other live-state term is a
    split-independent constant that can never move an argmin). The
    symmetric ``behind · down(s) / C_dn`` term prices the shared-egress
    externality the same way: the candidate's dfx payload backlogs the
    behind = A' + (L-1)/2 flows draining the downlink with it. The
    horizon is learned from the observed round-time distribution: the
    tracker's (q_lo, EMA, q_hi) band is priced and the WORST case
    taken, so a fade inside the uncertainty band moves the selection
    before it is ever observed. A candidate split that differs from the
    device's last dispatched one additionally prices the error-feedback
    residual elements a re-split would discard as extra uplink bytes.

``AggregationController``
    AdaptSFL/HASFL-style aggregation-frequency tuning: deterministic
    successive probing over a small (quorum, staleness_cap) grid,
    locking the argmin-mean-round-time setting among candidates whose
    observed per-round loss delta does not regress more than
    ``loss_tol`` past the configured anchor's (the engine feeds each
    round's training loss via ``observe_loss`` — time-only scoring
    would happily lock a window that commits nothing). The driver
    applies it at round start under a safety rule (the cap never drops
    below the age of the oldest pending event, so the staleness
    invariant holds through a downward change).
"""
from __future__ import annotations

import math

from repro_torch.comm.channel import MESSAGES_PER_ROUND
from repro_torch.core.simulation import (BYTES_PER_ELEM, CLIENT_FWD_FRAC,
                                   SERVER_FLOPS)


class ResourceView:
    """Read-only view over a ``RoundDriver``'s live resource state.

    Never mutates anything: every query goes through observational
    methods (``depth_at``, ``backlog_at``) or plain attribute reads.
    Built by the driver when ``resource_aware=True`` and handed to the
    forecast; also usable directly (tests, diagnostics)."""

    def __init__(self, driver, history=None):
        self._drv = driver
        self.history = history
        self._cache_key = None     # (round, clock) the caches are for
        self._cache: dict = {}

    # ------------------------------------------------------ basic state
    @property
    def clock(self) -> float:
        return self._drv.clock

    @property
    def cohort_load(self) -> int:
        """Devices sharing the uplink this round (driver's ``_load``)."""
        return self._drv._load

    @property
    def gated(self) -> bool:
        return self._drv.gate_redispatch

    @property
    def server_slots(self) -> float:
        return self._drv.server_concurrency or math.inf

    def busy_until(self, cid) -> float:
        """When the device's own latest download finishes draining
        (0.0 = idle). With ``gate_redispatch`` its next upload cannot
        start before this."""
        return self._drv._dev_busy.get(cid, 0.0)

    def last_split(self, cid):
        """Split the device was last dispatched with (None = never)."""
        return self._drv._last_split.get(cid)

    def draining_flights(self, cid) -> list:
        """The device's own live flights (in-flight uploads/backwards/
        downloads from earlier windows)."""
        return [fl for fl in self._drv._flights.values()
                if fl.cid == cid]

    # ----------------------------------------------- cached link state
    def _cached(self, name, fn):
        key = (self._drv.round, self._drv.clock)
        if self._cache_key != key:
            self._cache_key = key
            self._cache = {}
        if name not in self._cache:
            self._cache[name] = fn()
        return self._cache[name]

    def server_depth(self) -> int:
        """Jobs arrived but unfinished on the server at the current
        clock (waiting + running)."""
        q = self._drv._srvq
        if q is None:
            return 0
        return self._cached("srv_depth",
                            lambda: q.depth_at(self._drv.clock))

    def server_mean_duration(self, default: float) -> float:
        """Mean duration of the jobs still live in the server queue —
        the queue-wait unit the forecast charges per job ahead
        (``default`` when the queue is empty or absent)."""
        q = self._drv._srvq
        if q is None or not q._live:
            return default
        def _mean():
            durs = [q._dur[j] for j in q._live]
            return sum(durs) / len(durs)
        return self._cached("srv_mean_dur", _mean)

    def uplink_backlog(self):
        """(live flow count, bytes still in flight) on the shared
        ingress at the current clock — (0, 0.0) when uncontended or
        before the first pipelined round."""
        return self._cached("up_backlog",
                            lambda: self._link_backlog(self._drv._uplink))

    def downlink_backlog(self):
        return self._cached("dn_backlog",
                            lambda: self._link_backlog(self._drv._downlink))

    def _link_backlog(self, link):
        if link is None or not link.contended or not len(link):
            return 0, 0.0
        return link.backlog_at(self._drv.clock)

    def uplink_utilization(self, t0: float, t1: float) -> float:
        link = self._drv._uplink
        return 0.0 if link is None else link.utilization(t0, t1)

    def downlink_utilization(self, t0: float, t1: float) -> float:
        link = self._drv._downlink
        return 0.0 if link is None else link.utilization(t0, t1)

    # -------------------------------------------------- channel signals
    def residual_elements(self, cid) -> float:
        """Error-feedback residual elements the device currently holds
        on the channel — the mass a re-split would discard (residuals
        reset on a cut-layer shape change)."""
        ch = getattr(self._drv.cost, "channel", None)
        if ch is None or not getattr(ch, "error_feedback", False):
            return 0.0
        fn = getattr(ch, "residual_elements_of", None)
        return 0.0 if fn is None else fn(cid)

    # ------------------------------------------------- learned horizon
    def horizon_band(self, cid, fallback: float):
        """(lo, mid, hi) forecast-horizon band for the device, learned
        from its observed round times; degrades to the flat
        ``fallback`` (the scheduler's EMA entry) before any history."""
        if self.history is not None:
            band = self.history.band(cid)
            if band is not None:
                return band
        h = max(float(fallback), 1e-9)
        return (h, h, h)


def resource_aware_forecast(view: ResourceView, cost, dev, split: int,
                            recorded: float, *, frac: float = 1.0,
                            ef_weight: float = 1.0):
    """Price one candidate (device, split[, batch fraction]) against the
    live resource state. Returns predicted seconds, or None when the
    cost model is not analytic (no ``cost(split)``/``channel`` surface —
    the caller then falls back to the blind forecast).

    ``frac`` scales the per-round sample count (the joint batch-size
    knob): compute terms and the feature payload scale with it, the
    model legs do not."""
    if not hasattr(cost, "cost") or getattr(cost, "channel", None) is None:
        return None
    c = cost.cost(split)
    ch = cost.channel
    cid = dev.cid
    p = cost.p_of(cid)
    if frac != 1.0:
        p = max(1.0, round(p * frac))
    clock = view.clock
    start = max(clock, view.busy_until(cid)) if view.gated else clock
    gate_wait = start - clock

    n_values = p * c["feat_size"]
    wc_leg = ch.estimate_dispatch_leg(c["wc_size"])
    up = ch.estimate_uplink_payload(n_values)
    down = ch.estimate_downlink_payload(n_values)
    # residual-aware re-split pricing: switching the cut layer resets
    # the device's error-feedback accumulators (shape change), so the
    # residual elements it holds are information that must cross the
    # wire again — charge them to the candidate's uplink
    last = view.last_split(cid)
    if last is not None and split != last:
        up += ef_weight * view.residual_elements(cid) * BYTES_PER_ELEM

    fc = p * c["fc"]
    t_srv = p * c["fs"] / SERVER_FLOPS
    # 2 messages ride each client-side phase; forecasts price the MEAN
    # latency (a future round's draw is unknown, all dists mean-preserve)
    lat2 = 0.5 * MESSAGES_PER_ROUND * ch.latency
    load = view.cohort_load
    slots = view.server_slots
    up_cap = cost.shared_uplink_bytes()
    dn_cap = cost.shared_downlink_bytes()
    n_up, up_backlog = view.uplink_backlog()
    n_dn, dn_backlog = view.downlink_backlog()
    # server wait: jobs already queued, plus the half-cohort expected to
    # arrive alongside this device inside the same window, each holding
    # a slot for one mean backward. The social term is marginal-cost
    # (Pigouvian) pricing of the FIFO slot: the candidate's own service
    # time delays every job queued behind it, and a cohort of selfish
    # per-device argmins only drains the bottleneck if each internalizes
    # that externality — without it every live-state term is a
    # split-independent constant that can never move an argmin
    srv_wait = 0.0
    srv_social = 0.0
    if not math.isinf(slots):
        ahead = view.server_depth() + 0.5 * max(load - 1, 0)
        srv_wait = ahead * view.server_mean_duration(t_srv) / slots
        srv_social = ahead * t_srv / slots
    # the symmetric downlink externality: the candidate's dfx transfer
    # occupies the shared egress for down/dn_cap seconds, backlogging
    # every flow draining behind it (live flows + the half-cohort
    # arriving inside the same window) — without this term a fat
    # downlink payload looks free to the per-device argmin exactly the
    # way an unpriced FIFO slot did
    dn_social = 0.0
    if not math.isinf(dn_cap):
        behind = n_dn + 0.5 * max(load - 1, 0)
        dn_social = behind * down / dn_cap

    lo, mid, hi = view.horizon_band(cid, recorded)
    worst = None
    for h in {lo, mid, hi}:
        rate = ch.mean_rate(dev, start, start + max(h, 1e-9)) \
            * BYTES_PER_ELEM
        up_rate, up_wait = rate, 0.0
        if not math.isinf(up_cap):
            up_rate = min(rate, up_cap / max(load + n_up, 1))
            up_wait = up_backlog / up_cap
        dn_rate, dn_wait = rate, 0.0
        if not math.isinf(dn_cap):
            dn_rate = min(rate, dn_cap / max(load + n_dn, 1))
            dn_wait = dn_backlog / dn_cap
        t = (gate_wait
             + lat2 + wc_leg / rate + CLIENT_FWD_FRAC * fc / dev.comp
             + up_wait + up / up_rate
             + srv_wait + srv_social + t_srv
             + dn_wait + dn_social + down / dn_rate
             + lat2 + wc_leg / rate
             + (1.0 - CLIENT_FWD_FRAC) * fc / dev.comp)
        if worst is None or t > worst:
            worst = t
    return worst


def default_knob_grid(quorum: float, staleness_cap: int):
    """Candidate (quorum, staleness_cap) settings for the aggregation
    controller, anchored on the configured pair: the configured setting
    probes first (ties go to it), then earlier-closing windows (lower
    quorum / extra staleness headroom) and a stricter near-sync one."""
    grid = [(quorum, staleness_cap)]
    for q, cap in ((max(0.25, quorum - 0.2), staleness_cap),
                   (quorum, staleness_cap + 1),
                   (min(1.0, quorum + 0.25), max(staleness_cap - 1, 0))):
        if (q, cap) not in grid:
            grid.append((q, cap))
    return tuple(grid)


class AggregationController:
    """Deterministic successive-probe tuner for the aggregation
    frequency: each candidate (quorum, staleness_cap) setting runs for
    ``probe_rounds`` rounds, its mean round time is recorded, and after
    the sweep the argmin setting locks in (first-probed wins ties, so
    the configured anchor is preferred at equal cost). No RNG, no wall
    clock — replays bit-exactly and checkpoints as flat lists.

    Round time alone is a trap: a loose quorum that commits almost
    nothing closes windows fast while learning stalls. When the caller
    also feeds the observed training loss (``observe_loss``, once per
    round), each probe accumulates its mean per-round loss *delta*, and
    at lock time any candidate whose mean delta regresses more than
    ``loss_tol`` past the anchor setting's (index 0 — the configured
    pair, never rejected) is disqualified before the time argmin runs.
    With no loss signal the behavior is exactly the time-only tuner."""

    def __init__(self, settings, probe_rounds: int = 4,
                 loss_tol: float = 0.25):
        settings = [(float(q), int(cap)) for q, cap in settings]
        if not settings:
            raise ValueError("need at least one (quorum, cap) setting")
        for q, cap in settings:
            if not 0.0 < q <= 1.0 or cap < 0:
                raise ValueError(f"bad knob setting ({q}, {cap})")
        self.settings = settings
        self.probe_rounds = int(probe_rounds)
        self.loss_tol = float(loss_tol)
        self._sums = [0.0] * len(settings)
        self._counts = [0] * len(settings)
        self._loss_sums = [0.0] * len(settings)
        self._loss_counts = [0] * len(settings)
        self._last_loss = None     # previous round's loss (delta base)
        self._last_probe = 0       # setting the last observed round ran
        self._i = 0
        self.locked = None         # index once the sweep finished
        self.rejected = ()         # indices disqualified on loss

    def current(self):
        """(quorum, staleness_cap) to run the next round with."""
        i = self.locked if self.locked is not None else self._i
        return self.settings[i]

    def observe(self, round_time: float):
        """Feed one round's duration under the current setting."""
        if self.locked is not None:
            return
        self._last_probe = self._i
        self._sums[self._i] += float(round_time)
        self._counts[self._i] += 1
        if self._counts[self._i] >= self.probe_rounds:
            if self._i + 1 < len(self.settings):
                self._i += 1
            else:
                self._lock()

    def observe_loss(self, loss):
        """Feed the round's observed training loss (call after the
        round's ``observe``; the delta vs the previous round accrues to
        the setting that round actually ran under). Non-finite losses
        are skipped — a NaN round neither poisons a probe nor resets
        the delta base unfairly: the base just carries forward."""
        loss = float(loss)
        if not math.isfinite(loss):
            return
        if self._last_loss is not None and self.locked is None:
            j = self._last_probe
            self._loss_sums[j] += loss - self._last_loss
            self._loss_counts[j] += 1
        self._last_loss = loss

    def _lock(self):
        means = [s / max(n, 1) for s, n in zip(self._sums, self._counts)]
        deltas = [ls / ln if ln else None
                  for ls, ln in zip(self._loss_sums, self._loss_counts)]
        anchor = deltas[0] if deltas[0] is not None else 0.0
        eligible = [j for j in range(len(means))
                    if j == 0 or deltas[j] is None
                    or deltas[j] - anchor <= self.loss_tol]
        self.rejected = tuple(j for j in range(len(means))
                              if j not in eligible)
        self.locked = min(eligible, key=lambda j: (means[j], j))

    def loss_delta_means(self):
        """Per-setting mean per-round loss delta (None = no signal)."""
        return [ls / ln if ln else None
                for ls, ln in zip(self._loss_sums, self._loss_counts)]

    # ------------------------------------------------- checkpoint state
    def export_state(self) -> dict:
        return {"settings": [[q, cap] for q, cap in self.settings],
                "probe_rounds": self.probe_rounds,
                "loss_tol": self.loss_tol,
                "sums": list(self._sums), "counts": list(self._counts),
                "loss_sums": [repr(x) for x in self._loss_sums],
                "loss_counts": list(self._loss_counts),
                "last_loss": (None if self._last_loss is None
                              else repr(self._last_loss)),
                "last_probe": self._last_probe,
                "rejected": list(self.rejected),
                "i": self._i, "locked": self.locked}

    def restore_state(self, st: dict):
        self.settings = [(float(q), int(cap)) for q, cap in st["settings"]]
        self.probe_rounds = int(st["probe_rounds"])
        n = len(self.settings)
        self.loss_tol = float(st.get("loss_tol", self.loss_tol))
        self._sums = [float(x) for x in st["sums"]]
        self._counts = [int(x) for x in st["counts"]]
        # pre-loss-awareness checkpoints restore as a time-only tuner
        self._loss_sums = [float(x) for x in st.get("loss_sums",
                                                    [0.0] * n)]
        self._loss_counts = [int(x) for x in st.get("loss_counts",
                                                    [0] * n)]
        last = st.get("last_loss")
        self._last_loss = None if last is None else float(last)
        self._last_probe = int(st.get("last_probe", 0))
        self.rejected = tuple(int(j) for j in st.get("rejected", ()))
        self._i = int(st["i"])
        self.locked = None if st["locked"] is None else int(st["locked"])
