"""RoundDriver — THE warm-up → select → execute → observe → advance-clock
loop (single implementation; benchmarks, tests and the engine all drive
rounds through here instead of re-implementing it).

Three layers:

``CostModel``
    What a device-round costs: ``time_and_bytes(dev, split, clock)`` →
    Eq.-1 wall time + wire bytes, and ``phase_cost(...)`` → the
    upload / server-compute / download decomposition the pipelined
    timeline schedules. ``AnalyticCost`` prices payloads with the
    channel's analytic codec estimates (the benchmark/tests path);
    ``MeteredCost`` uses the exact bytes the ``CommChannel`` metered
    while real tensors crossed it (the ``S2FLEngine`` path); and
    ``FedAvgCost`` prices the full-model baseline. ``CallableCost``
    wraps a plain ``t_of(cid, split)`` for unit tests.

``RoundDriver.run_round``
    One round: during §3.1 warm-up, observe every device's Eq.-1 time so
    the scheduler's client time table fills; select splits; optionally
    call back into the caller (the engine trains for real here and
    returns metered payload bytes + its Eq.-2 groups); observe the
    participants' times; advance the clock.

Execution modes (the clock semantics):
    ``sync``       the paper's Eq.-1 barrier — the round's clock advance
                   is ``max`` over participant times; everything commits
                   in the round it was dispatched.
    ``semi_async`` device/group completions are events in a heap. The
                   aggregation window closes once a ``quorum`` fraction
                   of this round's arrivals are in; stragglers keep
                   running and commit in the window where their event
                   lands, at most ``staleness_cap`` rounds late (the
                   window blocks on any event that would otherwise
                   exceed the cap — ``staleness_cap=0`` degenerates to
                   ``sync``). The clock is a true event timeline: on a
                   static link semi_async wall-clock never exceeds sync
                   (each window closes at or before the sync barrier).

Phase pipeline (``pipeline=True``, orthogonal to the exec mode): each
device-round is split into three chained phase events instead of one
atomic Eq.-1 event —

    upload          Wc dispatch + client forward + features over the
                    uplink (concurrent uploads contend for the shared
                    ingress capacity when the channel bounds it);
    server compute  the group backward — the COMMIT event: windows
                    close, staleness is accounted, and aggregation
                    happens here;
    download        feature gradients + client backward + Wc
                    collection, draining in the background (tracked in
                    a second heap; ``flush()`` waits them out so the
                    final wall-clock is honest).

Because an update commits when its server compute finishes rather than
when its download lands, the server starts one group's backward while
another group's upload is still in flight — with contention and latency
off, every commit can only move earlier, so the pipelined wall-clock is
a lower bound on the phase-sequential one (property-tested in
tests/test_driver_properties.py).

Finite resources (all default off — the free-overlap regime — and all
only observable under the phase pipeline, which is the only timeline
that can see overlap):

    server_concurrency   the Main Server GPU runs at most this many
                         group backwards at once (``_ServerQueue``:
                         FIFO by feature-arrival order; 0 = unbounded);
    downlink_capacity    concurrent dfx downloads contend for the
                         shared egress under the same max-min fair
                         fluid schedule as the uplink (``FluidLink``);
    cross-window carry   uplink AND downlink flows live in stateful
                         ``FluidLink``s that span aggregation windows:
                         a straggler's in-flight transfer slows the
                         next round's cohort, and each round's re-solve
                         revises the straggler's own pending events
                         (already-closed windows can never be
                         disturbed — their inputs all predate every
                         later arrival);
    gate_redispatch      a device must finish draining its own download
                         before its next upload may start (off = the
                         semi-async queue's device-overcommit optimism);
    latency_dist         per-(device, round) latency draws around the
                         mean instead of one shared constant
                         (``links.LatencySampler``, deterministic seed
                         per draw — semi-async replay is exact).

With every knob at its default the event timeline is bit-exact with the
infinite-resource pipeline (closed-form fast paths, golden-tested).

Predictive split selection: with ``predictive=True`` the driver installs
a ``forecast`` hook on the scheduler — instead of trusting the EMA time
table alone, each candidate time is re-priced with the link model's
MEAN rate over the projected completion window ``[clock, clock + ema]``
(``CommChannel.mean_rate`` → ``LinkTrace`` exact integral), so a fade
that will hit mid-round is anticipated rather than discovered. When the
channel bounds the shared uplink, the forecast rate is additionally
capped at ``capacity / round_load`` — the contention-adjusted rate the
device will actually see.

See ``core/README.md`` for the design discussion.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
import zlib
from typing import Callable, Optional

from repro_torch.comm.channel import MESSAGES_PER_ROUND
from repro_torch.comm.links import FluidLink
from repro_torch.core.simulation import (BYTES_PER_ELEM, CLIENT_FWD_FRAC,
                                   SERVER_FLOPS, device_round_time_bytes,
                                   fedavg_round_comm_bytes,
                                   fedavg_round_time,
                                   fedavg_round_time_bytes)

EXEC_MODES = ("sync", "semi_async")


def _cid(dev):
    """Device handle -> client id (accepts Device objects or bare ids)."""
    return getattr(dev, "cid", dev)


# ---------------------------------------------------------------------------
# cost models
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PhaseCost:
    """One device-round decomposed for the pipelined timeline.

    Transfer rates are frozen at the dispatch clock (piecewise-constant
    traces make this exact within a segment). The feature upload and
    the dfx download are the segments that contend for the shared
    ingress/egress, so each is kept as (bytes, own-rate) for the fluid
    scheduler; everything else is already seconds. ``t_down`` remains
    the FULL download-phase duration on an uncontended egress (the
    legacy lump, kept verbatim so the default path stays bit-exact);
    ``down_bytes``/``down_rate``/``t_post`` carve the contendable dfx
    transfer out of it for a finite ``downlink_capacity`` (``t_post``:
    the remainder — client backward + Wc collect + latency — that runs
    after the contended transfer lands; None derives it from
    ``t_down``)."""
    t_pre: float           # Wc dispatch transfer + client fwd (+ 2 lat)
    up_bytes: float        # feature payload on the shared uplink
    up_rate: float         # device's own uplink bytes/s at dispatch
    t_srv: float           # server compute (the commit phase)
    t_down: float          # dfx down + client bwd + Wc collect (+ 2 lat)
    total_bytes: float     # full wire traffic (= the atomic accounting)
    down_bytes: float = 0.0        # dfx payload on the shared downlink
    down_rate: float = math.inf    # device's own downlink bytes/s
    t_post: float = None           # post-transfer remainder of t_down

    def post_time(self) -> float:
        """Download-phase time after the contended dfx transfer."""
        if self.t_post is not None:
            return self.t_post
        xfer = self.down_bytes / self.down_rate if self.down_bytes else 0.0
        return self.t_down - xfer


class CostModel:
    """(time, bytes) of one device-round at simulated time ``clock``.

    ``payload_bytes`` / ``dispatch_bytes`` carry exact channel-metered
    cut-layer and model-leg bytes when the caller materialized tensors
    (None -> analytic estimates)."""

    def time_and_bytes(self, dev, split: int, clock: float,
                       payload_bytes: Optional[float] = None,
                       dispatch_bytes: Optional[float] = None):
        raise NotImplementedError

    def phase_cost(self, dev, split: int, clock: float,
                   up_payload: Optional[float] = None,
                   down_payload: Optional[float] = None,
                   disp_down: Optional[float] = None,
                   disp_up: Optional[float] = None
                   ) -> Optional[PhaseCost]:
        """Upload/server/download decomposition for the pipelined
        timeline (None -> no decomposition; the driver falls back to one
        atomic event for this device — e.g. the FedAvg baseline, which
        has no cut layer to pipeline around)."""
        return None

    def shared_uplink_bytes(self) -> float:
        """Shared ingress capacity in bytes/s (inf = uncontended)."""
        return math.inf

    def shared_downlink_bytes(self) -> float:
        """Shared egress capacity in bytes/s (inf = uncontended)."""
        return math.inf

    def forecast_time(self, dev, split: int, clock: float,
                      horizon: float, load: int = 1) -> Optional[float]:
        """Predicted round time if dispatched now and finishing ~horizon
        later (None -> no prediction, caller falls back to the EMA).
        ``load`` is the number of devices expected to share the uplink
        this round (contention-adjusts the forecast rate)."""
        return None


class AnalyticCost(CostModel):
    """Eq.-1 via the channel's analytic payload estimates — what every
    benchmark and scheduler test uses (no tensors ever materialize).

    costs: {split: {'wc_size','feat_size','fc','fs'}} per-sample Eq.-1
    quantities (``repro_torch.utils.flops.split_costs``) or a callable
    ``split -> dict`` (resolved lazily and cached). ``p`` is the local
    sample count per round; ``p_of(cid)`` overrides it per client.
    """

    def __init__(self, channel, costs, *, p: int = 128,
                 p_of: Optional[Callable] = None):
        self.channel = channel
        self._costs = costs if callable(costs) else costs.__getitem__
        self._cache: dict = {}
        self.p_of = p_of or (lambda cid: p)
        # joint batch-size knob (None = off): ``frac_of(cid)`` scales
        # the per-round sample count the Eq.-1 terms price — the driver
        # wires it to the scheduler's ``selected_fracs`` when a joint
        # scheduler is in play
        self.frac_of: Optional[Callable] = None

    def cost(self, split: int) -> dict:
        if split not in self._cache:
            self._cache[split] = self._costs(split)
        return self._cache[split]

    def _p_eff(self, cid):
        """Per-round sample count with the batch-fraction knob applied
        (identical to ``p_of`` while no fraction is selected)."""
        p = self.p_of(cid)
        if self.frac_of is not None:
            f = self.frac_of(cid)
            if f != 1.0:
                p = max(1, int(round(p * f)))
        return p

    def time_and_bytes(self, dev, split, clock, payload_bytes=None,
                       dispatch_bytes=None):
        c, p = self.cost(split), self._p_eff(_cid(dev))
        return self.channel.analytic_round_time(
            dev, wc_size=c["wc_size"], n_values=p * c["feat_size"],
            fc=p * c["fc"], fs=p * c["fs"], t=clock)

    def phase_cost(self, dev, split, clock, up_payload=None,
                   down_payload=None, disp_down=None, disp_up=None):
        c, p = self.cost(split), self._p_eff(_cid(dev))
        ch = self.channel
        rate = ch.rate(dev, clock) * BYTES_PER_ELEM
        n_values = p * c["feat_size"]
        up = (up_payload if up_payload is not None
              else ch.estimate_uplink_payload(n_values))
        down = (down_payload if down_payload is not None
                else ch.estimate_downlink_payload(n_values))
        # one-way model transfers (dispatch codec; fp32 reproduces the
        # seed's wc_size * BYTES_PER_ELEM)
        wc_down = (disp_down if disp_down is not None
                   else ch.estimate_dispatch_leg(c["wc_size"]))
        wc_up = (disp_up if disp_up is not None
                 else ch.estimate_dispatch_leg(c["wc_size"]))
        fc, fs = p * c["fc"], p * c["fs"]
        # half the round's messages ride each client-side phase, so the
        # atomic and phase paths charge the same total latency
        lat2 = 0.5 * MESSAGES_PER_ROUND * ch.latency_of(_cid(dev))
        # t_down keeps the legacy lump arithmetic verbatim (bit-exact
        # default path); t_post carves the dfx transfer out for a
        # contended egress
        return PhaseCost(
            t_pre=lat2 + wc_down / rate
            + CLIENT_FWD_FRAC * fc / dev.comp,
            up_bytes=up, up_rate=rate,
            t_srv=fs / SERVER_FLOPS,
            t_down=lat2 + (down + wc_up) / rate
            + (1.0 - CLIENT_FWD_FRAC) * fc / dev.comp,
            total_bytes=wc_down + wc_up + up + down,
            down_bytes=down, down_rate=rate,
            t_post=lat2 + wc_up / rate
            + (1.0 - CLIENT_FWD_FRAC) * fc / dev.comp)

    def shared_uplink_bytes(self):
        cap = getattr(self.channel, "uplink_capacity", 0.0)
        return cap * BYTES_PER_ELEM if cap else math.inf

    def shared_downlink_bytes(self):
        cap = getattr(self.channel, "downlink_capacity", 0.0)
        return cap * BYTES_PER_ELEM if cap else math.inf

    def forecast_time(self, dev, split, clock, horizon, load=1):
        c, p = self.cost(split), self._p_eff(_cid(dev))
        nbytes = self.channel.estimate_dispatch_round(c["wc_size"]) \
            + self.channel.estimate_round_payload(p * c["feat_size"])
        rate = self.channel.mean_rate(dev, clock,
                                      clock + max(horizon, 1e-9))
        cap = getattr(self.channel, "uplink_capacity", 0.0)
        if cap:
            # contention-adjusted: the shared ingress split across the
            # round's cohort bounds what this device will actually see
            # (even a solo upload is capped at the full ingress, exactly
            # as the fluid schedule caps it)
            rate = min(rate, cap / max(load, 1))
        # forecasts price the MEAN latency (the draw for a future round
        # is unknown; every distribution is mean-preserving)
        return device_round_time_bytes(dev, comm_bytes=nbytes,
                                       fc=p * c["fc"], fs=p * c["fs"],
                                       rate=rate) \
            + MESSAGES_PER_ROUND * self.channel.latency


class MeteredCost(AnalyticCost):
    """Engine path: when the channel metered real payload bytes for a
    participant, price exactly those; otherwise (warm-up observation of
    devices whose tensors never materialize, forecasts) fall back to the
    analytic estimate."""

    def time_and_bytes(self, dev, split, clock, payload_bytes=None,
                       dispatch_bytes=None):
        if payload_bytes is None:
            return super().time_and_bytes(dev, split, clock)
        c, p = self.cost(split), self._p_eff(_cid(dev))
        disp = (dispatch_bytes if dispatch_bytes is not None
                else self.channel.estimate_dispatch_round(c["wc_size"]))
        nbytes = disp + payload_bytes
        t = device_round_time_bytes(
            dev, comm_bytes=nbytes, fc=p * c["fc"], fs=p * c["fs"],
            rate=self.channel.rate(dev, clock)) \
            + MESSAGES_PER_ROUND * self.channel.latency_of(_cid(dev))
        return t, nbytes


class FedAvgCost(CostModel):
    """Full-model FedAvg baseline round cost (split is ignored). No cut
    layer, so there is nothing to phase-split: under ``pipeline=True``
    FedAvg rounds stay atomic events.

    With a ``channel`` the model legs are priced through its dispatch
    codec (the QSGD-style compressed-FedAvg baseline: broadcast down,
    compressed update up); exact metered ``dispatch_bytes`` override
    the analytic estimate when the engine materialized the transfer."""

    def __init__(self, costs_full, *, p: int = 128,
                 p_of: Optional[Callable] = None, channel=None):
        self._costs = costs_full if callable(costs_full) \
            else (lambda: costs_full)
        self._cache = None
        self.p_of = p_of or (lambda cid: p)
        self.channel = channel

    def cost(self) -> dict:
        if self._cache is None:
            self._cache = self._costs()
        return self._cache

    def time_and_bytes(self, dev, split, clock, payload_bytes=None,
                       dispatch_bytes=None):
        c, p = self.cost(), self.p_of(_cid(dev))
        if dispatch_bytes is not None:
            nbytes = dispatch_bytes
        elif self.channel is not None:
            nbytes = self.channel.estimate_dispatch_round(c["w_size"])
        else:
            nbytes = fedavg_round_comm_bytes(w_size=c["w_size"])
        if dispatch_bytes is None and self.channel is None:
            t = fedavg_round_time(dev, w_size=c["w_size"], p=p,
                                  f_full=c["f_full"])
        else:
            rate = (self.channel.rate(dev, clock) if self.channel
                    else None)
            t = fedavg_round_time_bytes(dev, comm_bytes=nbytes, p=p,
                                        f_full=c["f_full"], rate=rate)
        return t, nbytes


class CallableCost(CostModel):
    """Unit-test adapter: a plain ``t_of(cid, split)`` (clock-free) or
    ``t_of(cid, split, clock)`` time function, optional byte function,
    optional ``phases_of(cid, split) -> PhaseCost`` for pipelined
    tests."""

    def __init__(self, t_of: Callable, bytes_of: Optional[Callable] = None,
                 *, clocked: bool = False,
                 phases_of: Optional[Callable] = None):
        self.t_of, self.bytes_of, self.clocked = t_of, bytes_of, clocked
        self.phases_of = phases_of

    def time_and_bytes(self, dev, split, clock, payload_bytes=None,
                       dispatch_bytes=None):
        cid = _cid(dev)
        t = self.t_of(cid, split, clock) if self.clocked \
            else self.t_of(cid, split)
        return t, (self.bytes_of(cid, split) if self.bytes_of else 0.0)

    def phase_cost(self, dev, split, clock, up_payload=None,
                   down_payload=None, disp_down=None, disp_up=None):
        if self.phases_of is None:
            return None
        return self.phases_of(_cid(dev), split)


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class RoundResult:
    round: int                     # round index just driven
    clock: float                   # driver clock after the window closed
    round_time: float              # clock advance this round
    comm_bytes: float              # wire bytes dispatched this round
    splits: dict                   # {cid: split} selected this round
    times: dict                    # {cid: Eq.-1 device time}
    committed: tuple               # work keys whose updates commit now
    staleness: dict                # {key: rounds late} for committed keys
    pending: int                   # commit events still in flight after
    phases: dict = dataclasses.field(default_factory=dict)
    #                              # {cid: {'up','srv','down'} durations}
    #                              # (pipelined rounds only)
    downloads: int = 0             # download events still draining
    abandoned: tuple = ()          # work keys torn down by kills this
    #                              # round (fault injection only) — a
    #                              # dispatched key lands in exactly one
    #                              # of committed/abandoned, ever
    killed: tuple = ()             # cids killed this round
    rejoined: tuple = ()           # cids rejoined before this round


@dataclasses.dataclass(order=True)
class _Event:
    ready: float
    seq: int
    round: int = dataclasses.field(compare=False)
    key: object = dataclasses.field(compare=False)


class _ServerQueue:
    """The Main Server GPU as a finite resource: at most ``slots``
    group backwards run concurrently, FIFO by feature-arrival time
    (ties broken by admission order). Live jobs are re-scheduled from
    scratch by every ``solve()`` — which makes the cross-window
    consistency argument simple: a schedule whose arrivals did not
    change recomputes to the bit-identical finishes, while pending
    jobs whose uplink flows were slowed by a later cohort shift (and
    may reorder) behind it. ``compact()`` retires jobs that can no
    longer interact with anything schedulable (same prefix rule as
    ``FluidLink``: all slots they occupied are free before every kept
    job's arrival), bounding the per-round cost by the jobs still in
    flight."""

    def __init__(self, slots: float = math.inf):
        if slots != math.inf and slots < 1:
            raise ValueError(f"server slots must be >= 1 (or inf): {slots}")
        self.slots = slots
        self._arrive: list = []
        self._dur: list = []
        self._live: list = []          # jids still in the schedule
        self._finish_cache: dict = {}  # retired jid -> finish

    def add(self, arrival: float, duration: float) -> int:
        self._arrive.append(float(arrival))
        self._dur.append(float(duration))
        self._live.append(len(self._arrive) - 1)
        return len(self._arrive) - 1

    def set_arrival(self, jid: int, arrival: float):
        self._arrive[jid] = float(arrival)

    def solve(self):
        """Finish time per job (index = jid; retired jobs from cache)."""
        finish = [0.0] * len(self._arrive)
        for j, fin in self._finish_cache.items():
            finish[j] = fin
        if math.isinf(self.slots):
            for i in self._live:
                finish[i] = self._arrive[i] + self._dur[i]
            return finish
        order = sorted(self._live, key=lambda i: (self._arrive[i], i))
        free = [0.0] * int(self.slots)   # slot free times (min-heap)
        for i in order:
            start = max(self._arrive[i], heapq.heappop(free))
            finish[i] = start + self._dur[i]
            heapq.heappush(free, finish[i])
        return finish

    def compact(self, now: float):
        from repro_torch.comm.links import retire_prefix
        if len(self._live) <= 1:
            return
        fins = self.solve()
        retired, kept = retire_prefix(self._live, fins, self._arrive, now)
        if retired:
            for j in retired:
                self._finish_cache[j] = fins[j]
            self._live = kept

    def cancel(self, jid: int, t: float) -> bool:
        """Tear down job ``jid`` at time ``t`` (its device died). A job
        still WAITING at ``t`` leaves the queue entirely (its FIFO
        position frees for the jobs behind it); a RUNNING job has its
        duration truncated so its slot frees at the kill instant — the
        schedule before ``t`` is history and stays untouched. A job
        already finished (or retired) is a no-op. Returns True when the
        job was actually cancelled."""
        if jid in self._finish_cache:
            return False
        fins = self.solve()
        if fins[jid] <= t:
            return False               # finished before the kill
        start = fins[jid] - self._dur[jid]
        if start >= t:
            # never started: drop it from the schedule outright
            self._live.remove(jid)
            self._finish_cache[jid] = t
            return True
        self._dur[jid] = t - start
        return True

    def depth_at(self, t: float) -> int:
        """Jobs arrived but unfinished at ``t`` (waiting + running) —
        the queue-depth gauge the TraceRecorder samples. Observational
        only: re-uses ``solve()``, never mutates the schedule."""
        fins = self.solve()
        return sum(1 for i in self._live
                   if self._arrive[i] <= t < fins[i])

    # ------------------------------------------------ checkpoint state
    def export_state(self) -> dict:
        return {"slots": self.slots,
                "arrive": list(self._arrive),
                "dur": list(self._dur),
                "live": list(self._live),
                "finish_cache": [[j, fin] for j, fin
                                 in sorted(self._finish_cache.items())]}

    @classmethod
    def from_state(cls, st: dict) -> "_ServerQueue":
        q = cls(st["slots"])
        q._arrive = [float(x) for x in st["arrive"]]
        q._dur = [float(x) for x in st["dur"]]
        q._live = [int(j) for j in st["live"]]
        q._finish_cache = {int(j): float(fin)
                           for j, fin in st["finish_cache"]}
        return q


@dataclasses.dataclass
class _Flight:
    """One pipelined device-round in flight: its uplink flow, server
    job and (when the egress is contended) downlink flow ids, plus the
    latest solved commit / download-end estimates. Flights persist
    across rounds until their commit event has been popped AND their
    download has drained, so each round's resource re-solve can push a
    straggler's pending events later."""
    uid: int
    cid: object
    round: int
    fid: int                   # uplink FluidLink flow id
    jid: int                   # _ServerQueue job id
    pc: PhaseCost
    did: Optional[int] = None  # downlink flow id (contended egress only)
    key: object = None         # commit work-item (group) key
    commit: float = math.nan
    dl_end: float = math.nan
    dispatch: float = 0.0      # phase start (dispatch clock + gate wait)
    up_end: float = math.nan   # latest solved uplink-flow finish


class RoundDriver:
    """Owns the round loop and the simulated timeline.

    scheduler : Sliding/MinTime/FixedSplitScheduler (select/observe/
                end_round + the §3.1 warm-up protocol)
    cost      : a CostModel
    devices   : Device objects (or bare cids with a CallableCost)
    warmup_devices : subset observed during warm-up rounds (default: all
                devices — the engine restricts to devices that own data)
    pipeline  : phase-level event timeline (upload / server-compute /
                download) instead of one atomic event per device-round
    server_concurrency : max concurrent group backwards on the Main
                Server GPU (0 = unbounded; pipeline only)
    gate_redispatch : a device's next upload waits out its own draining
                download (off = device-overcommit optimism; pipeline
                only)
    recorder  : an ``observe.TraceRecorder`` (None or the no-op default
                = zero overhead: every hook site guards on
                ``recorder.enabled`` before building any record)
    fleet     : a ``core.fleet.Fleet`` batched population — devices may
                then be empty; cohort members' Device objects
                materialize lazily (O(active cohort), never O(P))
    clusters / cluster_quorum : hierarchical aggregation (devices →
                edge clusters → main server): each cluster closes at
                its own ``cluster_quorum`` quantile, the global window
                at ``quorum`` over the cluster close times; clusters
                <= 1 is the flat window, bit-for-bit
    """

    def __init__(self, scheduler, cost: CostModel, devices, *,
                 mode: str = "sync", staleness_cap: int = 1,
                 quorum: float = 0.5, predictive: bool = False,
                 resource_aware: bool = False,
                 pipeline: bool = False, warmup_devices=None,
                 server_concurrency: int = 0,
                 gate_redispatch: bool = False, recorder=None,
                 fault_plan=None, knob_controller=None,
                 fleet=None, clusters: int = 0,
                 cluster_quorum: float = 1.0):
        if mode not in EXEC_MODES:
            raise ValueError(f"exec mode {mode!r}; known: {EXEC_MODES}")
        if staleness_cap < 0:
            raise ValueError(f"staleness_cap must be >= 0: {staleness_cap}")
        if not 0.0 < quorum <= 1.0:
            raise ValueError(f"quorum must be in (0, 1]: {quorum}")
        if not 0.0 < cluster_quorum <= 1.0:
            raise ValueError(
                f"cluster_quorum must be in (0, 1]: {cluster_quorum}")
        if clusters < 0:
            raise ValueError(f"clusters must be >= 0: {clusters}")
        if server_concurrency < 0:
            raise ValueError(f"server_concurrency must be >= 0 "
                             f"(0 = unbounded): {server_concurrency}")
        self.scheduler = scheduler
        self.cost = cost
        self.devices = list(devices)
        self.warmup_devices = (list(warmup_devices)
                               if warmup_devices is not None
                               else self.devices)
        self._dev_by_id = {_cid(d): d for d in self.devices}
        # batched population (core/fleet.py): Device objects materialize
        # lazily through _dev_of, only for sampled cids — the driver
        # never walks the full population
        self._fleet = fleet
        self.clusters = int(clusters)
        if fleet is not None:
            if self.clusters == 0:
                self.clusters = int(getattr(fleet, "clusters", 0))
            elif getattr(fleet, "clusters", 0) != self.clusters:
                # one source of truth for the topology: the driver's
                # explicit knob wins and the fleet's mapping follows
                fleet.clusters = self.clusters
        self.cluster_quorum = float(cluster_quorum)
        self.mode = mode
        self.staleness_cap = staleness_cap
        self.quorum = quorum
        self.pipeline = bool(pipeline)
        self.server_concurrency = int(server_concurrency)
        self.gate_redispatch = bool(gate_redispatch)
        self.recorder = recorder
        self.clock = 0.0
        self.comm = 0.0                 # accumulated wire bytes
        self.round = 0
        self._pending: list = []        # _Event heap (commit events)
        self._downloads: list = []      # (ready, uid) heap (pipeline)
        self._seq = 0
        self._load = 1                  # current round's cohort size
        # pipeline resource state (built lazily on the first pipelined
        # round so the cost model's capacities are settled)
        self._uplink: Optional[FluidLink] = None
        self._downlink: Optional[FluidLink] = None
        self._srvq: Optional[_ServerQueue] = None
        self._flights: dict = {}        # uid -> _Flight (live)
        self._next_uid = 0
        self._dev_busy: dict = {}       # cid -> latest own download end
        self._round_uids: dict = {}     # this round's cid -> flight uid
        # fault injection (core/faults.py; None = the no-churn world,
        # bit-exact with the pre-fault driver)
        self.fault_plan = fault_plan
        self._dead: dict = {}           # cid -> round it was killed
        self._incarnation: dict = {}    # cid -> rejoin count (identity)
        self._members: dict = {}        # (round, key) -> {cid: commit}
        self._abandoned_ids: set = set()   # (round, key) torn down
        self._abandoned_now: list = []  # keys abandoned this run_round
        self.n_dispatched = 0           # work items pushed, ever
        self.n_committed = 0            # work items popped & committed
        self.n_abandoned = 0            # work items torn down by kills
        # resource-aware control plane (core/control.py): the scheduler
        # prices candidates against the LIVE queue/link/residual state
        # through a read-only ResourceView, with the forecast horizon
        # learned from the observed round-time distribution
        self.resource_aware = bool(resource_aware)
        self._history = None
        self._last_split: dict = {}
        self.view = None
        if resource_aware:
            from repro_torch.core.control import ResourceView
            from repro_torch.observe.history import RoundTimeTracker
            self._history = RoundTimeTracker()
            self.view = ResourceView(self, self._history)
        self.knob_controller = knob_controller
        if predictive or resource_aware:
            if not hasattr(scheduler, "forecast"):
                raise ValueError(
                    f"{type(scheduler).__name__} has no forecast hook; "
                    "predictive/resource-aware mode needs a sliding "
                    "scheduler")
            scheduler.forecast = self._forecast
            if resource_aware and hasattr(scheduler, "forecast_frac"):
                # joint batch-size knob: the scheduler can price
                # (split, frac) pairs through the same physics
                scheduler.forecast_frac = (
                    lambda cid, split, rec, frac:
                    self._forecast(cid, split, rec, frac=frac))
        # joint-knob consumers: the cost model prices each round with
        # the scheduler's selected batch fractions (engine-owned cost
        # models pre-install their own hook and are left alone)
        if (getattr(scheduler, "selected_fracs", None) is not None
                and getattr(cost, "frac_of", False) is None):
            cost.frac_of = (lambda cid:
                            scheduler.selected_fracs.get(cid, 1.0))

    # ------------------------------------------------------------ fleet
    def _dev_of(self, cid):
        """Device for ``cid`` — from the object grid, else materialized
        lazily from the fleet tables (cached so a returning cohort
        member costs one dict hit). None when neither knows the cid."""
        dev = self._dev_by_id.get(cid)
        if dev is None and self._fleet is not None:
            try:
                dev = self._fleet.device(cid)
            except (IndexError, TypeError, ValueError):
                return None
            self._dev_by_id[cid] = dev
        return dev

    def _cluster_of(self, cid):
        """Edge-cluster assignment for hierarchical aggregation."""
        if self._fleet is not None:
            return self._fleet.cluster_of(cid)
        try:
            return int(cid) % self.clusters
        except (TypeError, ValueError):
            return zlib.crc32(str(cid).encode("utf8")) % self.clusters

    # -------------------------------------------------------- predictive
    def _forecast(self, cid, split, recorded, frac=1.0):
        """Scheduler hook. Blind predictive mode re-prices the EMA entry
        with the link's mean rate over the projected completion window
        [clock, clock+ema], contention-adjusted by the round's cohort
        size. Resource-aware mode instead prices the candidate against
        the live driver state (queue depth, link backlog, own draining
        download, residual mass, learned horizon band) — falling back
        to the blind path for cost models with no analytic surface."""
        dev = self._dev_of(cid)
        if dev is None:
            return None
        if self.resource_aware:
            from repro_torch.core.control import resource_aware_forecast
            ft = resource_aware_forecast(self.view, self.cost, dev,
                                         split, recorded, frac=frac)
            if ft is not None:
                return ft
        return self.cost.forecast_time(dev, split, self.clock, recorded,
                                       load=self._load)

    def _apply_knobs(self):
        """Adopt the aggregation controller's current (quorum,
        staleness_cap) at a window boundary. Safety rule: the cap never
        drops below the age of the oldest pending event, so every
        commit this window still satisfies the staleness invariant
        (re-evaluated each round — the requested cap takes over once
        the old stragglers drain)."""
        q, cap = self.knob_controller.current()
        max_age = max((self.round - e.round for e in self._pending),
                      default=0)
        self.quorum = q
        self.staleness_cap = max(int(cap), max_age)

    # ------------------------------------------------------------- round
    def run_round(self, participants, execute=None) -> RoundResult:
        """Drive one round. ``participants``: cids or Device objects.

        ``execute(splits) -> report`` (optional) runs the caller's real
        work after selection; the report dict may carry
        ``payload_bytes`` ({cid: metered wire bytes, cut-layer only}),
        ``payload_up_bytes`` / ``payload_down_bytes`` (the per-direction
        split the pipelined timeline prices), ``dispatch_bytes``
        ({cid: metered model-leg bytes, dispatch + collect} with the
        per-direction ``dispatch_down_bytes`` / ``dispatch_up_bytes``)
        and ``groups`` ({work_key: (cid, ...)} — commit granularity;
        default one work item per participant keyed by cid).
        """
        part = [_cid(p) for p in participants]
        clock0 = self.clock
        if self.knob_controller is not None:
            self._apply_knobs()
        # fault plan: rejoins + pre-dispatch kills land before selection
        # (a dead device is filtered from the cohort; its carried
        # straggler work is torn down at the current clock); mid-flight
        # kills are held until this round's dispatch times are solved
        self._abandoned_now = []
        mid_kills, killed, rejoined = [], [], []
        if self.fault_plan is not None:
            for e in self.fault_plan.for_round(self.round):
                if e.kind == "rejoin":
                    if self._rejoin(e.cid):
                        rejoined.append(e.cid)
                elif e.at is None:
                    if self._kill(e.cid, clock0):
                        killed.append(e.cid)
                else:
                    mid_kills.append(e)
            part = [c for c in part if c not in self._dead]
        part_set = set(part)
        self._load = max(1, len(part))
        # per-(device, round) latency draws key on the round index
        ch = getattr(self.cost, "channel", None)
        if ch is not None:
            ch.sim_round = self.round

        # §3.1 warm-up: the shared split is dispatched to ALL devices so
        # the whole client time table fills; participants are observed
        # below with their (possibly metered) round times instead.
        if getattr(self.scheduler, "warming_up", False):
            s = self.scheduler.warmup_split()
            for d in self.warmup_devices:
                if _cid(d) in part_set or _cid(d) in self._dead:
                    continue
                t, _ = self.cost.time_and_bytes(d, s, clock0)
                self.scheduler.observe(_cid(d), s, t)

        splits = self.scheduler.select(part)
        plan = getattr(self.scheduler, "plan", None)
        if plan is not None:
            assert all(splits[c] in plan for c in part), splits

        report = execute(splits) if execute is not None else None
        payloads = (report or {}).get("payload_bytes", {})
        pay_up = (report or {}).get("payload_up_bytes", {})
        pay_down = (report or {}).get("payload_down_bytes", {})
        dispatch = (report or {}).get("dispatch_bytes", {})
        disp_down = (report or {}).get("dispatch_down_bytes", {})
        disp_up = (report or {}).get("dispatch_up_bytes", {})
        groups = (report or {}).get("groups")
        if groups is None:
            groups = {c: (c,) for c in part}

        phases: dict = {}
        if self.pipeline:
            commits, times, comm, phases = self._phase_schedule(
                part, splits, payloads, pay_up, pay_down,
                disp_down, disp_up, clock0)
        else:
            times, comm = {}, 0.0
            for c in part:
                dev = self._dev_of(c) or c
                t, nbytes = self.cost.time_and_bytes(
                    dev, splits[c], clock0,
                    payload_bytes=payloads.get(c),
                    dispatch_bytes=dispatch.get(c))
                times[c] = t
                comm += nbytes
            commits = {c: clock0 + times[c] for c in part}
        for c in part:
            self.scheduler.observe(c, splits[c], times[c])
        if self._history is not None:
            # the control plane's learned horizon: observed (not
            # forecast) per-device round times, and the split each
            # device last ran — what the residual-aware re-split
            # penalty compares candidates against
            for c in part:
                self._history.observe(c, times[c])
                self._last_split[c] = splits[c]

        items = {key: max(commits[c] for c in members)
                 for key, members in groups.items() if members}
        if self.pipeline and self._round_uids:
            # commit-granularity backref: carried flights re-key their
            # group's pending event on later rounds' resource re-solves
            for key, members in groups.items():
                for c in members:
                    uid = self._round_uids.get(c)
                    if uid is not None:
                        self._flights[uid].key = key

        # exactly-once ledger: every fresh work item is dispatched ONCE
        # here and will land in committed or abandoned, never both,
        # never twice (commits pop it from the heap; kills remove it
        # and record its (dispatch-round, key) identity)
        for key, ready in items.items():
            self._push(key, ready)
        self.n_dispatched += len(items)
        for key, members in groups.items():
            if members:
                self._members[(self.round, key)] = {c: commits[c]
                                                   for c in members}

        # mid-flight kills: the kill instant interpolates between the
        # dispatch clock and the round's last fresh commit estimate, so
        # the device dies while its transfers/backwards are in flight
        if mid_kills:
            horizon = max(items.values()) if items else clock0
            for e in mid_kills:
                t_kill = clock0 + e.at * max(horizon - clock0, 0.0)
                if self._kill(e.cid, t_kill):
                    killed.append(e.cid)

        fresh = [(r, self._item_cluster(groups.get(key) or (key,)))
                 for key, r in items.items()
                 if (self.round, key) not in self._abandoned_ids]
        committed, staleness, new_clock = self._close_window(fresh, clock0)
        self._drain_downloads(new_clock)

        self.clock = new_clock
        self.comm += comm
        if (self._fleet is not None and ch is not None
                and hasattr(ch, "residual_elements_of")):
            # fold the cohort's EF residual mass back into the (P,)
            # population table — O(active cohort), and the only write
            # the fleet sees from the round loop
            for c in part:
                self._fleet.note_residual(c, ch.residual_elements_of(c))
        if self.knob_controller is not None:
            self.knob_controller.observe(new_clock - clock0)
        self.scheduler.end_round()
        if self.recorder is not None and self.recorder.enabled:
            self._observe_round(groups, commits, clock0, committed,
                                staleness, new_clock)
        rec = RoundResult(
            round=self.round, clock=self.clock,
            round_time=new_clock - clock0, comm_bytes=comm, splits=splits,
            times=times, committed=tuple(committed), staleness=staleness,
            pending=len(self._pending), phases=phases,
            downloads=len(self._downloads),
            abandoned=tuple(self._abandoned_now),
            killed=tuple(killed), rejoined=tuple(rejoined))
        self.round += 1
        self._prune_flights()
        # member maps are only needed while their event pends
        live = {(e.round, e.key) for e in self._pending}
        self._members = {k: v for k, v in self._members.items()
                         if k in live}
        return rec

    # ----------------------------------------------------- observability
    def _observe_round(self, groups, commits, clock0, committed,
                       staleness, new_clock):
        """Feed the injected TraceRecorder after the window closed:
        upsert every live flight's span estimates (the same
        latest-wins semantics as the driver's own ``_Flight``
        revisions — once a flight's window has closed its record is
        final), record atomic lumps for work not phase-decomposed, the
        window itself, and the round's gauges. Only reached when a
        recording recorder is injected; the default path never builds
        any of this."""
        rec = self.recorder
        for fl in self._flights.values():
            pc = fl.pc
            rec.flight(fl.uid, cid=fl.cid, round=fl.round, key=fl.key,
                       dispatch=fl.dispatch, t_pre=pc.t_pre,
                       up_start=fl.dispatch + pc.t_pre,
                       up_bytes=pc.up_bytes, up_rate=pc.up_rate,
                       up_end=fl.up_end,
                       srv_start=fl.commit - pc.t_srv,
                       srv_end=fl.commit,
                       dl_xfer_end=fl.dl_end - pc.post_time(),
                       dl_end=fl.dl_end)
        flight_cids = set(self._round_uids) if self.pipeline else set()
        for key, members in groups.items():
            atoms = [c for c in members if c not in flight_cids]
            if atoms:
                rec.atomic(key, self.round, atoms, clock0,
                           max(commits[c] for c in atoms))
        rec.window(self.round, clock0, new_clock, staleness,
                   len(self._pending))
        rec.count("driver.rounds")
        rec.count("driver.commits", len(committed))
        rec.gauge("window.staleness.max", new_clock,
                  max(staleness.values(), default=0))
        rec.gauge("window.pending", new_clock, len(self._pending))
        if self._srvq is not None:
            rec.gauge("server.queue_depth", new_clock,
                      self._srvq.depth_at(new_clock))
            rec.gauge("downloads.in_flight", new_clock,
                      len(self._downloads))
            for name, link in (("uplink", self._uplink),
                               ("downlink", self._downlink)):
                rec.gauge(f"{name}.live_flows", new_clock,
                          len(link._live))
                rec.gauge(f"{name}.solves", new_clock, link.n_solves)
                rec.gauge(f"{name}.retired", new_clock, link.n_retired)
                if link.contended and new_clock > clock0:
                    rec.gauge(f"{name}.utilization", new_clock,
                              link.utilization(clock0, new_clock))
        ch = getattr(self.cost, "channel", None)
        if ch is not None and getattr(ch, "error_feedback", False):
            rec.gauge("channel.ef_residual", new_clock,
                      ch.residual_norm())

    # --------------------------------------------------- phase pipeline
    def _phase_schedule(self, part, splits, payloads, pay_up, pay_down,
                        disp_down, disp_up, clock0):
        """Chain upload → server-compute → download through the shared
        finite resources. Returns ({cid: commit time}, {cid: full round
        duration}, round wire bytes, {cid: phase durations}).

        Commit = the end of the device's server-compute share — its own
        Eq.-1 Fs term, queued FIFO on the server's `server_concurrency`
        slots (unbounded by default), chained on its own upload through
        the shared-ingress fluid schedule. Downloads cross the shared
        egress and drain in the background: they gate ``flush()``, the
        honest final wall-clock, and (with ``gate_redispatch``) the
        device's own next dispatch — never the aggregation windows.

        All three resources are STATEFUL across aggregation windows:
        flows and jobs live until they finish, and each round re-solves
        over everything still in flight, which both (a) slows this
        cohort by the straggler transfers it overlaps and (b) revises
        the stragglers' own pending commit/download events (the re-key
        step below). Fluid-link finishes only ever move later (extra
        demand cannot speed a transfer up); a finite-slot server queue
        can also move a pending commit EARLIER when a delayed upload
        vacates its FIFO position — both directions are corrections of
        an optimistic pending estimate, never of history: an event that
        already closed a window had every input in the past of every
        later arrival, so no re-solve can disturb the committed
        timeline, and a pending event revised below the current clock
        simply commits in the next window (the staleness forcing still
        bounds its lag)."""
        if self._uplink is None:
            self._uplink = FluidLink(self.cost.shared_uplink_bytes())
            self._downlink = FluidLink(self.cost.shared_downlink_bytes())
            self._srvq = _ServerQueue(self.server_concurrency or math.inf)
        else:
            # retire finished history that can no longer interact with
            # anything schedulable (every new arrival is >= clock0), so
            # the re-solves below cost O(in-flight), not O(all rounds)
            self._uplink.compact(clock0)
            self._downlink.compact(clock0)
            self._srvq.compact(clock0)

        quants = {}
        for c in part:
            dev = self._dev_of(c) or c
            quants[c] = self.cost.phase_cost(
                dev, splits[c], clock0, up_payload=pay_up.get(c),
                down_payload=pay_down.get(c),
                disp_down=disp_down.get(c), disp_up=disp_up.get(c))

        commits, times, phases, comm = {}, {}, {}, 0.0
        self._round_uids = {}
        for c, pc in quants.items():
            if pc is None:             # no decomposition: atomic event
                dev = self._dev_of(c) or c
                disp = (disp_down.get(c, 0.0) + disp_up.get(c, 0.0)
                        if c in disp_down or c in disp_up else None)
                t, nbytes = self.cost.time_and_bytes(
                    dev, splits[c], clock0,
                    payload_bytes=payloads.get(c), dispatch_bytes=disp)
                commits[c] = clock0 + t
                times[c] = t
                comm += nbytes
                continue
            start = clock0
            if self.gate_redispatch:
                start = max(start, self._dev_busy.get(c, 0.0))
            fid = self._uplink.submit(start + pc.t_pre, pc.up_bytes,
                                      pc.up_rate)
            jid = self._srvq.add(math.inf, pc.t_srv)
            fl = _Flight(uid=self._next_uid, cid=c, round=self.round,
                         fid=fid, jid=jid, pc=pc, dispatch=start)
            self._next_uid += 1
            self._flights[fl.uid] = fl
            self._round_uids[c] = fl.uid
            comm += pc.total_bytes

        # one re-solve over everything still in flight: ingress fluid
        # schedule → server FIFO queue → egress fluid schedule
        up_fin = self._uplink.solve()
        for fl in self._flights.values():
            fl.up_end = up_fin[fl.fid]
            self._srvq.set_arrival(fl.jid, up_fin[fl.fid])
        srv_fin = self._srvq.solve()
        for fl in self._flights.values():
            fl.commit = srv_fin[fl.jid]
            if self._downlink.contended and fl.pc.down_bytes:
                if fl.did is None:
                    fl.did = self._downlink.submit(
                        fl.commit, fl.pc.down_bytes, fl.pc.down_rate)
                else:
                    self._downlink.set_arrival(fl.did, fl.commit)
        dn_fin = self._downlink.solve() if self._downlink.contended \
            else None
        for fl in self._flights.values():
            if fl.did is not None:
                fl.dl_end = dn_fin[fl.did] + fl.pc.post_time()
            else:
                # uncontended egress: the legacy closed form, bit-exact
                fl.dl_end = fl.commit + fl.pc.t_down
            busy = self._dev_busy.get(fl.cid, 0.0)
            self._dev_busy[fl.cid] = max(busy, fl.dl_end)

        # carried flights: the re-solve may have revised a straggler's
        # commit — re-key its pending event. Keyed by (dispatch round,
        # work key): the default standalone work keys are bare device
        # cids, which REPEAT when a device is re-dispatched while its
        # old event still pends, and the two dispatches must not feed
        # each other's ready times.
        if self._pending:
            by_key: dict = {}
            for fl in self._flights.values():
                if fl.key is not None:
                    by_key.setdefault((fl.round, fl.key), []).append(fl)
            moved = False
            for e in self._pending:
                fls = by_key.get((e.round, e.key))
                if fls:
                    ready = max(fl.commit for fl in fls)
                    if ready != e.ready:
                        e.ready = ready
                        moved = True
            if moved:
                heapq.heapify(self._pending)

        # this cohort's view: the scheduler observes times, the history
        # carries the phase split
        for c, uid in self._round_uids.items():
            fl = self._flights[uid]
            commits[c] = fl.commit
            times[c] = fl.dl_end - clock0
            phases[c] = {"up": up_fin[fl.fid] - clock0,
                         "srv": fl.commit - up_fin[fl.fid],
                         "down": fl.dl_end - fl.commit}

        # the download heap mirrors the latest estimate for every live
        # flight (every one ends after this round's dispatch clock —
        # drained flights were pruned when their window closed)
        self._downloads = [(fl.dl_end, fl.uid)
                           for fl in self._flights.values()]
        heapq.heapify(self._downloads)
        return commits, times, comm, phases

    def _drain_downloads(self, horizon):
        while self._downloads and self._downloads[0][0] <= horizon:
            heapq.heappop(self._downloads)

    def _prune_flights(self):
        """Drop flights whose commit event has been popped AND whose
        download has drained (their resource jobs stay behind in the
        links/queue until compaction retires them). Matched by
        (dispatch round, work key) — a re-dispatched device reuses its
        bare-cid key, and its drained earlier flight must not be kept
        alive by the new dispatch's pending event."""
        if not self._flights:
            return
        pending = {(e.round, e.key) for e in self._pending}
        gone = [u for u, fl in self._flights.items()
                if (fl.round, fl.key) not in pending
                and fl.dl_end <= self.clock]
        for u in gone:
            del self._flights[u]

    # ------------------------------------------------------ event window
    def _push(self, key, ready):
        heapq.heappush(self._pending,
                       _Event(ready, self._seq, self.round, key))
        self._seq += 1

    def _pop_ready(self, horizon):
        out = []
        while self._pending and self._pending[0].ready <= horizon:
            out.append(heapq.heappop(self._pending))
        return out

    def _item_cluster(self, members) -> int:
        """Edge cluster of a work item = its first member's cluster
        (groups are cluster-pure under the engine's fleet grouping;
        mixed groups inherit the first member's edge)."""
        if self.clusters <= 1:
            return 0
        return self._cluster_of(next(iter(members)))

    def _close_window(self, fresh_items, now: float):
        """``fresh_items``: (ready time, cluster) pairs for this round's
        surviving work items (their events are already in the heap —
        kills may have removed some before the window closes). Returns
        (committed keys, staleness per key in rounds, new clock).

        With ``clusters > 1`` the quorum is hierarchical: each edge
        cluster closes at its own ``cluster_quorum`` quantile over its
        members' ready times, then the main server closes at the
        ``quorum`` quantile over the *cluster* close times — the
        ParallelSFL two-level formulation. ``clusters <= 1`` reproduces
        the flat window bit-for-bit, and so does one-device-per-cluster
        (each cluster time degenerates to its single ready time)."""
        if self.mode == "sync" or self.staleness_cap == 0:
            # barrier: everything dispatched must land this round
            new_clock = max((e.ready for e in self._pending), default=now)
        elif not self._pending:
            return [], {}, now
        else:
            t_quorum = self._quorum_time(fresh_items, now)
            # any event that would exceed the staleness cap by waiting
            # for the NEXT window must be waited for in this one
            forced = [e.ready for e in self._pending
                      if e.round <= self.round - self.staleness_cap]
            new_clock = max([t_quorum, now] + forced)
        done = self._pop_ready(new_clock)
        self.n_committed += len(done)
        committed = [e.key for e in done]
        staleness = {e.key: self.round - e.round for e in done}
        assert all(v <= max(self.staleness_cap, 0)
                   for v in staleness.values()), staleness
        return committed, staleness, new_clock

    def _quorum_time(self, fresh_items, now: float) -> float:
        """Quorum close time over this round's fresh items — flat
        quantile, or the two-level cluster form when clusters > 1."""
        if not fresh_items:
            return now
        if self.clusters > 1:
            by_cluster: dict = {}
            for ready, cl in fresh_items:
                by_cluster.setdefault(cl, []).append(ready)
            t_clusters = []
            for cl in sorted(by_cluster):
                rs = sorted(by_cluster[cl])
                qc = max(1, math.ceil(self.cluster_quorum * len(rs)))
                t_clusters.append(rs[qc - 1])
            t_clusters.sort()
            q = max(1, math.ceil(self.quorum * len(t_clusters)))
            return t_clusters[q - 1]
        readies = sorted(r for r, _ in fresh_items)
        q = max(1, math.ceil(self.quorum * len(readies)))
        return readies[q - 1]

    # --------------------------------------------------- fault injection
    def _kill(self, cid, t: float) -> bool:
        """Device ``cid`` dies at simulated time ``t``: its in-flight
        link flows are abandoned (capacity released at the kill instant,
        survivor schedules before ``t`` untouched), its server work is
        cancelled or orphaned per the plan's ``server_policy``, its
        error-feedback residuals are quarantined on the channel, and
        every pending work item whose dead member had NOT delivered its
        contribution by ``t`` is abandoned — recorded under its
        (dispatch-round, work-key) identity so it can never commit.
        Returns False when the device was already dead (no-op)."""
        if cid in self._dead:
            return False
        self._dead[cid] = self.round
        policy = (self.fault_plan.server_policy
                  if self.fault_plan is not None else "cancel")
        # 1. tear down the device's in-flight resources (pipeline only)
        doomed_fl = [fl for fl in self._flights.values() if fl.cid == cid]
        flight_commit = {}
        for fl in doomed_fl:
            flight_commit[(fl.round, fl.key)] = fl.commit
            up_done = not math.isnan(fl.up_end) and fl.up_end <= t
            self._uplink.abandon(fl.fid, t)
            if not up_done or policy == "cancel":
                # the features never fully arrived, or the policy frees
                # the slot: the job leaves the queue / truncates at t.
                # 'orphan' with a fed job lets the backward run to
                # completion occupying its slot — the result is dropped
                # with the flight either way.
                self._srvq.cancel(fl.jid, t)
            if fl.did is not None:
                self._downlink.abandon(fl.did, t)
            del self._flights[fl.uid]
        if doomed_fl:
            # the download heap must forget the dead device NOW so a
            # same-round flush doesn't wait on an abandoned download
            self._downloads = [(fl.dl_end, fl.uid)
                               for fl in self._flights.values()]
            heapq.heapify(self._downloads)
        # 2. abandon pending work the dead member never delivered: its
        # own commit (live-flight estimate, else the dispatch record)
        # past the kill instant means its gradient contribution was
        # still in flight when it died
        doomed_ev = []
        for e in self._pending:
            mem = self._members.get((e.round, e.key))
            if mem is None or cid not in mem:
                continue
            own = flight_commit.get((e.round, e.key), mem.get(cid))
            if own is None or math.isnan(own) or own > t:
                doomed_ev.append(e)
        if doomed_ev:
            for e in doomed_ev:
                self._pending.remove(e)
                self._abandoned_ids.add((e.round, e.key))
                self._abandoned_now.append(e.key)
            self.n_abandoned += len(doomed_ev)
            heapq.heapify(self._pending)
        # 3. quarantine the device's error-feedback residuals until it
        # rejoins (restored or discarded there, per residual_policy)
        ch = getattr(self.cost, "channel", None)
        if ch is not None and hasattr(ch, "quarantine_residuals"):
            ch.quarantine_residuals(cid)
        if self.recorder is not None and self.recorder.enabled:
            self.recorder.count("driver.kills")
            self.recorder.count("driver.abandons", len(doomed_ev))
        return True

    def _rejoin(self, cid) -> bool:
        """Device ``cid`` comes back before this round's dispatch under
        a FRESH identity: its incarnation counter bumps (a later
        dispatch gets a new (round, key) identity, so nothing stale can
        double-count), its re-dispatch gate resets, and its quarantined
        residuals are restored or discarded per ``residual_policy``.
        Returns False when the device was not dead (no-op)."""
        if cid not in self._dead:
            return False
        del self._dead[cid]
        self._incarnation[cid] = self._incarnation.get(cid, 0) + 1
        self._dev_busy.pop(cid, None)
        ch = getattr(self.cost, "channel", None)
        if ch is not None and hasattr(ch, "release_residuals"):
            restore = (self.fault_plan is None
                       or self.fault_plan.residual_policy == "restore")
            ch.release_residuals(cid, restore=restore)
        if self.recorder is not None and self.recorder.enabled:
            self.recorder.count("driver.rejoins")
        return True

    def flush(self):
        """Wait out every in-flight event (end of training): advances the
        clock past the last pending commit AND the last draining
        download, commits everything. Returns (committed keys, staleness
        dict)."""
        ready = [e.ready for e in self._pending] \
            + [r for r, *_ in self._downloads]
        if not ready:
            return [], {}
        clock0 = self.clock
        new_clock = max(ready)
        done = self._pop_ready(new_clock)
        self.n_committed += len(done)
        self._drain_downloads(new_clock)
        self.clock = max(self.clock, new_clock)
        staleness = {e.key: self.round - 1 - e.round for e in done}
        if self.recorder is not None and self.recorder.enabled:
            # flight spans were already (finally) recorded by the last
            # round's sweep — flush adds no re-solve, only the drain
            # window itself
            self.recorder.window(self.round - 1, clock0, self.clock,
                                 staleness, len(self._pending),
                                 kind="flush")
        self._prune_flights()
        return [e.key for e in done], staleness

    # --------------------------------------------------- checkpoint state
    def export_state(self) -> dict:
        """Everything the timeline needs to resume bit-exactly on an
        identically-configured driver: clock/round/ledger scalars, the
        pending-event and download heaps, live flights (with their
        frozen PhaseCosts), the stateful links/queue, and the
        fault-ledger maps. Config (mode, quorum, devices, cost model,
        fault plan) is NOT serialized — the caller reconstructs it and
        calls ``restore_state``. JSON-safe: every float survives a
        json round-trip bit-exactly (repr-based), dict keys are encoded
        as pair-lists."""
        def _pc(pc: PhaseCost) -> dict:
            return dataclasses.asdict(pc)

        flights = []
        for uid in sorted(self._flights):
            fl = self._flights[uid]
            flights.append({
                "uid": fl.uid, "cid": fl.cid, "round": fl.round,
                "fid": fl.fid, "jid": fl.jid, "did": fl.did,
                "key": fl.key, "commit": fl.commit, "dl_end": fl.dl_end,
                "dispatch": fl.dispatch, "up_end": fl.up_end,
                "pc": _pc(fl.pc)})
        st = {
            "clock": self.clock, "comm": self.comm, "round": self.round,
            "seq": self._seq, "load": self._load,
            "next_uid": self._next_uid,
            "pending": [[e.ready, e.seq, e.round, e.key]
                        for e in sorted(self._pending,
                                        key=lambda e: (e.ready, e.seq))],
            "downloads": sorted(self._downloads),
            "flights": flights,
            "dev_busy": sorted(self._dev_busy.items(),
                               key=lambda kv: str(kv[0])),
            "uplink": (self._uplink.export_state()
                       if self._uplink is not None else None),
            "downlink": (self._downlink.export_state()
                         if self._downlink is not None else None),
            "srvq": (self._srvq.export_state()
                     if self._srvq is not None else None),
            "members": [[[r, k], sorted(v.items(),
                                        key=lambda kv: str(kv[0]))]
                        for (r, k), v in sorted(
                            self._members.items(),
                            key=lambda kv: (kv[0][0], str(kv[0][1])))],
            "dead": sorted(self._dead.items(),
                           key=lambda kv: str(kv[0])),
            "incarnation": sorted(self._incarnation.items(),
                                  key=lambda kv: str(kv[0])),
            "abandoned_ids": sorted([[r, k] for r, k
                                     in self._abandoned_ids],
                                    key=lambda rk: (rk[0], str(rk[1]))),
            "n_dispatched": self.n_dispatched,
            "n_committed": self.n_committed,
            "n_abandoned": self.n_abandoned,
        }
        if hasattr(self.scheduler, "export_state"):
            st["scheduler"] = self.scheduler.export_state()
        if self._history is not None:
            st["history"] = self._history.export_state()
            st["last_split"] = sorted(self._last_split.items(),
                                      key=lambda kv: str(kv[0]))
        if self.knob_controller is not None:
            st["knobs"] = self.knob_controller.export_state()
            st["knobs_applied"] = [self.quorum, self.staleness_cap]
        if self._fleet is not None:
            st["fleet"] = self._fleet.export_state()
        return st

    def restore_state(self, st: dict):
        """Inverse of ``export_state`` on a freshly-constructed,
        identically-configured driver. Keys that were tuples before a
        JSON round-trip come back as lists — re-tupled here so heap
        membership and ledger identity keep working."""
        def _key(k):
            return tuple(k) if isinstance(k, list) else k

        self.clock = float(st["clock"])
        self.comm = float(st["comm"])
        self.round = int(st["round"])
        self._seq = int(st["seq"])
        self._load = int(st["load"])
        self._next_uid = int(st["next_uid"])
        self._pending = [_Event(float(r), int(s), int(rd), _key(k))
                         for r, s, rd, k in st["pending"]]
        heapq.heapify(self._pending)
        self._downloads = [(float(r), int(u)) for r, u in st["downloads"]]
        heapq.heapify(self._downloads)
        self._flights = {}
        for f in st["flights"]:
            pc = PhaseCost(**{k: (None if v is None else float(v))
                              for k, v in f["pc"].items()})
            fl = _Flight(uid=int(f["uid"]), cid=f["cid"],
                         round=int(f["round"]), fid=int(f["fid"]),
                         jid=int(f["jid"]), pc=pc,
                         did=None if f["did"] is None else int(f["did"]),
                         key=_key(f["key"]),
                         commit=float(f["commit"]),
                         dl_end=float(f["dl_end"]),
                         dispatch=float(f["dispatch"]),
                         up_end=float(f["up_end"]))
            self._flights[fl.uid] = fl
        self._round_uids = {}
        self._dev_busy = {c: float(t) for c, t in st["dev_busy"]}
        self._uplink = (FluidLink.from_state(st["uplink"])
                        if st["uplink"] is not None else None)
        self._downlink = (FluidLink.from_state(st["downlink"])
                          if st["downlink"] is not None else None)
        self._srvq = (_ServerQueue.from_state(st["srvq"])
                      if st["srvq"] is not None else None)
        self._members = {(int(r), _key(k)): {c: float(t) for c, t in v}
                         for (r, k), v in st["members"]}
        self._dead = {c: int(r) for c, r in st["dead"]}
        self._incarnation = {c: int(n) for c, n in st["incarnation"]}
        self._abandoned_ids = {(int(r), _key(k))
                               for r, k in st["abandoned_ids"]}
        self.n_dispatched = int(st["n_dispatched"])
        self.n_committed = int(st["n_committed"])
        self.n_abandoned = int(st["n_abandoned"])
        if "scheduler" in st and hasattr(self.scheduler, "restore_state"):
            self.scheduler.restore_state(st["scheduler"])
        if "history" in st and self._history is not None:
            self._history.restore_state(st["history"])
            self._last_split = {c: int(s)
                                for c, s in st["last_split"]}
        if "knobs" in st and self.knob_controller is not None:
            self.knob_controller.restore_state(st["knobs"])
            q, cap = st["knobs_applied"]
            self.quorum = float(q)
            self.staleness_cap = int(cap)
        if "fleet" in st and self._fleet is not None:
            self._fleet.restore_state(st["fleet"])
