"""Link models — what transfer rate a device sees at simulated time t —
plus the shared-uplink contention scheduler.

``StaticLink`` is the paper's Table-1 regime (each device keeps its fixed
elements/s rate forever). ``LinkTrace`` is trace-driven: a
piecewise-constant multiplier schedule on top of each device's base rate,
wrapped modulo a period, with an optional per-device phase so devices
fade independently — rounds later in the Eq.-1 clock see different link
quality, and the sliding scheduler's client time table tracks it.

Trace format (see comm/README.md): ascending ``times`` anchors starting
at 0.0 and same-length ``multipliers``; segment i covers
[times[i], times[i+1]) and the last segment runs to ``period`` (default:
``times[-1]`` extended by the previous segment's width, so the final
multiplier always gets a non-empty segment). JSON traces are
``{"times": [...], "multipliers": [...], "period": ...}``.

``shared_link_finish_times`` is the contention model for the phase-level
pipeline (core/driver.py): concurrent uploads to the Main Server share a
finite ingress capacity, split max-min fairly among the active transfers
with each transfer also capped by its device's own link rate. It is a
fluid (processor-sharing) simulation: whenever a transfer starts or
finishes the fair shares are recomputed, so an upload that overlaps many
others is stretched exactly by the observed congestion.

``FluidLink`` wraps the same fluid schedule in a *stateful* per-link
object that carries in-flight flows ACROSS dispatch cohorts: every flow
ever submitted stays in the system and each ``solve()`` re-runs the
max-min fair schedule over all of them, so a straggler's transfer from
an earlier aggregation window contends with (and is slowed by) the next
window's cohort. ``LatencySampler`` draws per-(device, round) message
latencies from a configurable mean-preserving distribution with a
deterministic seed per draw.
"""
from __future__ import annotations

import bisect
import json
import math
import zlib

import numpy as np

# Golden-ratio stride decorrelates per-device phases without RNG state.
_PHI = 0.6180339887498949


class StaticLink:
    name = "static"

    def rate(self, dev, t: float) -> float:
        """elements/s for device ``dev`` at simulated time ``t``."""
        return dev.rate

    def mean_rate(self, dev, t0: float, t1: float) -> float:
        """Average rate over [t0, t1] (constant for a static link) —
        what the predictive scheduler forecast prices a transfer with."""
        return dev.rate


class LinkTrace:
    name = "trace"

    def __init__(self, times, multipliers, *, period: float = 0.0,
                 per_device_phase: bool = True):
        times = [float(x) for x in times]
        multipliers = [float(m) for m in multipliers]
        if not times or len(times) != len(multipliers):
            raise ValueError(
                "LinkTrace needs same-length non-empty times/multipliers "
                "(link='trace' requires trace_file or trace_times); got "
                f"{len(times)} times, {len(multipliers)} multipliers")
        if times[0] != 0.0 or times != sorted(times):
            raise ValueError(f"trace times must ascend from 0.0: {times}")
        if any(m <= 0 for m in multipliers):
            raise ValueError(f"trace multipliers must be > 0: "
                             f"{multipliers}")
        self.times = times
        self.multipliers = multipliers
        if not period:
            # the last anchor opens a segment too: extend it by the
            # previous segment's width (period == times[-1] would make
            # it zero-length and silently drop the final multiplier)
            period = times[-1] + (times[-1] - times[-2]) \
                if len(times) > 1 else 1.0
        self.period = float(period)
        if len(times) > 1 and self.period <= times[-1]:
            raise ValueError(
                f"period {self.period} must exceed the last anchor "
                f"{times[-1]} or its multiplier would never apply")
        self.per_device_phase = per_device_phase
        # cumulative ∫ multiplier over one period, for mean_rate: the
        # last anchor's segment runs to ``period``
        widths = [self.times[i + 1] - self.times[i]
                  for i in range(len(self.times) - 1)]
        widths.append(self.period - self.times[-1])
        self._cum = [0.0]
        for w, m in zip(widths, self.multipliers):
            self._cum.append(self._cum[-1] + w * m)
        self._period_integral = self._cum[-1]

    def multiplier_at(self, t: float, phase: float = 0.0) -> float:
        t = (t + phase) % self.period
        i = bisect.bisect_right(self.times, t) - 1
        return self.multipliers[max(i, 0)]

    def _integral(self, t: float) -> float:
        """∫_0^t multiplier, t unwrapped (t >= 0)."""
        full, rem = divmod(t, self.period)
        i = max(bisect.bisect_right(self.times, rem) - 1, 0)
        return full * self._period_integral + self._cum[i] \
            + self.multipliers[i] * (rem - self.times[i])

    def mean_multiplier(self, t0: float, t1: float,
                        phase: float = 0.0) -> float:
        """Exact time-average of the multiplier over [t0, t1]."""
        if t1 <= t0:
            return self.multiplier_at(t0, phase)
        return (self._integral(t1 + phase) - self._integral(t0 + phase)) \
            / (t1 - t0)

    def mean_rate(self, dev, t0: float, t1: float) -> float:
        """Average elements/s over [t0, t1] — the predictive scheduler
        prices a transfer spanning the projected completion window with
        this instead of the instantaneous rate at dispatch."""
        return dev.rate * self.mean_multiplier(t0, t1,
                                               self._phase(dev.cid))

    def _phase(self, cid) -> float:
        if not self.per_device_phase:
            return 0.0
        return (int(cid) * _PHI % 1.0) * self.period

    def rate(self, dev, t: float) -> float:
        return dev.rate * self.multiplier_at(t, self._phase(dev.cid))

    # ------------------------------------------------------------- io
    @classmethod
    def from_file(cls, path: str, **kw) -> "LinkTrace":
        with open(path) as f:
            spec = json.load(f)
        return cls(spec["times"], spec["multipliers"],
                   period=spec.get("period", 0.0), **kw)

    @classmethod
    def fading(cls, *, n_segments: int = 8, period: float = 400.0,
               lo: float = 0.1, hi: float = 1.0, seed: int = 0,
               per_device_phase: bool = True) -> "LinkTrace":
        """Synthetic deep-fade trace: log-uniform multipliers in [lo, hi]."""
        rng = np.random.default_rng(seed)
        times = [period * i / n_segments for i in range(n_segments)]
        mult = np.exp(rng.uniform(np.log(lo), np.log(hi), n_segments))
        return cls(times, mult.tolist(), period=period,
                   per_device_phase=per_device_phase)


# ---------------------------------------------------------------------------
# shared-uplink contention (the phase pipeline's upload scheduler)
# ---------------------------------------------------------------------------
def _maxmin_rates(active, caps, capacity):
    """Max-min fair allocation of ``capacity`` among ``active`` jobs,
    each additionally capped by its own ``caps[i]`` rate: jobs are
    water-filled from the smallest cap up, so a slow device never blocks
    a fast one from using the leftover capacity."""
    if math.isinf(capacity):
        return {i: caps[i] for i in active}
    rates = {}
    left, k = capacity, len(active)
    for i in sorted(active, key=lambda j: caps[j]):
        r = min(caps[i], left / k)
        rates[i] = r
        left -= r
        k -= 1
    return rates


def fluid_schedule(jobs, capacity=math.inf, until=None):
    """Fluid max-min fair processor-sharing schedule of transfer jobs on
    one shared link.

    jobs: sequence of ``(arrival_s, size_bytes, own_rate_bytes_per_s)``;
    capacity: the link's total bytes/s (``math.inf`` = uncontended, each
    job runs at its own rate). Returns ``(finish, remaining)`` in job
    order: with ``until=None`` the schedule runs to completion
    (``remaining`` all zero); with a finite ``until`` the simulation is
    right-censored there — unfinished jobs report ``math.inf`` and their
    bytes still in flight at ``until`` (the cross-window byte-
    conservation quantity the property suite checks).

    With infinite capacity jobs never interact and the schedule is the
    closed form ``arrival + size / own_rate`` — bit-exact with the
    uncontended seed path.
    """
    n = len(jobs)
    if n == 0:
        return [], []
    if capacity <= 0:
        raise ValueError(f"shared link capacity must be > 0: {capacity}")
    arrive = [float(a) for a, _, _ in jobs]
    left = [float(b) for _, b, _ in jobs]
    caps = [float(r) for _, _, r in jobs]
    if any(r <= 0 for r in caps):
        raise ValueError(f"job rate caps must be > 0: {caps}")
    if math.isinf(capacity):
        finish = [a + b / r for a, b, r in zip(arrive, left, caps)]
        if until is None:
            return finish, [0.0] * n
        rem = [b if a >= until else max(0.0, b - r * (until - a))
               for a, b, r in zip(arrive, left, caps)]
        return [f if f <= until else math.inf for f in finish], rem
    finish = [0.0] * n
    done_eps = [max(1e-9, 1e-12 * b) for b in left]
    todo = set(range(n))
    for i in list(todo):               # zero-byte jobs land on arrival
        if left[i] <= done_eps[i]:
            finish[i] = arrive[i]
            left[i] = 0.0
            todo.discard(i)
    if todo:
        t = min(arrive[i] for i in todo)
        while todo and not (until is not None and t >= until):
            active = [i for i in todo if arrive[i] <= t]
            if not active:
                t = min(arrive[i] for i in todo)
                continue
            rates = _maxmin_rates(active, caps, capacity)
            t_fin = min(t + left[i] / rates[i] for i in active)
            future = [arrive[i] for i in todo if arrive[i] > t]
            t_next = min([t_fin] + ([min(future)] if future else [])
                         + ([until] if until is not None else []))
            if t_next <= t:
                # FP-resolution guard: the nearest event is closer than
                # the clock's representable step at t (a carried flow's
                # tail can be sub-ulp once t is large), so time cannot
                # advance — the nearest job is done for all practical
                # purposes; land it at t to guarantee progress.
                i = min(active, key=lambda j: left[j] / rates[j])
                finish[i] = t
                left[i] = 0.0
                todo.discard(i)
                continue
            for i in active:
                left[i] -= rates[i] * (t_next - t)
            t = t_next
            for i in active:
                if left[i] <= done_eps[i]:
                    finish[i] = t
                    left[i] = 0.0
                    todo.discard(i)
    for i in todo:                     # right-censored at ``until``
        finish[i] = math.inf
    return finish, left


def shared_link_finish_times(jobs, capacity=math.inf):
    """Finish times of transfer jobs on a shared link (fluid max-min
    fair processor sharing) — the one-cohort view of ``fluid_schedule``.
    With infinite capacity this degenerates exactly to
    ``arrival + size / own_rate``."""
    return fluid_schedule(jobs, capacity)[0]


def retire_prefix(live, finishes, arrivals, now):
    """The shared retirement rule of the stateful resources
    (``FluidLink`` / the driver's server queue): among the ``live``
    ids, find the longest finish-sorted prefix whose finishes ALL
    predate both ``now`` (no future submission arrives earlier — the
    driver dispatches at arrivals >= its clock) and every kept id's
    arrival. Such a prefix can never have overlapped anything still
    schedulable, so dropping it leaves every kept schedule
    bit-identical. Returns (retired ids, kept ids). Under sustained
    overlap with no quiet point nothing retires — correctly, since
    everything still interacts through the shared resource."""
    order = sorted(live, key=lambda i: finishes[i])
    n = len(order)
    suffix_min = [math.inf] * (n + 1)
    for i in range(n - 1, -1, -1):
        suffix_min[i] = min(suffix_min[i + 1], arrivals[order[i]])
    cut = 0
    for i, f in enumerate(order):
        if finishes[f] > now:
            break
        if finishes[f] <= suffix_min[i + 1]:
            cut = i + 1
    return order[:cut], order[cut:]


class FluidLink:
    """A shared link that carries in-flight flows across dispatch
    cohorts (aggregation windows).

    Unlike a one-shot ``shared_link_finish_times`` call — which solves
    each cohort in isolation, so a straggler's transfer from an earlier
    window never slows the next window's — a ``FluidLink`` accumulates
    the flows submitted to it and ``solve()`` re-runs the max-min fair
    fluid schedule over all of them. Finish times of still-in-flight
    flows therefore shift *later* (never earlier: extra demand cannot
    speed anyone up) as new cohorts arrive, and the driver reconciles
    its pending events against the re-solve each round. Flows whose
    finish predates every later arrival recompute to bit-identical
    values, which is what keeps already-closed windows consistent — and
    is also what lets ``compact()`` retire them outright (finishes
    served from a cache afterwards), so the per-round re-solve cost is
    bounded by the flows still interacting rather than the full
    history.

    Flow arrivals may be revised via ``set_arrival`` while a flow is
    still pending (the pipelined driver does this for downlink flows,
    whose arrival is the commit event of a server-compute job that a
    re-solve may shift).
    """

    def __init__(self, capacity: float = math.inf):
        if capacity <= 0:
            raise ValueError(f"link capacity must be > 0: {capacity}")
        self.capacity = float(capacity)
        self._arrive: list = []
        self._bytes: list = []
        self._caps: list = []
        self._live: list = []          # fids still in the schedule
        self._finish_cache: dict = {}  # retired fid -> finish
        self.n_solves = 0              # fluid re-solve calls (telemetry)
        self.n_retired = 0             # flows retired by compact()
        self.abandoned_bytes = 0.0     # undelivered bytes of killed flows

    def __len__(self):
        return len(self._arrive)

    @property
    def contended(self) -> bool:
        return not math.isinf(self.capacity)

    @property
    def submitted_bytes(self) -> float:
        return sum(self._bytes)

    def submit(self, arrival: float, nbytes: float, rate: float) -> int:
        """Register a flow; returns its id (index into solve() output)."""
        if rate <= 0:
            raise ValueError(f"flow rate must be > 0: {rate}")
        self._arrive.append(float(arrival))
        self._bytes.append(float(nbytes))
        self._caps.append(float(rate))
        self._live.append(len(self._arrive) - 1)
        return len(self._arrive) - 1

    def set_arrival(self, fid: int, arrival: float):
        self._arrive[fid] = float(arrival)

    def abandon(self, fid: int, t: float) -> float:
        """Tear down flow ``fid`` at time ``t`` (its device died): bytes
        already drained stay drained, the undelivered remainder is
        dropped and metered under ``abandoned_bytes``. Returns the bytes
        abandoned.

        Truncating the flow's size to exactly what it had drained by
        ``t`` leaves every survivor's schedule before ``t`` unchanged
        (the active sets — and hence the max-min rates — are identical
        up to the instant the flow empties), makes the abandoned flow
        finish exactly at ``t``, and releases its capacity share from
        that instant on: survivors can only speed up. A flow that never
        started (arrival > t) is dropped whole and lands empty at its
        arrival, contending with nothing. Already-finished or retired
        flows are a no-op."""
        if fid in self._finish_cache:
            return 0.0                 # retired: fully drained long ago
        rem = self.remaining_at(t)[fid]
        if rem <= 0.0:
            return 0.0                 # delivered before the kill
        self._bytes[fid] -= rem
        self.abandoned_bytes += rem
        return rem

    def solve(self):
        """Finish times of ALL flows (retired ones from the cache),
        assuming no future arrivals."""
        self.n_solves += 1
        fins = [0.0] * len(self._arrive)
        for f, fin in self._finish_cache.items():
            fins[f] = fin
        jobs = [(self._arrive[f], self._bytes[f], self._caps[f])
                for f in self._live]
        for f, fin in zip(self._live,
                          fluid_schedule(jobs, self.capacity)[0]):
            fins[f] = fin
        return fins

    def remaining_at(self, t: float):
        """Per-flow bytes still in flight at time ``t`` (a flow that has
        not arrived yet reports its full size; a retired flow reports
        0.0, so after ``compact(now)`` this is exact for t >= now).
        Conservation — ``submitted_bytes == drained +
        sum(remaining_at(t))`` with the drain rate never exceeding the
        capacity — is property-tested in
        tests/test_driver_properties.py."""
        rem = [0.0] * len(self._arrive)
        jobs = [(self._arrive[f], self._bytes[f], self._caps[f])
                for f in self._live]
        for f, r in zip(self._live,
                        fluid_schedule(jobs, self.capacity, until=t)[1]):
            rem[f] = r
        return rem

    def compact(self, now: float):
        """Retire flows that can no longer influence any current or
        future schedule (see ``retire_prefix``); their finishes move to
        a cache that ``solve()`` keeps serving."""
        if len(self._live) <= 1:
            return
        fins = self.solve()
        retired, kept = retire_prefix(self._live, fins, self._arrive, now)
        if retired:
            for f in retired:
                self._finish_cache[f] = fins[f]
            self._live = kept
            self.n_retired += len(retired)

    def backlog_at(self, t: float):
        """(active flow count, bytes still in flight) at time ``t`` —
        the load the resource-aware forecast sees already draining on
        this link before the next cohort even dispatches. A flow counts
        as active when it has arrived and still holds bytes; flows that
        have not arrived yet are excluded (they are the future, not the
        backlog). Observational only (one right-censored solve)."""
        rem = self.remaining_at(t)
        active = [f for f in self._live
                  if self._arrive[f] <= t and rem[f] > 0.0]
        return len(active), sum(rem[f] for f in active)

    def utilization(self, t0: float, t1: float) -> float:
        """Fraction of the link capacity actually used over [t0, t1]:
        bytes drained by live flows in the interval over
        ``capacity * (t1 - t0)``. 0.0 on an uncontended (infinite-
        capacity) link or an empty interval. Observational only (two
        right-censored solves); retired flows report zero remaining at
        both ends and transferred nothing in any interval past their
        retirement, so the difference stays exact."""
        if t1 <= t0 or not self.contended:
            return 0.0
        drained = sum(self.remaining_at(t0)) - sum(self.remaining_at(t1))
        return max(0.0, drained) / (self.capacity * (t1 - t0))

    # ------------------------------------------------ checkpoint state
    def export_state(self) -> dict:
        """JSON-serializable snapshot of every flow (including retired
        history) — restoring it reproduces each subsequent solve()
        bit-exactly (Python floats round-trip exactly through repr-based
        JSON, and the fluid schedule is a deterministic function of the
        flow table)."""
        return {"capacity": self.capacity,
                "arrive": list(self._arrive),
                "bytes": list(self._bytes),
                "caps": list(self._caps),
                "live": list(self._live),
                "finish_cache": [[f, fin] for f, fin
                                 in sorted(self._finish_cache.items())],
                "n_solves": self.n_solves,
                "n_retired": self.n_retired,
                "abandoned_bytes": self.abandoned_bytes}

    @classmethod
    def from_state(cls, st: dict) -> "FluidLink":
        link = cls(st["capacity"])
        link._arrive = [float(x) for x in st["arrive"]]
        link._bytes = [float(x) for x in st["bytes"]]
        link._caps = [float(x) for x in st["caps"]]
        link._live = [int(f) for f in st["live"]]
        link._finish_cache = {int(f): float(fin)
                              for f, fin in st["finish_cache"]}
        link.n_solves = int(st["n_solves"])
        link.n_retired = int(st["n_retired"])
        link.abandoned_bytes = float(st["abandoned_bytes"])
        return link


# ---------------------------------------------------------------------------
# per-(device, round) latency draws
# ---------------------------------------------------------------------------
LATENCY_DISTS = ("constant", "uniform", "lognormal", "exp")


def _seed_int(cid) -> int:
    try:
        return int(cid)
    except (TypeError, ValueError):
        # stable across interpreter runs (built-in hash() is salted by
        # PYTHONHASHSEED and would break the replay guarantee)
        return zlib.crc32(str(cid).encode("utf-8"))


class LatencySampler:
    """Per-(device, round) message-latency draws.

    Every distribution is mean-preserving around ``base`` (turning a
    distribution on changes the spread of transport delay, not its
    average), and every draw is seeded by the ``(seed, cid, round)``
    triple — a fixed-seed replay reproduces each device-round's latency
    exactly, regardless of dispatch order or how many times the cost
    model re-prices the round.

      constant   always ``base`` (the seed regime — no RNG touched)
      uniform    base · U[1 − jitter, 1 + jitter]
      lognormal  base · exp(jitter · N(0,1) − jitter²/2)
      exp        base · Exp(1)  (jitter ignored)
    """

    def __init__(self, base: float = 0.0, dist: str = "constant",
                 jitter: float = 0.5, seed: int = 0):
        if dist not in LATENCY_DISTS:
            raise ValueError(f"unknown latency distribution {dist!r}; "
                             f"known: {LATENCY_DISTS}")
        if base < 0:
            raise ValueError(f"latency must be >= 0: {base}")
        if not 0.0 <= jitter <= 1.0:
            raise ValueError(f"latency jitter must be in [0, 1]: {jitter}")
        self.base = float(base)
        self.dist = dist
        self.jitter = float(jitter)
        self.seed = int(seed)

    @property
    def mean(self) -> float:
        return self.base

    def sample(self, cid, rnd: int = 0) -> float:
        if self.dist == "constant" or self.base == 0.0:
            return self.base
        rng = np.random.default_rng(
            (self.seed, _seed_int(cid), int(rnd)))
        if self.dist == "uniform":
            j = self.jitter
            return self.base * (1.0 - j + 2.0 * j * float(rng.random()))
        if self.dist == "lognormal":
            s = self.jitter
            return self.base * math.exp(
                s * float(rng.standard_normal()) - 0.5 * s * s)
        return self.base * float(rng.exponential(1.0))


def get_link(name: str = "static", **kw):
    if name == "static":
        return StaticLink()
    if name == "trace":
        return LinkTrace(**kw)
    raise KeyError(f"unknown link model {name!r}; known: static, trace")
