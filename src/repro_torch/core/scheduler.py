"""Adaptive sliding model split strategy (§3.1).

The Fed Server maintains a **client time table**: for every (client,
split-point) pair, the measured wall time of a full training round with
that client model portion. The first K rounds are a warm-up that traverses
all K split points (all clients use the same split in a warm-up round).
Afterwards, each round:

  1. collect the participating clients' recorded times for every split
     (x * K values), take the MEDIAN;
  2. each client gets the split whose recorded time is closest to the
     median (stragglers get small portions, fast devices big ones);
  3. on round completion, the table is updated with the observed time
     (EMA so drifting device load is tracked).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.split import SplitPlan


@dataclasses.dataclass
class ClientTimeTable:
    """times[cid][split] = EMA of observed round times."""
    ema: float = 0.5

    def __post_init__(self):
        self._t: dict = {}

    def update(self, cid, split: int, t: float):
        d = self._t.setdefault(cid, {})
        d[split] = (1 - self.ema) * d[split] + self.ema * t \
            if split in d else t

    def get(self, cid, split: int):
        return self._t.get(cid, {}).get(split)

    def known_splits(self, cid):
        return sorted(self._t.get(cid, {}))


class SlidingSplitScheduler:
    def __init__(self, plan: SplitPlan, ema: float = 0.5, forecast=None):
        self.plan = plan
        self.table = ClientTimeTable(ema=ema)
        self.round = 0
        # optional predictive hook (RoundDriver wires it when
        # predictive=True): forecast(cid, split, ema_time) -> predicted
        # round time with the link model's rate at the projected
        # completion window, None -> trust the EMA entry.
        self.forecast = forecast

    def _time(self, cid, split: int):
        """Candidate time for (cid, split): the EMA table entry, passed
        through the forecast hook when one is installed."""
        t = self.table.get(cid, split)
        if t is None:
            return None
        if self.forecast is not None:
            ft = self.forecast(cid, split, t)
            if ft is not None:
                return float(ft)
        return t

    @property
    def warming_up(self) -> bool:
        return self.round < self.plan.k

    def warmup_split(self) -> int:
        """§3.1: in the first K rounds the Fed Server sends the same split
        to ALL devices (the warm-up populates the whole time table; the
        engine/simulator observes every device's Eq.-1 time during these
        rounds, not just the sampled participants')."""
        return self.plan.split_points[self.round % self.plan.k]

    def select(self, participants) -> dict:
        """-> {cid: split} for this round."""
        if self.warming_up:
            s = self.warmup_split()
            return {c: s for c in participants}
        t = self._candidate_times(participants)
        times = [v for v in t.values() if v is not None]
        if not times:                       # nothing measured yet: smallest
            return {c: self.plan.smallest() for c in participants}
        median = float(np.median(times))
        out = {}
        for c in participants:
            known = [(s, t[c, s]) for s in self.plan.split_points
                     if t[c, s] is not None]
            if not known:
                out[c] = self.plan.smallest()
                continue
            out[c] = min(known, key=lambda st: abs(st[1] - median))[0]
        return out

    def _candidate_times(self, participants) -> dict:
        """{(cid, split): time-or-None} — one _time() evaluation per
        pair (the predictive forecast prices a trace integral per call,
        so selects must not re-query the same candidate)."""
        return {(c, s): self._time(c, s) for c in participants
                for s in self.plan.split_points}

    def observe(self, cid, split: int, t: float):
        self.table.update(cid, split, t)

    def end_round(self):
        self.round += 1

    # ------------------------------------------------- checkpoint state
    def export_state(self) -> dict:
        """Round counter + the full EMA time table, JSON-safe (int-keyed
        dicts as pair-lists; floats round-trip bit-exactly)."""
        return {"round": self.round,
                "table": [[cid, sorted(d.items())] for cid, d
                          in sorted(self.table._t.items(),
                                    key=lambda kv: str(kv[0]))]}

    def restore_state(self, st: dict):
        self.round = int(st["round"])
        self.table._t = {cid: {int(s): float(t) for s, t in d}
                         for cid, d in st["table"]}


class MinTimeScheduler(SlidingSplitScheduler):
    """BEYOND-PAPER variant: after warm-up each device picks the split
    minimizing ITS OWN recorded time, instead of matching the median.

    Rationale: the round wall-clock is max_i T_i, and per-device argmin
    greedily minimizes every T_i, hence the max — median matching can
    deliberately slow fast devices AND pick a slow split for stragglers
    whose time curve is non-monotone in split size (small models with
    large early feature maps, e.g. ResNet8/MobileNet — see
    EXPERIMENTS.md §Perf-scheduler). Equalization (the paper's stated
    goal) is a side effect of lowering everyone's time toward the same
    floor, not an objective worth paying wall-clock for."""

    def select(self, participants) -> dict:
        if self.warming_up:
            return super().select(participants)
        t = self._candidate_times(participants)
        out = {}
        for c in participants:
            known = [(s, t[c, s]) for s in self.plan.split_points
                     if t[c, s] is not None]
            if not known:
                out[c] = self.plan.smallest()
            else:
                out[c] = min(known, key=lambda st: st[1])[0]
        return out


class JointKnobScheduler(MinTimeScheduler):
    """AdaptSFL/HASFL-style joint tuning: the candidate space is the
    cross product of split points and per-client batch FRACTIONS, and
    each device picks the pair minimizing its forecast time — with a
    data-preserving tie rule: among candidates within
    ``frac_tolerance`` of the fastest, the LARGEST batch fraction wins,
    so a marginal time win never silently sacrifices training samples.

    Pricing a fraction needs a forecaster that understands how compute
    and payload scale with the sample count; the driver installs
    ``forecast_frac(cid, split, ema_t, frac)`` in resource-aware mode
    (``core/control.py``). Without it, fractions are not priced and the
    selection degenerates to MinTime at full batch — the knob only
    activates alongside a physics-aware forecast, never on a blind EMA.

    ``selected_fracs`` ({cid: frac}, rebuilt by every ``select``) is
    the consumers' surface: the driver wires it into the cost model's
    ``frac_of`` hook and the engine scales its real batches with it."""

    def __init__(self, plan: SplitPlan, ema: float = 0.5, forecast=None,
                 batch_fracs=(1.0, 0.75, 0.5),
                 frac_tolerance: float = 0.1):
        super().__init__(plan, ema=ema, forecast=forecast)
        fracs = sorted({float(f) for f in batch_fracs}, reverse=True)
        if not fracs or any(not 0.0 < f <= 1.0 for f in fracs):
            raise ValueError(f"batch fracs must be in (0, 1]: "
                             f"{batch_fracs}")
        if frac_tolerance < 0.0:
            raise ValueError(f"frac_tolerance must be >= 0: "
                             f"{frac_tolerance}")
        self.batch_fracs = tuple(fracs)
        self.frac_tolerance = float(frac_tolerance)
        self.selected_fracs: dict = {}
        # installed by the driver in resource-aware mode:
        # (cid, split, ema_t, frac) -> predicted time, None = unpriced
        self.forecast_frac = None

    def _frac_time(self, cid, split, t, frac):
        if self.forecast_frac is not None:
            ft = self.forecast_frac(cid, split, t, frac)
            if ft is not None:
                return float(ft)
        return None

    def select(self, participants) -> dict:
        # selection must see the UNSCALED p_of: consumers read the
        # previous round's fracs through this dict, so clear it first
        self.selected_fracs = {}
        if self.warming_up or self.forecast_frac is None:
            out = super().select(participants)
            for c in participants:
                self.selected_fracs[c] = self.batch_fracs[0]
            return out
        t = self._candidate_times(participants)
        out = {}
        for c in participants:
            cands = []
            for s in self.plan.split_points:
                if t[c, s] is None:
                    continue
                for f in self.batch_fracs:
                    tf = self._frac_time(c, s, t[c, s], f)
                    cands.append((s, f, t[c, s] if tf is None else tf))
            if not cands:
                out[c] = self.plan.smallest()
                self.selected_fracs[c] = self.batch_fracs[0]
                continue
            best = min(tt for _, _, tt in cands)
            ok = [cand for cand in cands
                  if cand[2] <= best * (1.0 + self.frac_tolerance)]
            s, f, _ = min(ok, key=lambda cand: (-cand[1], cand[2]))
            out[c] = s
            self.selected_fracs[c] = f
        return out


class FixedSplitScheduler:
    """SFL baseline / S²FL+B ablation: everyone trains the largest client
    portion every round (the paper's SFL trains Wc_3)."""

    def __init__(self, plan: SplitPlan, split: int | None = None):
        self.plan = plan
        self.split = split if split is not None else plan.largest()
        self.round = 0
        self.table = ClientTimeTable()

    @property
    def warming_up(self) -> bool:
        return False

    def select(self, participants):
        return {c: self.split for c in participants}

    def observe(self, cid, split, t):
        self.table.update(cid, split, t)

    def end_round(self):
        self.round += 1

    export_state = SlidingSplitScheduler.export_state
    restore_state = SlidingSplitScheduler.restore_state
