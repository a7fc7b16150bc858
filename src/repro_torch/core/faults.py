"""FaultPlan — deterministic, seeded device kill/rejoin schedules for the
RoundDriver (plus a random-process generator), the churn model the
production-ops roadmap item asks for.

A plan is a set of round-indexed events:

    kill    the device dies. ``at=None`` kills it before the round's
            dispatch (it is filtered from the cohort and any in-flight
            straggler work from earlier rounds is abandoned at the
            current clock); ``at`` in [0, 1] kills it MID-FLIGHT — the
            kill instant interpolates between the round's dispatch clock
            and the round's last fresh commit estimate, so the device's
            freshly dispatched work is torn down while its transfers are
            on the wire.
    rejoin  the device comes back before the round's dispatch under a
            FRESH identity (the driver bumps its incarnation counter, so
            a stale upload from the dead incarnation can never
            double-count), with its quarantined error-feedback residuals
            either restored or discarded per ``residual_policy``.

Failure semantics on kill (enforced by ``RoundDriver._kill``):

  * in-flight ``FluidLink`` flows are abandoned at the kill instant —
    bytes already drained stay drained (survivor schedules before the
    kill are untouched), the undelivered remainder is metered as
    abandoned and the capacity it held is released;
  * queued/running server work follows ``server_policy``: ``'cancel'``
    frees the slot at the kill instant, ``'orphan'`` lets an
    already-fed backward run to completion (occupying its slot) with
    the result dropped;
  * the device's error-feedback residuals are quarantined on the
    channel; on rejoin they are restored (``residual_policy='restore'``)
    or discarded with their L2 mass metered (``'discard'``);
  * every work item (aggregation-window key) the device contributes to
    that has not yet committed is abandoned exactly once — the driver's
    exactly-once ledger guarantees commits + abandons == dispatches.

See the reference's src/repro/core/README.md §Failure semantics for the
lifecycle diagram.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional

import numpy as np

KINDS = ("kill", "rejoin")
SERVER_POLICIES = ("cancel", "orphan")
RESIDUAL_POLICIES = ("restore", "discard")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    round: int                 # dispatch round the event applies to
    cid: object                # device id
    kind: str                  # 'kill' | 'rejoin'
    at: Optional[float] = None  # kill only: None = before dispatch;
    #                          # fraction in [0, 1] = mid-flight instant

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"fault kind {self.kind!r}; known: {KINDS}")
        if self.round < 0:
            raise ValueError(f"fault round must be >= 0: {self.round}")
        if self.at is not None:
            if self.kind != "kill":
                raise ValueError("'at' only applies to kill events")
            if not 0.0 <= self.at <= 1.0:
                raise ValueError(f"kill 'at' must be in [0, 1]: {self.at}")


class FaultPlan:
    """An immutable kill/rejoin schedule plus the two recovery policies.

    ``events`` may arrive in any order; they are applied per round in
    (round, cid) order with rejoins before kills, so a same-round
    rejoin+kill means the device flaps within one round
    deterministically.
    """

    def __init__(self, events=(), *, server_policy: str = "cancel",
                 residual_policy: str = "restore"):
        if server_policy not in SERVER_POLICIES:
            raise ValueError(f"server_policy {server_policy!r}; "
                             f"known: {SERVER_POLICIES}")
        if residual_policy not in RESIDUAL_POLICIES:
            raise ValueError(f"residual_policy {residual_policy!r}; "
                             f"known: {RESIDUAL_POLICIES}")
        self.server_policy = server_policy
        self.residual_policy = residual_policy
        evs = [e if isinstance(e, FaultEvent) else FaultEvent(**e)
               for e in events]
        self._by_round: dict = {}
        order = {"rejoin": 0, "kill": 1}
        for e in sorted(evs, key=lambda e: (e.round, order[e.kind],
                                            str(e.cid))):
            self._by_round.setdefault(e.round, []).append(e)
        self.events = tuple(e for r in sorted(self._by_round)
                            for e in self._by_round[r])

    def __len__(self):
        return len(self.events)

    def for_round(self, r: int) -> tuple:
        return tuple(self._by_round.get(r, ()))

    # ------------------------------------------------------ generation
    @classmethod
    def random(cls, cids, rounds: int, *, seed: int = 0,
               kill_prob: float = 0.1, rejoin_prob: float = 0.5,
               mid_flight_frac: float = 0.5,
               server_policy: str = "cancel",
               residual_policy: str = "restore") -> "FaultPlan":
        """The random-process mode: per round, each alive device dies
        with ``kill_prob`` (a ``mid_flight_frac`` share of kills strike
        mid-flight at a uniform fraction of the round, the rest before
        dispatch) and each dead device rejoins with ``rejoin_prob``.
        Fully determined by ``seed`` — the same draw stream regardless
        of what the driver does with the events."""
        if not 0.0 <= kill_prob <= 1.0:
            raise ValueError(f"kill_prob must be in [0, 1]: {kill_prob}")
        if not 0.0 <= rejoin_prob <= 1.0:
            raise ValueError(
                f"rejoin_prob must be in [0, 1]: {rejoin_prob}")
        rng = np.random.default_rng(seed)
        cids = list(cids)
        dead: set = set()
        events = []
        for r in range(rounds):
            for cid in cids:
                if cid in dead:
                    if rng.random() < rejoin_prob:
                        events.append(FaultEvent(r, cid, "rejoin"))
                        dead.discard(cid)
                elif rng.random() < kill_prob:
                    at = (float(rng.uniform(0.0, 1.0))
                          if rng.random() < mid_flight_frac else None)
                    events.append(FaultEvent(r, cid, "kill", at=at))
                    dead.add(cid)
        return cls(events, server_policy=server_policy,
                   residual_policy=residual_policy)

    # -------------------------------------------------------------- io
    def to_dict(self) -> dict:
        return {"server_policy": self.server_policy,
                "residual_policy": self.residual_policy,
                "events": [dataclasses.asdict(e) for e in self.events]}

    @classmethod
    def from_dict(cls, d: dict) -> "FaultPlan":
        return cls(d.get("events", ()),
                   server_policy=d.get("server_policy", "cancel"),
                   residual_policy=d.get("residual_policy", "restore"))

    def to_file(self, path: str):
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1)

    @classmethod
    def from_file(cls, path: str) -> "FaultPlan":
        with open(path) as f:
            return cls.from_dict(json.load(f))
