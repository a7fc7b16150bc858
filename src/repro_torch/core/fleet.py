"""Batched population state for million-device fleets.

`RoundDriver` iterates Python `_Flight`/`Device` objects per cohort
member — fine for cohorts of tens, hopeless if the *population* had to
be materialized that way at 10^6 devices.  `Fleet` keeps the population
as flat ``(P,)`` numpy tables (device FLOP/s, link elements/s, diurnal
phase, EF-residual mass) plus a *sparse* dead-set, and materializes
`Device` objects lazily — only for the O(active cohort) devices a round
actually samples.  Construction is O(P) once; every per-round operation
(cohort sampling, churn, availability) is O(active cohort + churned),
never O(P).

Exactness contract: ``Fleet.table1(P, seed, composition)`` consumes the
*identical* `numpy.random.Generator` stream as
`simulation.make_device_grid(P, seed, composition)` (same `choice`
calls, and `Generator.shuffle` applies the same permutation to an index
vector as to the materialized list), so ``fleet.device(i)`` equals the
object grid's ``devices[i]`` bit-for-bit.  That is what lets the fleet
driver reproduce the object driver's clock exactly at small N
(`tests/test_fleet.py`; `tests/test_torch_fleet.py` holds these
tables to the reference's).

Every stochastic draw (cohort sampling, churn) derives its Generator
from ``(seed, round)`` so replay after `restore_state` is exact and
independent of call order or history — a mid-run checkpoint restore
resumes the same trace.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.simulation import (
    FLOPS_SETTINGS,
    RATE_SETTINGS,
    SERVER_FLOPS,
    Device,
)

# Domain-separation tags for the per-purpose seed streams.
_TAG_PHASE = 0xD1A2
_TAG_CHURN = 0xC0DE
_TAG_SAMPLE = 0x5EED


class Fleet:
    """(P,) population tables with seeded cohort sampling and churn.

    Parameters
    ----------
    comp, rate : (P,) arrays — device FLOP/s and link elements/s.
    seed : base seed; all internal streams derive from it.
    clusters : number of edge clusters for hierarchical aggregation
        (``cid % clusters``); ``0``/``1`` means flat (no hierarchy).
    diurnal_period : availability period in rounds (0 = always-on).
        Each device gets a random phase; it is available in a
        ``diurnal_duty`` fraction of each period.
    churn_kill_prob / churn_rejoin_prob : per-round per-device death
        probability and per-round per-dead-device revival probability.
        Dead devices are never sampled into a cohort.
    """

    def __init__(self, comp, rate, *, seed: int = 0, clusters: int = 0,
                 diurnal_period: int = 0, diurnal_duty: float = 1.0,
                 churn_kill_prob: float = 0.0,
                 churn_rejoin_prob: float = 0.5):
        comp = np.ascontiguousarray(comp, dtype=np.float64)
        rate = np.ascontiguousarray(rate, dtype=np.float64)
        if comp.ndim != 1 or comp.shape != rate.shape:
            raise ValueError("comp/rate must be equal-length 1-D tables")
        if not 0.0 < diurnal_duty <= 1.0:
            raise ValueError(f"diurnal_duty must be in (0, 1]: {diurnal_duty}")
        self.comp = comp
        self.rate = rate
        self.seed = int(seed)
        self.clusters = int(clusters)
        self.diurnal_period = int(diurnal_period)
        self.diurnal_duty = float(diurnal_duty)
        self.churn_kill_prob = float(churn_kill_prob)
        self.churn_rejoin_prob = float(churn_rejoin_prob)
        rng = np.random.default_rng((self.seed, _TAG_PHASE))
        self.phase = rng.random(self.population)
        # EF residual mass per device (elements pending re-send); the
        # driver folds the channel's per-device figure back in after
        # each round so the table tracks only sampled devices — sparse
        # in practice, dense in storage (8 B/device).
        self.residual_mass = np.zeros(self.population, dtype=np.float64)
        self._dead: dict = {}        # cid -> round killed (sparse)
        self._churn_round = -1       # churn applied through this round

    # ------------------------------------------------------------------
    # construction
    @classmethod
    def table1(cls, population: int, seed: int = 0, composition=None,
               **kwargs) -> "Fleet":
        """Vectorized dual of `simulation.make_device_grid` — same rng
        stream, same kind assignment, identical per-cid devices."""
        n = int(population)
        rng = np.random.default_rng(seed)
        flops_vals = np.array(list(FLOPS_SETTINGS.values()))
        rate_vals = np.array(list(RATE_SETTINGS.values()))
        if composition is None:
            # kinds[k] = (flops_keys[k // 3], rate_keys[k % 3])
            ki = np.arange(n) % (len(flops_vals) * len(rate_vals))
            fi, ri = ki // len(rate_vals), ki % len(rate_vals)
        else:
            quals = list(composition)
            weights = np.array([composition[q] for q in quals], float)
            weights /= weights.sum()
            fq = rng.choice(quals, size=n, p=weights)
            rq = rng.choice(quals, size=n, p=weights)
            flops_keys = list(FLOPS_SETTINGS)
            rate_keys = list(RATE_SETTINGS)
            fi = np.array([flops_keys.index(q) for q in fq])
            ri = np.array([rate_keys.index(q) for q in rq])
        # Generator.shuffle applies the identical permutation to an
        # index vector as it would to the materialized picks list.
        perm = np.arange(n)
        rng.shuffle(perm)
        return cls(flops_vals[fi[perm]], rate_vals[ri[perm]],
                   seed=seed, **kwargs)

    @classmethod
    def from_devices(cls, devices, **kwargs) -> "Fleet":
        """Wrap an existing object grid (cids must be 0..P-1)."""
        devs = sorted(devices, key=lambda d: d.cid)
        if [d.cid for d in devs] != list(range(len(devs))):
            raise ValueError("from_devices needs contiguous 0..P-1 cids")
        return cls([d.comp for d in devs], [d.rate for d in devs], **kwargs)

    # ------------------------------------------------------------------
    # basic views
    @property
    def population(self) -> int:
        return int(self.comp.shape[0])

    @property
    def nbytes(self) -> int:
        """Table storage — the bounded-memory figure benchmarks assert."""
        return int(self.comp.nbytes + self.rate.nbytes
                   + self.phase.nbytes + self.residual_mass.nbytes)

    def device(self, cid) -> Device:
        """Materialize one Device — the only place population state
        becomes a Python object, and only for sampled cids."""
        i = int(cid)
        return Device(cid=i, comp=float(self.comp[i]),
                      rate=float(self.rate[i]))

    def devices_for(self, cids) -> list:
        return [self.device(c) for c in cids]

    def cluster_of(self, cid) -> int:
        return int(cid) % self.clusters if self.clusters > 1 else 0

    def as_torch(self, device) -> dict:
        """Population tables as tensors on ``device`` for accelerator
        consumers (the dtypes of the numpy tables)."""
        import torch
        return {k: torch.as_tensor(getattr(self, k)).to(device)
                for k in ("comp", "rate", "phase", "residual_mass")}

    def eq1_times(self, cids=None, *, wc_size: float, feat_size: float,
                  p: float, fc: float, fs: float) -> np.ndarray:
        """Vectorized Eq. 1 `(2|Wc| + 2 p q)/R + Fc/Comp_c + Fs/Comp_s`
        over `cids` (None = whole population) in one batched call."""
        if cids is None:
            comp, rate = self.comp, self.rate
        else:
            idx = np.asarray(cids, dtype=np.int64)
            comp, rate = self.comp[idx], self.rate[idx]
        return ((2.0 * wc_size + 2.0 * p * feat_size) / rate
                + fc / comp + fs / SERVER_FLOPS)

    # ------------------------------------------------------------------
    # availability / churn
    def dead_set(self) -> set:
        return set(self._dead)

    def kill(self, cid, round_idx: int = 0) -> None:
        self._dead[int(cid)] = int(round_idx)

    def rejoin(self, cid) -> None:
        self._dead.pop(int(cid), None)

    def _is_available(self, cid: int, round_idx: int) -> bool:
        if cid in self._dead:
            return False
        if self.diurnal_period > 0:
            pos = (round_idx / self.diurnal_period + self.phase[cid]) % 1.0
            return bool(pos < self.diurnal_duty)
        return True

    def availability_mask(self, round_idx: int) -> np.ndarray:
        """O(P) dense mask — for tests and reports, not the round loop."""
        mask = np.ones(self.population, dtype=bool)
        if self._dead:
            mask[np.fromiter(self._dead, dtype=np.int64)] = False
        if self.diurnal_period > 0:
            pos = (round_idx / self.diurnal_period + self.phase) % 1.0
            mask &= pos < self.diurnal_duty
        return mask

    def _advance_churn(self, round_idx: int) -> None:
        for r in range(self._churn_round + 1, round_idx + 1):
            self._apply_churn(r)
        self._churn_round = max(self._churn_round, round_idx)

    def _apply_churn(self, r: int):
        """One round of deaths/revivals — O(dead + killed), seeded by
        (seed, round) so restores replay the identical trace."""
        if self.churn_kill_prob <= 0.0 and not self._dead:
            return [], []
        rng = np.random.default_rng((self.seed, r, _TAG_CHURN))
        rejoined = []
        for cid in sorted(self._dead):
            if rng.random() < self.churn_rejoin_prob:
                del self._dead[cid]
                rejoined.append(cid)
        killed = []
        if self.churn_kill_prob > 0.0:
            n_alive = self.population - len(self._dead)
            n_kill = int(rng.binomial(n_alive, self.churn_kill_prob))
            guard = 0
            while len(killed) < n_kill and guard < 64 * (n_kill + 4):
                c = int(rng.integers(self.population))
                guard += 1
                if c not in self._dead:
                    self._dead[c] = r
                    killed.append(c)
        return rejoined, killed

    # ------------------------------------------------------------------
    # cohort sampling
    def sample_cohort(self, round_idx: int, k: int) -> list:
        """Draw k distinct available cids for `round_idx` — O(k)
        expected via rejection sampling against the sparse dead-set,
        with a dense O(P) fallback only if availability is so low the
        rejection budget runs out.  Deterministic in (seed, round)."""
        self._advance_churn(round_idx)
        P = self.population
        k = max(0, min(int(k), P))
        rng = np.random.default_rng((self.seed, round_idx, _TAG_SAMPLE))
        chosen, seen = [], set()
        budget = 64 * max(k, 1) + 256
        while len(chosen) < k and budget > 0:
            batch = rng.integers(P, size=min(budget, max(2 * k, 16)))
            for c in batch:
                c = int(c)
                budget -= 1
                if c in seen or not self._is_available(c, round_idx):
                    continue
                seen.add(c)
                chosen.append(c)
                if len(chosen) == k:
                    break
        if len(chosen) < k:
            mask = self.availability_mask(round_idx)
            for c in rng.permutation(P):
                c = int(c)
                if mask[c] and c not in seen:
                    seen.add(c)
                    chosen.append(c)
                    if len(chosen) == k:
                        break
        return chosen

    def note_residual(self, cid, mass: float) -> None:
        self.residual_mass[int(cid)] = float(mass)

    # ------------------------------------------------------------------
    # checkpoint protocol (JSON-safe, matches driver/channel convention)
    def export_state(self) -> dict:
        nz = np.nonzero(self.residual_mass)[0]
        return {
            "population": self.population,
            "seed": self.seed,
            "churn_round": self._churn_round,
            "dead": sorted([int(c), int(r)] for c, r in self._dead.items()),
            "residual": [[int(c), repr(float(self.residual_mass[c]))]
                         for c in nz],
        }

    def restore_state(self, st: dict) -> None:
        if int(st["population"]) != self.population:
            raise ValueError(
                f"fleet population mismatch: state has "
                f"{st['population']}, table has {self.population}")
        self.seed = int(st["seed"])
        self._churn_round = int(st["churn_round"])
        self._dead = {int(c): int(r) for c, r in st["dead"]}
        self.residual_mass[:] = 0.0
        for c, m in st["residual"]:
            self.residual_mass[int(c)] = float(m)
