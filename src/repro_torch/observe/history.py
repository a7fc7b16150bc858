"""Streaming per-key round-time history — the control plane's input
signal.

``RoundTimeTracker`` keeps, for every key (a device cid in the driver's
use), an exponential moving average plus a bounded window of recent
observations from which it reports quantile bands. The resource-aware
forecast (``core/control.py``) uses the EMA as the projected completion
horizon and the [q_lo, q_hi] band as the uncertainty envelope it prices
candidate splits across: near a fade boundary the band straddles the
fade, so the worst-case-over-band price anticipates the slow regime
before the EMA alone has drifted there.

Everything is plain floats and lists — no numpy state — so the tracker
round-trips bit-exactly through the driver's JSON checkpoint path.
"""
from __future__ import annotations


class RoundTimeTracker:
    """EMA + bounded-window quantile band per key.

    window  recent observations kept per key (oldest dropped first)
    ema     EMA smoothing factor for the central estimate
    q_lo/q_hi  band quantiles (fractions in [0, 1])
    """

    def __init__(self, window: int = 32, ema: float = 0.3,
                 q_lo: float = 0.25, q_hi: float = 0.9):
        if window < 1:
            raise ValueError(f"window must be >= 1: {window}")
        if not 0.0 < ema <= 1.0:
            raise ValueError(f"ema must be in (0, 1]: {ema}")
        if not 0.0 <= q_lo <= q_hi <= 1.0:
            raise ValueError(f"need 0 <= q_lo <= q_hi <= 1: "
                             f"({q_lo}, {q_hi})")
        self.window = int(window)
        self.ema = float(ema)
        self.q_lo = float(q_lo)
        self.q_hi = float(q_hi)
        self._ema: dict = {}       # key -> EMA of observations
        self._recent: dict = {}    # key -> [most recent `window` values]
        self._count: dict = {}     # key -> total observations ever

    def observe(self, key, t: float):
        t = float(t)
        prev = self._ema.get(key)
        self._ema[key] = t if prev is None \
            else (1.0 - self.ema) * prev + self.ema * t
        w = self._recent.setdefault(key, [])
        w.append(t)
        if len(w) > self.window:
            del w[0]
        self._count[key] = self._count.get(key, 0) + 1

    def n(self, key) -> int:
        return self._count.get(key, 0)

    def ema_of(self, key):
        """EMA of observed times for ``key`` (None before the first)."""
        return self._ema.get(key)

    def quantile(self, key, q: float):
        """Linear-interpolated quantile over the recent window."""
        w = self._recent.get(key)
        if not w:
            return None
        xs = sorted(w)
        if len(xs) == 1:
            return xs[0]
        pos = q * (len(xs) - 1)
        i = int(pos)
        frac = pos - i
        if i + 1 >= len(xs):
            return xs[-1]
        return xs[i] * (1.0 - frac) + xs[i + 1] * frac

    def band(self, key):
        """(lo, ema, hi) horizon band for ``key`` — the quantile
        envelope around the EMA the robust forecast evaluates across
        (None before any observation). The band is widened to contain
        the EMA so the central estimate is always priced too."""
        e = self._ema.get(key)
        if e is None:
            return None
        lo = self.quantile(key, self.q_lo)
        hi = self.quantile(key, self.q_hi)
        return (min(lo, e), e, max(hi, e))

    # ------------------------------------------------- checkpoint state
    def export_state(self) -> dict:
        return {"window": self.window, "ema": self.ema,
                "q_lo": self.q_lo, "q_hi": self.q_hi,
                "emas": sorted(self._ema.items(),
                               key=lambda kv: str(kv[0])),
                "recent": sorted(self._recent.items(),
                                 key=lambda kv: str(kv[0])),
                "counts": sorted(self._count.items(),
                                 key=lambda kv: str(kv[0]))}

    def restore_state(self, st: dict):
        self.window = int(st["window"])
        self.ema = float(st["ema"])
        self.q_lo = float(st["q_lo"])
        self.q_hi = float(st["q_hi"])
        self._ema = {k: float(v) for k, v in st["emas"]}
        self._recent = {k: [float(x) for x in w]
                        for k, w in st["recent"]}
        self._count = {k: int(n) for k, n in st["counts"]}
