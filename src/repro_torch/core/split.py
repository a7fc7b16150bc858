"""SplitPlan — the paper's three-portion model division (§3, §3.1).

The full model's sequential units are divided into:
  client-side portion : units [0, min(split_points))   — always on device
  shared portion      : units [min, max(split_points)) — slides per device
  server-side portion : units [max(split_points), n)   — always on server

A split index ``s`` (one of the K candidate split points) assigns
``stem + units[:s]`` to the client. The paper uses K=3 split layers per
model; K is configurable here.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    n_units: int
    split_points: tuple          # ascending candidate split indices

    def __post_init__(self):
        assert self.split_points == tuple(sorted(set(self.split_points)))
        assert all(0 < s <= self.n_units for s in self.split_points)

    @property
    def k(self) -> int:
        return len(self.split_points)

    @property
    def client_side_end(self) -> int:      # end of always-client portion
        return min(self.split_points)

    @property
    def shared_end(self) -> int:           # end of shared portion
        return max(self.split_points)

    def __contains__(self, split: int) -> bool:
        """True when ``split`` is one of the K candidate split points —
        the RoundDriver validates every scheduler selection with this."""
        return split in self.split_points

    def smallest(self) -> int:
        return self.split_points[0]

    def largest(self) -> int:
        return self.split_points[-1]


def default_plan(n_units: int, k: int = 3,
                 fractions=(0.125, 0.25, 0.5)) -> SplitPlan:
    """K split points in the shallow half of the stack (client devices are
    resource-constrained — the paper's Figure 3 splits are all shallow)."""
    fr = fractions[:k] if len(fractions) >= k else tuple(
        (i + 1) / (k + 1) * 0.5 for i in range(k))
    pts = sorted({max(1, round(n_units * f)) for f in fr})
    # guarantee k distinct points on shallow stacks
    nxt = 1
    while len(pts) < k and nxt <= n_units:
        if nxt not in pts:
            pts.append(nxt)
        nxt += 1
    return SplitPlan(n_units=n_units, split_points=tuple(sorted(pts)[:k]))
