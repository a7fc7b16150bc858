"""Data balance-based training mechanism (§3.2, Eq. 2).

The Main Server sees per-client label histograms (labels ride along with
features in SFL-V2 semantics) and groups the x participating clients so
each group's combined label distribution is as close to uniform as
possible, measured by

    Dist(G) = || sum_{c in G} D_c / |sum| - 1/n ||_2            (Eq. 2)

The paper specifies the objective, not the algorithm; we use greedy
seeding (most-skewed client first, then repeatedly add the client that
most reduces the distance) followed by a single-pass swap refinement.
An exhaustive search oracle is provided for small x (used in tests to
bound the greedy gap).
"""
from __future__ import annotations

import itertools

import numpy as np


def eq2_distance(hist_sum: np.ndarray) -> float:
    """Eq. 2 on an (n_classes,) combined count vector."""
    total = hist_sum.sum()
    if total == 0:
        return float(np.sqrt(len(hist_sum))) / len(hist_sum)
    p = hist_sum / total
    return float(np.linalg.norm(p - 1.0 / len(hist_sum)))


def group_distance(hists, group) -> float:
    return eq2_distance(np.sum([hists[c] for c in group], axis=0))


def greedy_groups(hists, group_size: int):
    """hists: (x, n_classes) counts. Returns list of groups (tuples of
    client indices), each of ~group_size members."""
    hists = np.asarray(hists, dtype=np.float64)
    x = len(hists)
    n_groups = max(1, round(x / group_size))
    # assign sizes as evenly as possible
    sizes = [x // n_groups + (1 if i < x % n_groups else 0)
             for i in range(n_groups)]
    unassigned = set(range(x))
    skew = {c: eq2_distance(hists[c]) for c in unassigned}
    groups = []
    for gs in sizes:
        seed = max(unassigned, key=lambda c: skew[c])
        group = [seed]
        unassigned.discard(seed)
        acc = hists[seed].copy()
        for _ in range(gs - 1):
            if not unassigned:
                break
            best = min(unassigned, key=lambda c: eq2_distance(acc + hists[c]))
            group.append(best)
            unassigned.discard(best)
            acc += hists[best]
        groups.append(tuple(group))
    groups = _swap_refine(hists, groups)
    return groups


def _swap_refine(hists, groups, passes: int = 1):
    groups = [list(g) for g in groups]
    for _ in range(passes):
        improved = False
        for gi in range(len(groups)):
            for gj in range(gi + 1, len(groups)):
                for ii in range(len(groups[gi])):
                    for jj in range(len(groups[gj])):
                        base = (group_distance(hists, groups[gi])
                                + group_distance(hists, groups[gj]))
                        groups[gi][ii], groups[gj][jj] = \
                            groups[gj][jj], groups[gi][ii]
                        new = (group_distance(hists, groups[gi])
                               + group_distance(hists, groups[gj]))
                        if new < base - 1e-12:
                            improved = True
                        else:
                            groups[gi][ii], groups[gj][jj] = \
                                groups[gj][jj], groups[gi][ii]
        if not improved:
            break
    return [tuple(g) for g in groups]


def exhaustive_groups(hists, group_size: int):
    """Brute-force oracle (small x only): minimizes summed Eq. 2 distance
    over all partitions into groups of the given size."""
    hists = np.asarray(hists, dtype=np.float64)
    x = len(hists)
    assert x % group_size == 0 and x <= 8, "oracle is for small tests"

    best, best_d = None, np.inf

    def partitions(items):
        if not items:
            yield []
            return
        first = items[0]
        for combo in itertools.combinations(items[1:], group_size - 1):
            group = (first,) + combo
            rest = [i for i in items if i not in group]
            for sub in partitions(rest):
                yield [group] + sub

    for part in partitions(list(range(x))):
        d = sum(group_distance(hists, g) for g in part)
        if d < best_d:
            best, best_d = part, d
    return best


def label_histogram(labels, n_classes: int) -> np.ndarray:
    return np.bincount(np.asarray(labels).reshape(-1), minlength=n_classes
                       ).astype(np.float64)[:n_classes]


def balance_permutation(client_ids, groups, per_client: int):
    """Global-batch permutation realizing the grouping for the fused SPMD
    round step: clients' feature slabs (per_client rows each, ordered by
    client_ids) are permuted so each group's rows become contiguous.

    Returns perm with perm[new_row] = old_row (use as x[perm])."""
    index_of = {c: i for i, c in enumerate(client_ids)}
    perm = []
    for g in groups:
        for c in g:
            base = index_of[c] * per_client
            perm.extend(range(base, base + per_client))
    return np.asarray(perm, dtype=np.int32)
