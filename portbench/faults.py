"""Faults planted under a run's timed path, each of which ``correct``
has to catch: by the CPU tests at a small size, and by
``portbench.calibrate`` on the card at the cell's own size. Each is a
``break_step`` for a driver's ``run``."""
from __future__ import annotations

import torch


# ------------------------------------------------------------- training
def state_unchanged(eng):
    """Every round returns the model as it came: the aggregation drops
    the trained work."""
    def commit(gids):
        for g in gids:
            eng._held.pop(g, None)
    eng._commit = commit


def half_batch(eng):
    """Each client trains on half of its batch rows (the loss is the
    mean over the half)."""
    sample = eng._sample_batch

    def half(cid):
        b = sample(cid)
        n = len(b["tokens"]) // 2
        return {k: v[:n] for k, v in b.items()}
    eng._sample_batch = half


def uniform_split(eng):
    """The sliding split never leaves its warm-up: after the K warm-up
    rounds every client still gets one split, the next in turn."""
    sched = eng.scheduler
    pts = sched.plan.split_points

    def select(participants):
        return {c: pts[sched.round % len(pts)] for c in participants}
    sched.select = select


TRAIN = {"state_unchanged": state_unchanged, "half_batch": half_batch,
         "uniform_split": uniform_split}


# -------------------------------------------------------------- prefill
def answer_altered(prefill):
    """The first request's last-position logits are the second's."""
    def wrapped(cfg, params, tokens, max_len, *a, **kw):
        logits, caches, n = prefill(cfg, params, tokens, max_len, *a, **kw)
        logits = logits.clone()
        logits[0] = logits[1]
        return logits, caches, n
    return wrapped


def cache_unfilled(prefill):
    """The returned caches are the zeroed ones the prefill started
    from."""
    def wrapped(cfg, params, tokens, max_len, *a, **kw):
        logits, caches, n = prefill(cfg, params, tokens, max_len, *a, **kw)
        for c in caches:
            for t in c.values():
                t.zero_()
        return logits, caches, n
    return wrapped


def half_batch_prefill(prefill):
    """Only the first half of the prompts is prefilled, twice over: its
    results stand in for the other half's."""
    def wrapped(cfg, params, tokens, max_len, *a, **kw):
        h = tokens.shape[0] // 2
        return prefill(cfg, params, torch.cat([tokens[:h], tokens[:h]]),
                       max_len, *a, **kw)
    return wrapped


PREFILL = {"answer_altered": answer_altered,
           "cache_unfilled": cache_unfilled,
           "half_batch": half_batch_prefill}

BY_KIND = {"s2fl_train": TRAIN, "prefill": PREFILL}
