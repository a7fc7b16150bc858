"""Top-k with ``jax.lax.top_k``'s tie order.

``torch.topk`` leaves the order of equal values open, so where several
entries equal the k-th largest value it may keep any of them.
``jax.lax.top_k`` keeps the ones with the lower index. bf16 payloads
have few distinct magnitudes, so such ties are real at the codec's and
the fused combine's thresholds (and possible in the MoE router's).
"""
from __future__ import annotations

import torch


def top_k(x, k: int):
    """(values, indices) of the ``k`` largest entries along the last dim,
    in ``jax.lax.top_k``'s order: values descending, equal values by
    index ascending.

    ``torch.topk`` gives the threshold (the k-th largest value); every
    entry strictly above it is kept, then the first ``k - m`` entries
    equal to it, in index order. O(n) in the row length; no data-
    dependent shapes, so it runs under ``torch.func.vmap``."""
    n = x.shape[-1]
    thr = torch.topk(x, k, dim=-1).values[..., -1:]
    above = x > thr
    tie = x == thr
    need = k - above.sum(-1, keepdim=True)
    take = above | (tie & (torch.cumsum(tie, -1) <= need))
    # the kept indices in index order: entry i goes to slot (its rank
    # among the kept) and the rest to a spare slot k, dropped after
    slot = torch.where(take, torch.cumsum(take, -1) - 1, k)
    pos = torch.arange(n, device=x.device).expand(x.shape)
    idx = torch.zeros(x.shape[:-1] + (k + 1,), dtype=torch.int64,
                      device=x.device).scatter(-1, slot, pos)[..., :k]
    vals = x.gather(-1, idx)
    order = torch.sort(vals, dim=-1, descending=True, stable=True).indices
    return vals.gather(-1, order), idx.gather(-1, order)
