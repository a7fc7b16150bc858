"""Algorithm 1 — three-portion model aggregation.

Because the split slides per device, a given layer (segment) may have been
trained on some devices' clients and, for the others, inside their group's
server-side copy. For every segment of the full model W:

    W[seg] = sum_i |D_i| * source_i[seg]  /  sum_i |D_i|

where source_i = client params of device i if the segment lies in its
client portion, else the server copy of device i's group — exactly lines
3–17 of Algorithm 1 (weights are data sizes |D_i|).
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.api import SplitModel
from repro_torch.utils.tree import (get_subtree, set_subtree,
                                    tree_weighted_sum)


@dataclasses.dataclass
class ClientState:
    cid: int
    params: dict                   # trained client-side params (full tree)
    split: int
    data_size: float
    group: int


def aggregate(model: SplitModel, clients: list, server_copies: dict) -> dict:
    """clients: list[ClientState]; server_copies: {group_id: params}.
    Returns the aggregated full model W."""
    assert clients, "no clients to aggregate"
    out = clients[0].params        # template for reassembly
    for name, path in model.segments():
        subs, weights = [], []
        for c in clients:
            src = (c.params if name in model.client_segments(c.split)
                   else server_copies[c.group])
            subs.append(get_subtree(src, path))
            weights.append(c.data_size)
        out = set_subtree(out, path, tree_weighted_sum(subs, weights))
    return out


def fedavg_aggregate(params_list, weights):
    """Plain FedAvg weighted average (baseline)."""
    return tree_weighted_sum(params_list, weights)
