"""Non-IID federated partitioning — Dirichlet(α) over label proportions
(the paper's protocol for CIFAR/ImageNet, §5.1) plus IID and
shards-per-client alternatives.
"""
from __future__ import annotations

import numpy as np


def dirichlet_partition(labels, n_clients: int, alpha: float,
                        seed: int = 0, min_per_client: int = 2):
    """Returns list of index arrays, one per client. Classic protocol:
    for each class, split its sample indices by Dirichlet(alpha)
    proportions across clients."""
    rng = np.random.default_rng(seed)
    labels = np.asarray(labels)
    n_classes = int(labels.max()) + 1
    client_idx = [[] for _ in range(n_clients)]
    for c in range(n_classes):
        idx = np.flatnonzero(labels == c)
        rng.shuffle(idx)
        props = rng.dirichlet([alpha] * n_clients)
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for cid, part in enumerate(np.split(idx, cuts)):
            client_idx[cid].extend(part.tolist())
    # guarantee a minimum (move from the largest client)
    for cid in range(n_clients):
        while len(client_idx[cid]) < min_per_client:
            donor = int(np.argmax([len(ci) for ci in client_idx]))
            client_idx[cid].append(client_idx[donor].pop())
    return [np.asarray(sorted(ci), dtype=np.int64) for ci in client_idx]


def iid_partition(n: int, n_clients: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    idx = rng.permutation(n)
    return [np.sort(p) for p in np.array_split(idx, n_clients)]


def federate(dataset: dict, n_clients: int, *, alpha=None, seed: int = 0):
    """Split a dataset dict into {cid: dataset dict}. alpha=None -> IID."""
    labels = dataset["y"]
    if alpha is None:
        parts = iid_partition(len(labels), n_clients, seed)
    else:
        parts = dirichlet_partition(labels, n_clients, alpha, seed)
    return {cid: {k: v[p] for k, v in dataset.items()}
            for cid, p in enumerate(parts)}
