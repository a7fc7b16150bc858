"""The general traffic generators; a mix's ``traffic/<mix>.json`` gives
their parameters.

- ``federated_lm``: each client's token sequences for S²FL training.
  Per-domain bigram chains over a band of the vocabulary (the domain is
  the label the balance mechanism groups by), split over the clients by
  Dirichlet(alpha) over domains with at least one full batch a client,
  so every seed gives every client the same batch shape. A copy of
  ``repro_torch/data/synthetic.py``'s ``make_lm_dataset`` and
  ``data/partition.py``'s ``dirichlet_partition``.
- ``prompt_batches``: batches of prompts of one length, token ids
  uniform over the vocabulary, drawn on the device.
"""
from __future__ import annotations

import numpy as np
import torch


def lm_sequences(n: int, *, seq_len: int, vocab: int, n_domains: int,
                 rng):
    """{'tokens': (n,S), 'labels': (n,S) shifted, 'y': (n,) domains}."""
    band = max(vocab // n_domains, 4)
    y = rng.integers(0, n_domains, size=n)
    toks = np.zeros((n, seq_len + 1), np.int32)
    for i in range(n):
        lo = (y[i] * band) % max(vocab - band, 1)
        t = lo + rng.integers(0, band)
        step = 1 + (y[i] % 3)
        seq = [t]
        for _ in range(seq_len):
            if rng.random() < 0.15:                      # noise token
                seq.append(int(lo + rng.integers(0, band)))
            else:
                seq.append(int(lo + (seq[-1] - lo + step) % band))
        toks[i] = seq[:seq_len + 1]
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:].astype(np.int32),
            "y": y.astype(np.int32)}


def dirichlet_split(labels, n_clients: int, alpha: float, rng,
                    min_per_client: int):
    """Index arrays, one a client: each label's samples split by
    Dirichlet(alpha) proportions; clients under ``min_per_client`` take
    samples from the largest."""
    labels = np.asarray(labels)
    parts = [[] for _ in range(n_clients)]
    for c in range(int(labels.max()) + 1):
        idx = np.flatnonzero(labels == c)
        rng.shuffle(idx)
        props = rng.dirichlet([alpha] * n_clients)
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for cid, part in enumerate(np.split(idx, cuts)):
            parts[cid].extend(part.tolist())
    for cid in range(n_clients):
        while len(parts[cid]) < min_per_client:
            donor = int(np.argmax([len(p) for p in parts]))
            parts[cid].append(parts[donor].pop())
    return [np.asarray(sorted(p), dtype=np.int64) for p in parts]


def federated_lm(mix: dict, seed: int) -> dict:
    """{cid: {'tokens', 'labels', 'y'}} for the mix's clients."""
    rng = np.random.default_rng(seed)
    data = lm_sequences(mix["sequences"], seq_len=mix["seq_len"],
                        vocab=mix["vocab"], n_domains=mix["domains"],
                        rng=rng)
    parts = dirichlet_split(data["y"], mix["clients"], mix["alpha"], rng,
                            min_per_client=mix["batch"])
    return {cid: {k: v[p] for k, v in data.items()}
            for cid, p in enumerate(parts)}


def prompt_batches(mix: dict, seed: int, vocab: int, device) -> torch.Tensor:
    """(n, B, S) int64 prompt ids on ``device``: batch i is the window's
    i-th call (calls beyond n wrap around)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    return torch.randint(0, vocab, (mix["distinct_batches"], mix["batch"],
                                    mix["prompt_len"]), generator=gen,
                         device=device)
