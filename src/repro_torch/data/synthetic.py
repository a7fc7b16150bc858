"""Synthetic datasets (offline container — no CIFAR/ImageNet/FEMNIST
downloads). Two families:

- image classification: Gaussian class prototypes (smooth random patterns)
  + per-sample noise at CIFAR shapes; learnable, non-trivial, and class
  structure supports the paper's Dirichlet non-IID protocol.
- token LM: per-domain bigram chains over disjoint-ish token ranges; the
  'domain' plays the role of the label for the data-balance mechanism.
"""
from __future__ import annotations

import numpy as np


def make_image_dataset(n: int, *, n_classes: int = 10, image_size: int = 32,
                       channels: int = 3, noise: float = 0.6,
                       seed: int = 0, proto_seed: int = 0):
    """Returns {'x': (n,H,W,C) f32, 'y': (n,) i32}.

    ``proto_seed`` fixes the class prototypes INDEPENDENTLY of the sample
    seed, so train/test splits drawn with different ``seed`` share the
    same classification task (they must — an earlier version regenerated
    prototypes per split, making test accuracy random; see EXPERIMENTS).
    """
    rng = np.random.default_rng(seed)
    # smooth prototypes: low-frequency random fields per class
    freq = 4
    base = np.random.default_rng(proto_seed).normal(
        size=(n_classes, freq, freq, channels))
    protos = np.stack([
        np.kron(base[c], np.ones((image_size // freq, image_size // freq, 1)))
        for c in range(n_classes)])
    protos = protos / np.abs(protos).max()
    y = rng.integers(0, n_classes, size=n)
    x = protos[y] + noise * rng.normal(size=(n, image_size, image_size,
                                             channels))
    return {"x": x.astype(np.float32), "y": y.astype(np.int32)}


def make_lm_dataset(n: int, *, seq_len: int = 64, vocab: int = 256,
                    n_domains: int = 10, seed: int = 0):
    """Per-domain bigram chains: domain d prefers the token band
    [d*vocab/n, (d+1)*vocab/n) with a deterministic +step drift, so
    next-token prediction is learnable and domain-distinguishable.

    Returns {'tokens': (n,S) i32, 'labels': (n,S) i32 (shifted),
             'y': (n,) i32 domain ids}."""
    rng = np.random.default_rng(seed)
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
    return {"tokens": toks[:, :-1],
            "labels": toks[:, 1:].astype(np.int32),
            "y": y.astype(np.int32)}
