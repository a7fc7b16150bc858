"""Carry parameter trees between numpy arrays and tensors.

The port keeps the reference's tree structure and leaf shapes (HWIO conv
weights, depthwise ``(3,3,1,C)``), so a tree of numpy arrays — e.g. the
reference's parameters after ``np.asarray`` on each leaf — maps leaf for
leaf, with no transposes.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils.tree import tree_map


def params_from_numpy(tree, *, device):
    """numpy-array tree -> tensor tree on ``device`` (dtypes kept)."""
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(device),
                    tree)


def params_to_numpy(tree):
    """tensor tree -> numpy-array tree (host copies)."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)
