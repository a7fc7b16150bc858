"""Carry parameter trees between numpy arrays and tensors.

The port keeps the reference's tree structure and leaf shapes (HWIO conv
weights, depthwise ``(3,3,1,C)``; the LM's ``blocks`` list and its
``shared_attn`` slot), so a tree of numpy arrays — e.g. the reference's
parameters after ``np.asarray`` on each leaf — maps leaf for leaf, with
no transposes.

numpy has no bfloat16 of its own: a bf16 leaf arrives as an array of the
``ml_dtypes`` extension type, which ``torch.from_numpy`` rejects. Such a
leaf (recognised by its dtype's name, so ``ml_dtypes`` need not be
importable here) goes through float32, which holds every bf16 value
exactly, and back to ``torch.bfloat16``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils.tree import tree_map


def _to_tensor(a, device):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device)


def params_from_numpy(tree, *, device):
    """numpy-array tree -> tensor tree on ``device`` (dtypes kept)."""
    return tree_map(lambda a: _to_tensor(a, device), tree)


def params_to_numpy(tree):
    """tensor tree -> numpy-array tree (host copies; bf16 leaves come back
    as float32, which numpy can hold)."""
    return tree_map(lambda t: (t.detach().to(torch.float32)
                               if t.dtype == torch.bfloat16
                               else t.detach()).cpu().numpy(), tree)
