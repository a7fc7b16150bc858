"""Weights drawn from the seed on the device, in a few large calls.

The shapes, init kinds and dtypes are the port's parameter definitions
(``ParamDef`` leaves: the layout the port reads its weights in). Every
leaf of one dtype is a view into one flat buffer, filled by one
``normal_`` from a generator on the device and then scaled leaf by leaf
to its init's standard deviation; norm scales are ones. The same seed
gives the same weights on the same device. The tree is the benchmark's:
the port and the plain reference are both handed it.
"""
from __future__ import annotations

import math

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _walk(node, path, out):
    if hasattr(node, "_fields") and hasattr(node, "shape"):   # ParamDef
        out.append((path, node))
    elif isinstance(node, dict):
        for k in sorted(node):
            _walk(node[k], path + (k,), out)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _walk(v, path + (i,), out)


def _std(d) -> float:
    if d.init == "normal":
        return float(d.scale)
    if d.init == "fan_in":
        return 1.0 / math.sqrt(max(d.shape[0] if d.shape else 1, 1))
    raise ValueError(f"no draw for init {d.init!r}")


def _set(tree, path, value):
    node = tree
    for k in path[:-1]:
        node = node[k]
    node[path[-1]] = value


def _skeleton(node):
    if isinstance(node, dict):
        return {k: _skeleton(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)) and not hasattr(node, "_fields"):
        return [_skeleton(v) for v in node]
    return None


def make_weights(defs, seed: int, param_dtype: str, device) -> dict:
    """A params tree (nested dicts and lists, as ``defs``) of tensors on
    ``device``, drawn from ``seed``."""
    leaves = []
    _walk(defs, (), leaves)
    tree = _skeleton(defs)
    by_dtype = {}
    for path, d in leaves:
        by_dtype.setdefault(d.dtype or param_dtype, []).append((path, d))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    for dname in sorted(by_dtype):
        items = by_dtype[dname]
        drawn = [(p, d) for p, d in items if d.init not in ("ones",
                                                             "zeros")]
        n = sum(math.prod(d.shape) for _, d in drawn)
        flat = torch.empty(n, dtype=DTYPES[dname], device=device)
        flat.normal_(generator=gen)
        off = 0
        for path, d in drawn:
            k = math.prod(d.shape)
            leaf = flat[off:off + k].view(d.shape)
            leaf.mul_(_std(d))
            _set(tree, path, leaf)
            off += k
        for path, d in items:
            if d.init == "ones":
                _set(tree, path, torch.ones(d.shape, dtype=DTYPES[dname],
                                            device=device))
            elif d.init == "zeros":
                _set(tree, path, torch.zeros(d.shape, dtype=DTYPES[dname],
                                             device=device))
    return tree


def leaves(tree, path=()):
    """[(path, tensor)] of a params tree, dict keys sorted."""
    out = []
    if isinstance(tree, dict):
        for k in sorted(tree):
            out += leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out += leaves(v, path + (i,))
    else:
        out.append((path, tree))
    return out
