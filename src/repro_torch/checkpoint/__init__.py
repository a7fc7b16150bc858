"""Parameter-tree checkpointing to .npz (flat path-keyed arrays +
structure), in the reference's format.

The structure travels as a JSON skeleton (dict/list/tuple nesting with
dict keys): ``load_checkpoint`` can rebuild the saved tree with NO
reference tree at all, and when a ``like`` tree IS supplied its paths
are checked against the file's with a clear ``ValueError`` on mismatch
instead of silently rebuilding something shaped like neither.

Tensors are written as numpy arrays (moved to the host) and come back as
numpy arrays; ``checkpoint/state.py`` puts them on the engine's device
in their dtype. The files are the reference's, path for path, so either
package restores the other's.

``save_run_state`` / ``restore_run_state`` (checkpoint/state.py) build
the FULL-training-state snapshot — driver timeline, link flows, channel
codec + residual state, scheduler table, rng — on top of these
primitives.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from repro_torch.checkpoint.state import (restore_run_state,  # noqa: F401
                                          save_run_state)
from repro_torch.utils.tree import tree_flatten, tree_unflatten


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _skeleton(tree):
    """JSON-serializable structure of a dict/list/tuple tree — enough
    to rebuild it from the flat path-keyed arrays without a reference."""
    if isinstance(tree, dict):
        return {"k": "d", "keys": sorted(tree),
                "children": [_skeleton(tree[k]) for k in sorted(tree)]}
    if isinstance(tree, (list, tuple)):
        return {"k": "l" if isinstance(tree, list) else "t",
                "children": [_skeleton(v) for v in tree]}
    return {"k": "leaf"}


def _build(skel, flat, prefix=""):
    """Rebuild the tree described by ``skel`` from ``flat`` (path ->
    array) — the exact mirror of ``_flatten``'s path scheme."""
    kind = skel["k"]
    if kind == "d":
        return {k: _build(c, flat, f"{prefix}/{k}")
                for k, c in zip(skel["keys"], skel["children"])}
    if kind in ("l", "t"):
        seq = [_build(c, flat, f"{prefix}/{i}")
               for i, c in enumerate(skel["children"])]
        return seq if kind == "l" else tuple(seq)
    return flat[prefix]


def _json_default(o):
    """np scalars (e.g. int64 cids) -> plain Python for json.dumps."""
    if hasattr(o, "item"):
        return o.item()
    raise TypeError(f"not JSON-serializable: {type(o).__name__}")


def _host(v):
    """A leaf as the numpy array the file holds (tensors leave the
    device bit for bit)."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save_checkpoint(path: str, params, extra: dict | None = None):
    flat = dict(_flatten(params))
    arrays = {k: _host(v) for k, v in flat.items()}
    meta = {"skeleton": _skeleton(params), "extra": extra or {}}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, __meta__=json.dumps(meta, default=_json_default),
             **arrays)


def load_checkpoint(path: str, like=None):
    """Restore the saved tree of numpy arrays. Without ``like`` the
    file's own skeleton rebuilds the structure (dicts/lists/tuples
    round-trip exactly); with ``like`` the restored leaves are
    additionally poured into ``like``'s structure after checking the
    paths match — a checkpoint/model mismatch raises ``ValueError``
    naming the differing paths instead of silently rebuilding."""
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files if k != "__meta__"}
        meta = json.loads(str(z["__meta__"]))
    if "skeleton" not in meta:
        raise ValueError(f"{path}: no structure skeleton in checkpoint "
                         "(pre-skeleton format is not supported)")
    params = _build(meta["skeleton"], flat)
    if like is not None:
        paths = [p for p, _ in _flatten(like)]
        if set(paths) != set(flat):
            diff = sorted(set(paths) ^ set(flat))
            raise ValueError(
                f"checkpoint/model structure mismatch at {len(diff)} "
                f"path(s): {diff[:8]}{'...' if len(diff) > 8 else ''}")
        _, skel = tree_flatten(like)
        # _flatten order (sorted dict keys, list index order) is
        # tree_flatten's leaf order
        return tree_unflatten(skel, [flat[p] for p in paths]), meta["extra"]
    return params, meta["extra"]
