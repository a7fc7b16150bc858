"""Small helpers over parameter trees (nested dicts / lists of tensors),
used by Algorithm-1 aggregation, the optimizers and the model legs.

``tree_flatten`` walks a tree in the reference's leaf order: dict keys
SORTED, lists and tuples in order. That order decides which residual
key and which rand-k draw each model-leg leaf gets, so it must not
follow dict insertion order (``torch.utils._pytree`` does).
"""
from __future__ import annotations

import torch


class _Leaf:
    """Placeholder marking a leaf position in a tree skeleton."""


_LEAF = _Leaf()


def tree_flatten(tree, is_leaf=None):
    """-> (leaves, skeleton). ``None`` is an empty subtree (no leaves),
    as in the reference; namedtuples are nodes unless ``is_leaf`` says
    otherwise."""
    leaves = []
    return leaves, _walk(tree, is_leaf, leaves)


# The recursions are module functions, not closures: a closure that calls
# itself is a reference cycle, which would keep the leaves (a whole
# params or gradient set) alive until the cyclic collector runs.
def _walk(node, is_leaf, leaves):
    if is_leaf is not None and is_leaf(node):
        leaves.append(node)
        return _LEAF
    if isinstance(node, dict):
        return {k: _walk(node[k], is_leaf, leaves) for k in sorted(node)}
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*[_walk(v, is_leaf, leaves) for v in node])
    if isinstance(node, (list, tuple)):
        return type(node)(_walk(v, is_leaf, leaves) for v in node)
    if node is None:
        return None
    leaves.append(node)
    return _LEAF


def tree_unflatten(skeleton, leaves):
    return _build(skeleton, iter(leaves))


def _build(node, it):
    if node is _LEAF:
        return next(it)
    if isinstance(node, dict):
        return {k: _build(v, it) for k, v in node.items()}
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*[_build(v, it) for v in node])
    if isinstance(node, (list, tuple)):
        return type(node)(_build(v, it) for v in node)
    return node


def tree_leaves(tree, is_leaf=None):
    return tree_flatten(tree, is_leaf)[0]


def tree_map(fn, tree, *rest, is_leaf=None):
    leaves, skel = tree_flatten(tree, is_leaf)
    others = [tree_flatten(t, is_leaf)[0] for t in rest]
    return tree_unflatten(skel, [fn(*xs) for xs in zip(leaves, *others)])


def get_subtree(tree, path):
    node = tree
    for p in path:
        node = node[p]
    return node


def set_subtree(tree, path, value):
    """Functional set: returns a copy of `tree` with tree[path] = value."""
    if not path:
        return value
    head, rest = path[0], path[1:]
    if isinstance(tree, dict):
        out = dict(tree)
        out[head] = set_subtree(tree[head], rest, value)
        return out
    if isinstance(tree, (list, tuple)):
        out = list(tree)
        out[head] = set_subtree(tree[head], rest, value)
        return type(tree)(out) if isinstance(tree, tuple) else out
    raise TypeError(type(tree))


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_scale(a, s):
    return tree_map(lambda x: x * s, a)


def tree_weighted_sum(trees, weights):
    """sum_i w_i * tree_i / sum_i w_i"""
    total = sum(weights)
    acc = tree_scale(trees[0], weights[0] / total)
    for t, w in zip(trees[1:], weights[1:]):
        acc = tree_add(acc, tree_scale(t, w / total))
    return acc
