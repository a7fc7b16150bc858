"""Optimizers: SGD(+momentum) and Adam as functional (init, update)
pairs over parameter trees. The paper trains everything with plain SGD
lr=0.01 (§5). Updates are out of place — engine copies of the global
parameters share tensors, so an in-place step would write through to
every copy.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.utils.tree import tree_map


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable          # params -> state
    update: Callable        # (params, grads, state, step) -> (params, state)


def _lr_at(lr, step):
    return lr(step) if callable(lr) else lr


def sgd(lr, momentum: float = 0.0) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return ()
        return tree_map(torch.zeros_like, params)

    def update(params, grads, state, step=0):
        eta = _lr_at(lr, step)
        if momentum == 0.0:
            new = tree_map(lambda p, g: (p - eta * g.to(p.dtype)).to(p.dtype),
                           params, grads)
            return new, state
        vel = tree_map(lambda v, g: momentum * v + g.to(v.dtype),
                       state, grads)
        new = tree_map(lambda p, v: (p - eta * v).to(p.dtype), params, vel)
        return new, vel

    return Optimizer(init, update)


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        def z(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return {"m": tree_map(z, params), "v": tree_map(z, params)}

    def update(params, grads, state, step=0):
        eta = _lr_at(lr, step)
        t = step + 1
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.float(),
                     state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * g.float().square(),
                     state["v"], grads)

        def upd(p, m_, v_):
            mh = m_ / (1 - b1 ** t)
            vh = v_ / (1 - b2 ** t)
            step_ = eta * (mh / (torch.sqrt(vh) + eps)
                           + weight_decay * p.float())
            return (p.float() - step_).to(p.dtype)
        new = tree_map(upd, params, m, v)
        return new, {"m": m, "v": v}

    return Optimizer(init, update)
