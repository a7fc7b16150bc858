"""Parameter definition machinery.

Every module declares its parameters ONCE as a tree of ``ParamDef``
(shape + logical axes + init kind). From that single source come
``init_params`` (materialized tensors), ``abstract_params`` (tensors on
the ``meta`` device: shapes and dtypes, no storage) and ``param_specs``
(one sharding spec a leaf, from logical-axis -> mesh-axis rules).
Shapes are the reference's (conv weights HWIO, depthwise ``(3,3,1,C)``),
so a parameter tree carries across leaf for leaf.

Random init draws from one CPU ``torch.Generator`` seeded once, leaf by
leaf in the reference's leaf order, and only then moves to the device:
the same seed gives the same weights on the card and on the CPU. (It
does not give the reference's weights — JAX's threefry stream has no
torch counterpart; parity tests copy the reference's init across with
``models/convert.py``.) ``draw_on_device`` draws from a generator on the
device itself instead: the same init kinds and distributions, other
numbers, and no host-side draw of a full-width model (deepseek-v2-lite's
15.7 B values).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.utils.tree import tree_flatten, tree_leaves, tree_unflatten

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


class ParamDef(NamedTuple):
    shape: tuple
    axes: tuple                 # logical axis name per dim
    init: str = "fan_in"        # fan_in | conv | normal | zeros | ones |
                                # ssm_a | ssm_dt
    scale: float = 0.02
    dtype: str = ""             # '' -> model param_dtype


def is_def(x) -> bool:
    return isinstance(x, ParamDef)


def _materialize(d: ParamDef, gen: torch.Generator, param_dtype: str):
    """One leaf, on the generator's device."""
    dtype = DTYPES[d.dtype or param_dtype]
    dev = gen.device
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dtype, device=dev)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dtype, device=dev)
    if d.init == "ssm_a":        # A_log: A in [1, 16]
        u = torch.rand(d.shape, generator=gen, dtype=torch.float32,
                       device=dev)
        return torch.log(1.0 + 15.0 * u).to(dtype)
    if d.init == "ssm_dt":       # dt_bias: softplus^-1(dt), dt in [1e-3, 1e-1]
        lo, hi = math.log(1e-3), math.log(1e-1)
        u = torch.rand(d.shape, generator=gen, dtype=torch.float32,
                       device=dev)
        dt = torch.exp(lo + (hi - lo) * u)
        return (dt + torch.log(-torch.expm1(-dt))).to(dtype)
    if d.init == "normal":
        std = d.scale
    elif d.init == "fan_in":
        fan_in = d.shape[0] if d.shape else 1
        std = 1.0 / math.sqrt(max(fan_in, 1))
    elif d.init == "conv":       # HWIO conv weight: fan_in = H*W*I
        fan_in = math.prod(d.shape[:-1]) if len(d.shape) > 1 else 1
        std = math.sqrt(2.0 / max(fan_in, 1))
    else:
        raise ValueError(f"unknown init {d.init!r}")
    return (torch.randn(d.shape, generator=gen, dtype=torch.float32,
                        device=dev) * std).to(dtype)


def init_params(defs, seed: int, param_dtype: str = "float32", *,
                device, draw_on_device: bool = False):
    """Materialize a ParamDef tree into tensors on ``device``, drawn on
    the CPU (the default) or, with ``draw_on_device``, on ``device``."""
    leaves, skel = tree_flatten(defs, is_leaf=is_def)
    gen = torch.Generator(device=device if draw_on_device else "cpu")
    gen.manual_seed(int(seed))
    out = [_materialize(d, gen, param_dtype).to(device) for d in leaves]
    return tree_unflatten(skel, out)


def count_params(defs) -> int:
    return sum(math.prod(d.shape) for d in tree_leaves(defs, is_leaf=is_def))


def abstract_params(defs, param_dtype: str = "float32"):
    """The tree of ``defs`` as tensors on the ``meta`` device: shapes and
    dtypes, no storage (the counterpart of the reference's
    ``ShapeDtypeStruct`` tree)."""
    leaves, skel = tree_flatten(defs, is_leaf=is_def)
    return tree_unflatten(skel, [
        torch.empty(d.shape, dtype=DTYPES[d.dtype or param_dtype],
                    device="meta") for d in leaves])


def param_specs(defs, rules: dict):
    """Spec tree from logical-axis rules {logical: mesh_axis | None}: one
    tuple a leaf, an entry a dim, each None or a mesh-axis name.

    A mesh axis may be claimed by at most one dim of a param; a later dim
    that names it, or a dim the axis's size (``rules[("_size", axis)]``)
    does not divide, is replicated."""
    def to_spec(d: ParamDef):
        used = set()
        spec = []
        for ax, size in zip(d.axes, d.shape):
            m = rules.get(ax)
            if m is None or m in used or size == 0:
                spec.append(None)
                continue
            msize = rules.get(("_size", m), 0)
            if msize and size % msize != 0:
                spec.append(None)
                continue
            used.add(m)
            spec.append(m)
        return tuple(spec)
    leaves, skel = tree_flatten(defs, is_leaf=is_def)
    return tree_unflatten(skel, [to_spec(d) for d in leaves])
