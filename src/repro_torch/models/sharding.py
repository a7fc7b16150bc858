"""Logical-axis -> mesh-axis sharding rules (MaxText-style), and their
placement on a ``torch.distributed`` ``DeviceMesh``.

One ``model`` (tensor/expert-parallel) axis, one ``data`` axis
(cohort/data parallel; also the FSDP axis for trillion-scale expert
FFNs), optional ``pod`` axis (replica aggregation across pods).
``param_specs`` in ``repro_torch.models.params`` enforces per-param
single-claim + divisibility, so the rules here can be declared
optimistically. The rules are the reference's.

A spec is a plain tuple with one entry per tensor dim: ``None``, a mesh
dim's name, or a tuple of names (``("pod", "data")``; one name stands
alone): entry for entry what the reference's ``PartitionSpec`` holds. The spec functions take
any mesh-like object with ``mesh_dim_names`` and ``shape`` (a
``DeviceMesh`` has both), so a production-size spec can be computed
without the ranks. ``to_placements`` maps a spec onto a real mesh.
"""
from __future__ import annotations

from repro_torch.utils.tree import tree_flatten, tree_unflatten


def is_spec(x) -> bool:
    """A spec leaf: a tuple of per-dim entries (None, a name, or a tuple
    of names). Spec trees are dicts and lists around them."""
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, (str, tuple)) for e in x)


def axis_sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def mesh_rules(cfg, mesh) -> dict:
    rules = {
        "embed": None,
        "vocab": "model",
        "ff": "model",
        "heads": "model",
        # KV weights replicate when n_kv doesn't divide the model axis
        # (param_specs skips non-divisible dims)
        "kv_heads": "model",
        "head_dim": None,
        "experts": "model",
        "expert_ff": "data" if cfg.fsdp_ff else "model",
        "ssm_inner": "model",
        "ssm_heads": "model",
        "ssm_state": None,
        "conv_k": None,
        "lora": None,
        "rope_dim": None,
        "none": None,
    }
    for ax, size in axis_sizes(mesh).items():
        rules[("_size", ax)] = size
    return rules


def data_axes(mesh) -> tuple:
    """Mesh axes the global batch shards over."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def _entry(axes: tuple):
    """A spec entry over ``axes``: the name itself for one axis, as
    ``PartitionSpec`` normalises it."""
    return axes[0] if len(axes) == 1 else axes


def data_shards(mesh) -> int:
    """Ranks the global batch is split over (the product of the data
    axes' sizes)."""
    sizes = axis_sizes(mesh)
    n = 1
    for a in data_axes(mesh):
        n *= sizes[a]
    return n


def model_param_specs(cfg, mesh):
    from repro_torch.models.params import param_specs
    from repro_torch.models.transformer import model_defs
    return param_specs(model_defs(cfg), mesh_rules(cfg, mesh))


def batch_spec(mesh, ndim: int, *, batch_size: int | None = None) -> tuple:
    """(batch over the data axes, None, ...) -- replicated when the global
    batch does not divide the data axes (e.g. long_500k at B=1)."""
    dp = _entry(data_axes(mesh))
    first = (dp if batch_size is None or batch_size % data_shards(mesh) == 0
             else None)
    return (first,) + (None,) * (ndim - 1)


def cache_specs(cfg, mesh, caches_abstract, batch: int) -> list:
    """Specs of the decode caches: the batch over the data axes when it
    divides, otherwise the sequence dim (long context, batch 1). Over
    ``model``: kv heads (dim 2 of (B,S,K,D)) when they divide, else
    head_dim; the MLA latent rank (dim 2 of (B,S,R)). SSM states and
    window positions stay batch-sharded or replicated."""
    dp = _entry(data_axes(mesh))
    mdl = axis_sizes(mesh).get("model", 1)
    n = data_shards(mesh)
    batch_ok = batch % n == 0

    def model_dim(shape):
        if len(shape) == 4 and shape[2] % mdl == 0:
            return 2
        if len(shape) == 4 and shape[3] % mdl == 0:
            return 3
        if len(shape) == 3 and shape[2] % mdl == 0:
            return 2
        return None

    def spec_for(name, shape):
        nd = len(shape)
        if nd == 1:                          # slot_pos
            return (None,)
        md = model_dim(shape) if name in ("k", "v", "latent") else None
        spec = [None] * nd
        if batch_ok:
            spec[0] = dp
        elif name in ("k", "v", "latent", "k_rope") and shape[1] % n == 0:
            spec[1] = dp                     # batch 1: shard the sequence
        if md is not None and spec[md] is None:
            spec[md] = "model"
        return tuple(spec)

    return [{k: spec_for(k, tuple(v.shape)) for k, v in layer.items()}
            for layer in caches_abstract]


def to_placements(spec: tuple, mesh) -> list:
    """A spec as DTensor placements on ``mesh``: ``Shard(d)`` on each mesh
    dim that tensor dim ``d`` names, ``Replicate()`` on the others. A
    mesh dim of size 1 holds the whole tensor either way and gets
    ``Replicate()`` (DTensor cannot view a sharded dim of size 1 away, as
    a batch-1 matmul does)."""
    from torch.distributed.tensor import Replicate, Shard
    sizes = axis_sizes(mesh)
    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        if len(dims) > 1:
            raise ValueError(f"mesh dim {name!r} claimed twice in {spec}")
        out.append(Shard(dims[0]) if dims and sizes[name] > 1
                   else Replicate())
    return out


def constrain(x, spec: tuple):
    """The counterpart of ``jax.lax.with_sharding_constraint``: a DTensor
    redistributed to ``spec``'s placements on its own mesh; anything
    else returned as it is."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, to_placements(spec, x.device_mesh))


def unshard_dim(x, dim: int):
    """``x`` with dim ``dim`` whole on every rank. A DTensor sharded on it
    is redistributed there (its other placements kept); anything else is
    returned as it is. For ops whose DTensor rule fails on a sharded dim
    (the cross-entropy's gather over vocab-sharded logits)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return x
    dim %= x.ndim
    pl = [Replicate() if isinstance(p, Shard) and p.dim == dim else p
          for p in x.placements]
    if pl == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, pl)


def whole(x):
    """A DTensor's full value on every rank, as a plain tensor (which then
    takes part as a replicated value); anything else as it is. For ops
    DTensor has no rule for (``searchsorted`` in the MoE ranking)."""
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x


def map_specs(fn, specs, *rest):
    """``fn(spec, *leaves)`` over a spec tree and trees of its structure."""
    leaves, skel = tree_flatten(specs, is_leaf=is_spec)
    others = [tree_flatten(r)[0] for r in rest]
    return tree_unflatten(skel, [fn(s, *o) for s, *o in zip(leaves, *others)])


def placements_of(specs, mesh):
    """A spec tree as a tree of placement lists."""
    return map_specs(lambda s: to_placements(s, mesh), specs)


def shard_params(params, specs, mesh):
    """Distribute a tree of full tensors by its spec tree: each leaf's
    shards land on their ranks (``distribute_tensor``; every rank passes
    the same full tensor)."""
    from torch.distributed.tensor import distribute_tensor
    return map_specs(
        lambda s, t: distribute_tensor(t, mesh, to_placements(s, mesh)),
        specs, params)
