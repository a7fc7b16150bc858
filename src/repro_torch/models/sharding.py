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

import torch

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


class _LaidOut(torch.autograd.Function):
    """Identity up to layout: forward to ``placements``, backward to the
    input's placements (a partial sum's gradient is the whole gradient
    on each rank)."""

    @staticmethod
    def forward(ctx, t, placements):
        from torch.distributed.tensor import Replicate
        ctx.placements = [Replicate() if p.is_partial() else p
                          for p in t.placements]
        out = t.redistribute(t.device_mesh, placements)
        return out.view_as(out) if out is t else out

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.placements), None


def laid_out(x, placements):
    """A DTensor redistributed to ``placements``, whose gradient is
    redistributed back to ``x``'s own placements (as the transpose of
    ``with_sharding_constraint`` constrains the cotangent). DTensor's
    backward may otherwise hand a view's gradient over in a layout the
    view cannot take back (a dim sharded over two mesh dims). Anything
    else is returned as it is."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    return _LaidOut.apply(x, placements)


def rows_only(x):
    """A DTensor with only its batch dim (dim 0) sharded, as it is, and
    every other mesh dim whole (``laid_out``: its gradient comes back in
    x's layout). The residual stream between blocks, as the reference's
    partitioner keeps it: each block's projections then read whole
    activations against weights sharded over heads or features, where
    DTensor's own choice shards the stream over ``model`` on ``d`` and
    makes every projection a partial sum. Anything else as it is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return x
    pl = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
          for p in x.placements]
    if pl == list(x.placements):
        return x
    return laid_out(x, pl)


def whole(x):
    """A DTensor's full value on every rank, as a plain tensor (which then
    takes part as a replicated value); anything else as it is. For ops
    DTensor has no rule for (``searchsorted`` in the MoE ranking)."""
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose gradient comes back contiguous: DTensor views a
    local gradient as it views the global one, which a strided local
    tensor (an einsum's backward) cannot always be."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def on_local_shards(fn, args, roles, out_roles):
    """``fn(*args, starts=...)`` run by each rank on its local shards, for
    a function that is independent along some dims of its args (its
    "roles": batch rows, heads).

    ``roles[i]`` maps a role to its dim in ``args[i]`` (a DTensor, a plain
    tensor or None); ``out_roles`` does the same for each output (a list,
    one map an output, for a tuple of outputs; else one map). A mesh dim
    serves a role where the first DTensor arg sharded there is sharded on
    one of its roles' dims; every other mesh dim is made whole on every
    arg first.
    Each DTensor arg is laid out so: sharded along a role where its size
    divides the mesh dim, else whole there -- and then, having used only
    its part on this rank, its gradient over that mesh dim is a partial
    sum. ``starts`` gives ``fn`` the global index of the first element of
    this rank's shard of each role (0 where the role is whole), so it can
    pick its part of a whole arg. An output map's ``"partial"`` names the
    roles whose shards each give a part of a sum (the output then is a
    partial sum over their mesh dims); an output the same on every shard
    of a role leaves the role out. Plain tensors pass as they are
    (replicated values without a role: positions). With no DTensor arg
    this is ``fn(*args, starts={})``."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    dts = [(a, rl) for a, rl in zip(args, roles) if isinstance(a, DTensor)]
    if not dts:
        return fn(*args, starts={})
    mesh = dts[0][0].device_mesh
    sizes = tuple(mesh.shape)
    assign, ways, starts, chunk = [], {}, {}, {}
    for i in range(mesh.ndim):             # mesh dims outer to inner
        role = None
        for a, rl in dts:
            p = a.placements[i]
            if isinstance(p, Shard):
                role = next((r for r, d in rl.items()
                             if d % a.ndim == p.dim), None)
            if role is not None:
                break
        assign.append(role)
        if role is not None:
            ways[role] = ways.get(role, 1) * sizes[i]
            chunk[role] = chunk.get(role, a.shape[rl[role]]) // sizes[i]
            starts[role] = (starts.get(role, 0)
                            + chunk[role] * mesh.get_local_rank(i))

    def layout(shape, rl):
        return [Shard(rl[role] % len(shape))
                if role in rl and shape[rl[role]] % ways[role] == 0
                else Replicate() for role in assign]

    def local(a, rl):
        if not isinstance(a, DTensor):
            return a
        pl = layout(a.shape, rl)
        grad = [Partial() if role is not None and isinstance(p, Replicate)
                else p for role, p in zip(assign, pl)]
        t = a.redistribute(mesh, pl).to_local(grad_placements=grad)
        return _ContiguousGrad.apply(t) if t.requires_grad else t

    out = fn(*[local(a, rl) for a, rl in zip(args, roles)], starts=starts)

    def wrap(o, rl):
        summed = rl.get("partial", ())
        pl = [Partial() if role in summed
              else Shard(rl[role] % o.ndim) if role in rl
              else Replicate() for role in assign]
        return DTensor.from_local(o, mesh, pl, run_check=False)
    if isinstance(out, tuple):
        return tuple(wrap(o, rl) for o, rl in zip(out, out_roles))
    return wrap(out, out_roles)


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
