"""Fused S²FL round step: the pod-scale form of Algorithm 2.

The global batch dim hosts the participating cohorts (data-parallel
shards). One step performs:

  client-half forward   (batch sharded over the data axes)
  balance permutation   (``index_select`` over the global batch: the
                         paper's feature upload + Eq.-2 regroup)
  per-group server half (G groups, G server-side copies)
  combined loss (Eq. 3) and its gradient (the permutation's backward is
                         the paper's gradient return, Step 7)
  SGD update; the data-axis sum of a replicated weight's gradient is the
                         E=1 fusion of per-copy updates + Algorithm-1
                         weighted aggregation (equal cohort weights).

The groups run as a Python loop over the G slabs, not under
``torch.func.vmap`` as the reference's ``jax.vmap``: ``torch.func``
refuses the saved-tensor hooks of per-block checkpointing (``cfg.remat``,
which the step builders force). Each group computes the same function.

``dp_axes=None`` is the host path, on plain tensors. With ``dp_axes``,
params and batch are DTensors on a ``DeviceMesh`` (placements from
``train_step_shardings``): where the reference constrains the grouped
batch to the data axes, this step redistributes it there explicitly, and
each gradient is redistributed to its weight's placements before the
update, so the new params keep the input placements. Plain tensors that
the model makes on the way (positions, masks) take part as replicated
values (``implicit_replication``).

Equivalence with the host engine at E=1 is held by tests.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.models.api import SplitModel
from repro_torch.models.params import DTYPES
from repro_torch.models.sharding import (batch_spec, constrain, laid_out,
                                        model_param_specs, placements_of,
                                        to_placements)
from repro_torch.utils.tree import tree_flatten, tree_unflatten


class _GradCast(torch.autograd.Function):
    """Identity forward; the backward casts the gradient to the compute
    dtype, so the permutation's backward moves (and sums) compute-dtype
    values, not f32. Autograd already gives a tensor's gradient that
    tensor's dtype, so this only rounds where the features are wider
    than the compute dtype; it keeps the reference's contract."""

    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None


def _grad_cast(x, dtype):
    return _GradCast.apply(x, dtype)


def _spmd(dp_axes):
    """Plain tensors the model makes beside DTensors count as replicated
    on the mesh path; nothing changes on the host path."""
    if dp_axes is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def make_s2fl_loss(cfg, split: int, n_groups: int, dp_axes=None,
                   group_members: int = 1):
    """dp_axes: mesh axes the batch shards over (the grouped batch is
    redistributed onto them after the permutation; None for host / test
    execution). group_members: clients (cohorts) per balance group --
    Eq. 3 sums per-client losses, so the fused per-group CE mean is
    scaled by the member count (engine-equivalence tested)."""
    model = SplitModel(cfg)
    compute_dtype = DTYPES[cfg.dtype]

    def on_data_axes(x):
        """(G, gb, ...) with gb over the data axes, all else replicated."""
        if dp_axes is None:
            return x
        return constrain(x, (None, tuple(dp_axes)) + (None,) * (x.ndim - 2))

    def whole(x):
        """The batch on every rank, its gradient back in x's layout: the
        balance permutation moves rows between every pair of data ranks,
        and a batch dim sharded over them cannot be split into groups
        (each group's rows lie on every data rank)."""
        if dp_axes is None or not hasattr(x, "device_mesh"):
            return x
        from torch.distributed.tensor import Replicate
        return laid_out(x, [Replicate()] * x.device_mesh.ndim)

    def grouped(x):
        """The permuted batch (B, ...) as (G, gb, ...), gb over the data
        axes."""
        return on_data_axes(x.reshape(n_groups, x.shape[0] // n_groups,
                                      *x.shape[1:]))

    def loss_fn(params, batch):
        feats = model.client_forward(params, batch, split, train=True)
        perm = batch["perm"]
        h = torch.index_select(whole(_grad_cast(feats["h"], compute_dtype)),
                               0, perm)
        labels = torch.index_select(whole(batch["labels"]), 0, perm)
        tokens = torch.index_select(whole(batch["tokens"]), 0, perm)
        hg, lg, tg = grouped(h), grouped(labels), grouped(tokens)
        zero = torch.zeros((), dtype=torch.float32, device=h.device)
        losses = [model.server_loss(params, {"h": hg[g], "aux": zero},
                                    {"tokens": tg[g], "labels": lg[g]},
                                    split, train=True)[0]
                  for g in range(n_groups)]
        return torch.stack(losses).mean() * group_members + feats["aux"]

    return loss_fn


def make_s2fl_train_step(cfg, split: int, n_groups: int, lr: float,
                         dp_axes=None, group_members: int = 1):
    """-> step(params, batch) -> (new params, loss). ``params`` is not
    changed; the new tree has each leaf's dtype (and, on a mesh, its
    placements)."""
    loss_fn = make_s2fl_loss(cfg, split, n_groups, dp_axes=dp_axes,
                             group_members=group_members)

    def step(params, batch):
        leaves, skel = tree_flatten(params)
        leaves = [w.detach().requires_grad_(True) for w in leaves]
        with _spmd(dp_axes):
            loss = loss_fn(tree_unflatten(skel, leaves), batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        new = []
        with torch.no_grad():
            for w, g in zip(leaves, grads):
                w = w.detach()
                if g is None:                # the loss does not reach w
                    new.append(w)
                    continue
                if dp_axes is not None:      # Partial(sum) -> w's layout
                    g = g.redistribute(w.device_mesh, w.placements)
                new.append((w - lr * g.to(w.dtype)).to(w.dtype))
        return tree_unflatten(skel, new), loss.detach()

    return step


def train_step_shardings(cfg, mesh, batch_abstract):
    """(in placements, out placements) of the step over (params, batch):
    trees of DTensor placement lists, the loss replicated."""
    pspecs = placements_of(model_param_specs(cfg, mesh), mesh)
    bspecs = {k: to_placements(
        (None,) if k == "perm"
        else batch_spec(mesh, v.ndim, batch_size=v.shape[0]), mesh)
        for k, v in batch_abstract.items()}
    return (pspecs, bspecs), (pspecs, to_placements((), mesh))
