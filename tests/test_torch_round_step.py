"""The fused S²FL round step (``repro_torch.core.round_step``) against the
reference's (``repro.core.round_step``) on the same numpy inputs and the
reference's initial params (carried across with ``models/convert.py``),
on the host path (``dp_axes=None``): dense, hybrid and MoE + MLA
(aux loss, shard-local dispatch) reduced configs. Losses within 1e-5
relative, params within 2e-5 (the reference's own tolerances,
``tests/test_engine.py:182-191``).

Also the port's counterparts of the reference's E=1 equivalence and
balance-permutation tests (``tests/test_engine.py:152, 194``), the
``group_members`` scaling of Eq. 3 and the gradient cast at the cut."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import make_reduced as ref_make_reduced
from repro.core.round_step import make_s2fl_loss as ref_make_loss
from repro.core.round_step import make_s2fl_train_step as ref_make_step
from repro.models.api import SplitModel as RefModel
from repro_torch.configs import get_config, make_reduced
from repro_torch.core import round_step
from repro_torch.core.round_step import (make_s2fl_loss,
                                         make_s2fl_train_step)
from repro_torch.models import SplitModel
from repro_torch.models.convert import params_from_numpy
from repro_torch.utils.tree import tree_leaves

ARCHS = ["internlm2-1.8b", "zamba2-1.2b", "deepseek-v2-lite-16b"]
B, S = 8, 16


def _configs(arch, **repl):
    """(reference cfg, port cfg), reduced; MoE with shard-local
    dispatch over 2 shards."""
    if arch == "deepseek-v2-lite-16b":
        repl.setdefault("moe_dispatch_shards", 2)
    rcfg = dataclasses.replace(ref_make_reduced(ref_get_config(arch)),
                               **repl)
    tcfg = dataclasses.replace(make_reduced(get_config(arch)), **repl)
    return rcfg, tcfg


def _params(rcfg):
    rp = RefModel(rcfg).init(jax.random.PRNGKey(0))
    return rp, params_from_numpy(jax.tree.map(np.asarray, rp), device="cpu")


def _batch(cfg, seed=0, perm=None):
    rng = np.random.default_rng(seed)
    nb = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
          "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
          "perm": (rng.permutation(B) if perm is None else perm)
          .astype(np.int32)}
    return ({k: jnp.asarray(v) for k, v in nb.items()},
            {k: torch.from_numpy(v) for k, v in nb.items()})


def _close_trees(ref_tree, port_tree, atol):
    ref, port = jax.tree.leaves(ref_tree), tree_leaves(port_tree)
    assert len(ref) == len(port)
    for a, b in zip(ref, port):
        assert str(b.dtype).split(".")[-1] == np.asarray(a).dtype.name
        np.testing.assert_allclose(np.asarray(a, np.float32),
                                   b.float().numpy(), atol=atol, rtol=0)


@pytest.mark.parametrize("split,groups,members", [(1, 2, 2), (1, 4, 1)])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, split, groups, members):
    rcfg, tcfg = _configs(arch)
    rp, tp = _params(rcfg)
    rb, tb = _batch(tcfg)
    r_new, r_loss = jax.jit(ref_make_step(rcfg, split, groups, 0.05,
                                          group_members=members))(rp, rb)
    t_new, t_loss = make_s2fl_train_step(tcfg, split, groups, 0.05,
                                         group_members=members)(tp, tb)
    np.testing.assert_allclose(float(t_loss), float(r_loss), rtol=1e-5)
    _close_trees(r_new, t_new, 2e-5)
    # the input tree is not changed
    for a, b in zip(jax.tree.leaves(rp), tree_leaves(tp)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_fused_round_step_matches_engine_e1():
    """The fused step reproduces the host engine's E=1 round: the same
    grouping, the same SGD update -- held to a hand-written loop over the
    groups, as the reference's test holds its step."""
    _, cfg = _configs("internlm2-1.8b")
    model = SplitModel(cfg)
    params = model.init(0, device="cpu")
    split, n_groups, lr = 1, 2, 0.05
    _, batch = _batch(cfg)
    tokens, labels, perm = (batch["tokens"], batch["labels"],
                            batch["perm"].long())
    new_params, loss = make_s2fl_train_step(cfg, split, n_groups, lr)(
        params, batch)

    leaves = [t.detach().clone().requires_grad_(True)
              for t in tree_leaves(params)]
    from repro_torch.utils.tree import tree_flatten, tree_unflatten
    p = tree_unflatten(tree_flatten(params)[1], leaves)
    feats = model.client_forward(p, {"tokens": tokens}, split)
    h, t_p, l_p = feats["h"][perm], tokens[perm], labels[perm]
    gb = B // n_groups
    losses = []
    for g in range(n_groups):
        sl = slice(g * gb, (g + 1) * gb)
        losses.append(model.server_loss(
            p, {"h": h[sl], "aux": torch.zeros(())},
            {"tokens": t_p[sl], "labels": l_p[sl]}, split)[0])
    ref_l = torch.stack(losses).mean() + feats["aux"]
    grads = torch.autograd.grad(ref_l, leaves, allow_unused=True)
    np.testing.assert_allclose(float(loss), float(ref_l.detach()), rtol=1e-5)
    for a, w, g in zip(tree_leaves(new_params), tree_leaves(params), grads):
        want = w if g is None else w - lr * g
        np.testing.assert_allclose(a.numpy(), want.detach().numpy(),
                                   atol=2e-5)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "deepseek-v2-lite-16b"])
def test_fused_loss_balance_permutation_changes_groups(arch):
    """Different perms -> different group compositions, and the packages
    agree on both. A dense model's loss is the mean of per-group CE
    means, so with equal groups it is invariant under the permutation
    (the fusion's sanity); an MoE server half buckets and drops tokens
    per group and its router loss reads the group, so there the
    permutation changes the loss (the features really are routed)."""
    rcfg, tcfg = _configs(arch)
    rp, tp = _params(rcfg)
    ident = np.arange(B)
    shuffled = np.random.default_rng(1).permutation(B)
    losses = []
    for perm in (ident, shuffled):
        rb, tb = _batch(tcfg, perm=perm)
        r = float(ref_make_loss(rcfg, split=1, n_groups=2)(rp, rb))
        with torch.no_grad():
            t = float(make_s2fl_loss(tcfg, split=1, n_groups=2)(tp, tb))
        np.testing.assert_allclose(t, r, rtol=1e-5)
        losses.append(t)
    if tcfg.n_experts:
        assert abs(losses[0] - losses[1]) > 1e-3, losses
    else:
        np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "deepseek-v2-lite-16b"])
def test_group_members_scale_the_server_loss(arch):
    """Eq. 3 sums per-client losses: ``group_members`` m multiplies the
    mean of the group losses, the server half's router loss with them
    (deepseek's second layer is MoE), and not the client half's aux
    loss."""
    _, cfg = _configs(arch)
    params = SplitModel(cfg).init(0, device="cpu")
    _, batch = _batch(cfg)
    with torch.no_grad():
        aux = float(SplitModel(cfg).client_forward(params, batch, 1)["aux"])
        l1 = float(make_s2fl_loss(cfg, 1, 2)(params, batch))
        l3 = float(make_s2fl_loss(cfg, 1, 2, group_members=3)(params, batch))
    np.testing.assert_allclose(l3 - aux, 3 * (l1 - aux), rtol=1e-6)


def test_gradient_at_the_cut_is_in_the_compute_dtype(monkeypatch):
    """Under a bf16 config the gradient that reaches the client half's
    features is bf16; the cast itself rounds a wider gradient to the
    compute dtype."""
    _, cfg = _configs("internlm2-1.8b", dtype="bfloat16")
    seen = []
    forward = SplitModel.client_forward

    def hooked(self, *a, **kw):
        feats = forward(self, *a, **kw)
        feats["h"].register_hook(lambda g: seen.append(g.dtype))
        return feats
    monkeypatch.setattr(SplitModel, "client_forward", hooked)
    params = SplitModel(cfg).init(0, device="cpu")
    _, batch = _batch(cfg)
    _, loss = make_s2fl_train_step(cfg, 1, 2, 0.05)(params, batch)
    assert seen == [torch.bfloat16] and bool(torch.isfinite(loss))

    x = torch.zeros(5, requires_grad=True)
    g = torch.tensor([1.0, 1.0 + 2 ** -10, 3.14159, -2e-3, 7.0])
    round_step._grad_cast(x, torch.bfloat16).backward(g)
    assert torch.equal(x.grad, g.to(torch.bfloat16).float())
    assert not torch.equal(x.grad, g)


def test_step_leaves_its_inputs_to_reference_counting():
    """Once the caller drops them, the params a step read and the params
    it made are freed at once, without the cyclic collector: a training
    loop does not collect between steps, and a params set kept until
    then holds a whole f32 copy of the model."""
    import gc
    import weakref
    _, cfg = _configs("internlm2-1.8b")
    params = SplitModel(cfg).init(0, device="cpu")
    _, batch = _batch(cfg)
    step = make_s2fl_train_step(cfg, 1, 2, 0.05)
    gc.collect()
    gc.disable()
    try:
        new, loss = step(params, batch)
        refs = [weakref.ref(t) for t in tree_leaves(params) + tree_leaves(new)]
        del params, new, loss
        alive = sum(r() is not None for r in refs)
    finally:
        gc.enable()
    assert alive == 0, f"{alive} of {len(refs)} leaves kept by a cycle"
