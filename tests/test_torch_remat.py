"""Per-block remat (``cfg.remat`` / ``cfg.remat_policy``) in the port's
transformer: the reference's per-block ``jax.checkpoint``
(``models/transformer.py:186-207``), with ``'dots'`` as JAX's
``dots_with_no_batch_dims_saveable``.

Remat changes what is kept for the backward pass, not the numbers: the
loss and every gradient are held bit-equal (f32, CPU) to remat off for a
dense, a hybrid and an MoE config. A ``saved_tensors_hooks`` count shows
that the checkpoint really happens, and the multi-group server step
(``fused_server``, which runs its blocks under ``torch.func`` with remat
off) gives the same run with remat on as with it off."""
import dataclasses

import pytest
import torch
from torch.autograd.graph import saved_tensors_hooks
from torch.utils.checkpoint import CheckpointPolicy

import torch_engine_golden  # noqa: F401  (one intra-op thread)
from repro_torch.configs import get_config, make_reduced
from repro_torch.core.engine import EngineConfig, S2FLEngine
from repro_torch.data.partition import federate
from repro_torch.data.synthetic import make_lm_dataset
from repro_torch.models import SplitModel
from repro_torch.models import transformer as tf
from repro_torch.utils.tree import tree_leaves

ARCHS = ["internlm2-1.8b", "zamba2-1.2b", "deepseek-v2-lite-16b"]


def _loss_and_grads(cfg, train=True):
    """Full-model loss on a fixed batch, its gradient w.r.t. every
    leaf, and how many tensors autograd saved (outer hooks)."""
    params = SplitModel(cfg).init(0, device="cpu")
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 32),
                                     generator=gen),
             "labels": torch.randint(0, cfg.vocab_size, (4, 32),
                                     generator=gen)}
    saved = [0]

    def pack(t):
        saved[0] += 1
        return t
    with saved_tensors_hooks(pack, lambda t: t):
        loss, _ = SplitModel(cfg).full_loss(params, batch, train=train)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), grads, saved[0]


def _remat(arch, policy):
    return dataclasses.replace(make_reduced(get_config(arch)), remat=True,
                               remat_policy=policy)


@pytest.mark.parametrize("policy", ["", "dots"])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_loss_and_grads_bit_equal_to_remat_off(arch, policy):
    base = make_reduced(get_config(arch))
    assert not base.remat and base.dtype == "float32"
    l0, g0, _ = _loss_and_grads(base)
    l1, g1, _ = _loss_and_grads(_remat(arch, policy))
    assert torch.equal(l0, l1)
    assert len(g0) == len(g1)
    for a, b in zip(g0, g1):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_saves_fewer_tensors(arch, monkeypatch):
    """With remat, autograd keeps only each block's inputs: far fewer
    tensors pass the outer saved-tensor hooks. ``'dots'`` keeps the
    projections' outputs inside the checkpoint (its policy says
    MUST_SAVE for them), and nothing is checkpointed outside training."""
    _, _, off = _loss_and_grads(make_reduced(get_config(arch)))
    _, _, full = _loss_and_grads(_remat(arch, ""))
    decisions = []
    policy = tf._save_dots

    def counted(ctx, op, *args, **kw):
        d = policy(ctx, op, *args, **kw)
        decisions.append((op, d))
        return d
    monkeypatch.setattr(tf, "_save_dots", counted)
    _, _, dots = _loss_and_grads(_remat(arch, "dots"))
    assert full < off / 2 and dots == full, (off, full, dots)
    saved = [op for op, d in decisions if d == CheckpointPolicy.MUST_SAVE]
    assert saved and all(op in (tf._MM, tf._BMM) for op in saved)
    assert any(d == CheckpointPolicy.PREFER_RECOMPUTE
               for _, d in decisions)
    _, _, evaluated = _loss_and_grads(_remat(arch, ""), train=False)
    assert evaluated == off


def _fused_run(cfg):
    ds = make_lm_dataset(48, seq_len=16, vocab=256, seed=0)
    eng = S2FLEngine(SplitModel(cfg), federate(ds, 4, alpha=0.5, seed=0),
                     EngineConfig(rounds=2, clients_per_round=4,
                                  batch_size=4, group_size=2,
                                  fused_server=True, seed=0),
                     device="cpu")
    calls = []
    step = eng._multi_server_step
    eng._multi_server_step = lambda *a: calls.append(1) or step(*a)
    eng.run(rounds=2)
    return eng, len(calls)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "deepseek-v2-lite-16b"])
def test_fused_server_with_remat_equals_without(arch):
    """The vmapped multi-group server step runs its blocks with remat off
    (``torch.func`` refuses checkpoint's hooks); the rest of the round
    checkpoints. The whole run is bit-equal to the run with remat off."""
    base = make_reduced(get_config(arch))
    plain, n_plain = _fused_run(base)
    remat, n_remat = _fused_run(dataclasses.replace(base, remat=True))
    assert remat._func_model.cfg.remat is False
    assert n_plain == n_remat > 0
    assert [h["loss"] for h in plain.history] == \
        [h["loss"] for h in remat.history]
    for a, b in zip(tree_leaves(plain.params), tree_leaves(remat.params)):
        assert torch.equal(a, b)
