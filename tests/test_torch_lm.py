"""The port's LM stack against the reference, on reduced configs in
float32: ``forward`` logits, ``prefill`` logits and caches, and four
teacher-forced ``decode_step``s, under ``attn_impl`` 'xla' and 'pallas'
('pallas' reaches the port's flash attention, SSD scan and moe_gmm
wrappers, which take their plain versions on the CPU, and the
reference's Pallas kernels in interpret mode). The MoE archs
(deepseek-v2-lite with latent attention, kimi-k2 with GQA) compare the
forward's router aux loss too. The reference's initial params are carried
across with ``models/convert.py``; tokens come from a numpy seed.

Tolerance: 2e-5 absolute on logits (|logits| ~ 1; both sides compute in
f32 and differ only in summation order) and on caches."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import make_reduced as ref_make_reduced
from repro.models import SplitModel as RefModel
from repro.models import transformer as ref_tf
from repro_torch.configs import get_config, make_reduced
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.moe_gmm import kernel as gmm_kernel
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.models import SplitModel
from repro_torch.models import transformer as tf
from repro_torch.models.convert import params_from_numpy
from repro_torch.utils.tree import tree_leaves

TOL = 2e-5
B, S, STEPS = 2, 80, 4          # S > the reduced SWA window (64) and not
                                # a multiple of the reduced SSD chunk (32)
ARCHS = ["zamba2-1.2b", "internlm2-1.8b", "h2o-danube-3-4b", "mamba2-2.7b",
         "gemma3-27b", "deepseek-v2-lite-16b", "kimi-k2-1t-a32b"]


def _configs(name, impl):
    rc = dataclasses.replace(ref_make_reduced(ref_get_config(name)),
                             attn_impl=impl)
    tc = dataclasses.replace(make_reduced(get_config(name)), attn_impl=impl)
    return rc, tc


def _params(rc):
    rp = RefModel(rc).init(jax.random.PRNGKey(0))
    return rp, params_from_numpy(jax.tree.map(np.asarray, rp), device="cpu")


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               b.detach().float().numpy(), atol=tol, rtol=0)


@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    counters = (fa_kernel.LAUNCHES, ssd_kernel.LAUNCHES, gmm_kernel.LAUNCHES)
    before = [dict(c) for c in counters]
    yield
    assert [dict(c) for c in counters] == before


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("name", ARCHS)
def test_forward_prefill_decode_match_reference(name, impl):
    rc, tc = _configs(name, impl)
    rp, tp = _params(rc)
    toks = np.random.default_rng(0).integers(
        0, rc.vocab_size, (B, S + STEPS)).astype(np.int32)
    prompt = toks[:, :S]

    rl, raux = jax.jit(lambda p, t: ref_tf.forward(rc, p, t))(
        rp, jnp.asarray(prompt))
    tl, taux = tf.forward(tc, tp, torch.from_numpy(prompt))
    _close(rl, tl)
    _close(raux, taux)                           # MoE router loss, else 0

    max_len = S + STEPS
    rlg, rcache, rn = jax.jit(
        lambda p, t: ref_tf.prefill(rc, p, t, max_len))(rp,
                                                       jnp.asarray(prompt))
    tlg, tcache, tn = tf.prefill(tc, tp, torch.from_numpy(prompt), max_len)
    assert int(rn) == tn == S
    _close(rlg, tlg)
    rleaves, tleaves = jax.tree.leaves(rcache), tree_leaves(tcache)
    assert [a.shape for a in rleaves] == [tuple(t.shape) for t in tleaves]
    for a, t in zip(rleaves, tleaves):
        _close(a, t)

    step = jax.jit(lambda p, t, c, i: ref_tf.decode_step(rc, p, t, c, i))
    for i in range(STEPS):                       # teacher-forced
        tok = toks[:, S + i:S + i + 1]
        rlg, rcache = step(rp, jnp.asarray(tok), rcache,
                           jnp.asarray(S + i, jnp.int32))
        tlg, tcache = tf.decode_step(tc, tp, torch.from_numpy(tok), tcache,
                                     S + i)
        _close(rlg, tlg)


@pytest.mark.parametrize("name,split", [("zamba2-1.2b", 1),
                                        ("internlm2-1.8b", 1),
                                        ("deepseek-v2-lite-16b", 1)])
def test_split_loss_equals_full_loss_and_reference(name, split):
    """client_forward + server_loss at a split == full_loss, on both
    sides; the port's losses equal the reference's."""
    rc, tc = _configs(name, "xla")
    rp, tp = _params(rc)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, rc.vocab_size, (B, 33)).astype(np.int32)
    batch_np = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    tbatch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    rbatch = {k: jnp.asarray(v) for k, v in batch_np.items()}

    model = SplitModel(tc)
    feats = model.client_forward(tp, tbatch, split)
    loss, _ = model.server_loss(tp, feats, tbatch, split)
    full, _ = model.full_loss(tp, tbatch)
    assert abs(float(loss) - float(full)) <= 1e-6

    ref_full, _ = jax.jit(RefModel(rc).full_loss)(rp, rbatch)
    assert abs(float(full) - float(ref_full)) <= TOL
    assert (model.client_segments(split)
            == RefModel(rc).client_segments(split))
    assert model.segments() == RefModel(rc).segments()


def test_frontend_prefix_model_matches_reference():
    """internvl2 prepends the frontend stub's embeddings to the tokens."""
    rc, tc = _configs("internvl2-1b", "xla")
    rp, tp = _params(rc)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, rc.vocab_size, (B, 16)).astype(np.int32)
    prefix = (rng.normal(size=(B, rc.n_frontend_tokens, rc.d_model))
              * 0.02).astype(np.float32)
    rl, _ = jax.jit(lambda p, t, x: ref_tf.forward(rc, p, t, x))(
        rp, jnp.asarray(toks), jnp.asarray(prefix))
    tl, _ = tf.forward(tc, tp, torch.from_numpy(toks),
                       torch.from_numpy(prefix))
    _close(rl, tl)


def test_bf16_params_carry_across_exactly():
    """gemma3 keeps its params in bfloat16: the converter takes the
    reference's bf16 leaves without ml_dtypes, bit for bit."""
    rc, tc = _configs("gemma3-27b", "xla")
    rp, tp = _params(rc)
    rleaves = jax.tree.leaves(rp)
    tleaves = tree_leaves(tp)
    assert any(a.dtype == jnp.bfloat16 for a in rleaves)
    for a, t in zip(rleaves, tleaves):
        assert str(t.dtype).endswith(str(a.dtype))
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      t.float().numpy())


def test_port_init_has_reference_shapes_and_dtypes():
    for name in ARCHS + ["internvl2-1b", "musicgen-medium", "stablelm-3b"]:
        rc, tc = _configs(name, "xla")
        ref = jax.tree.leaves(RefModel(rc).abstract())
        mine = tree_leaves(SplitModel(tc).init(0, device="cpu"))
        assert [a.shape for a in ref] == [tuple(t.shape) for t in mine]
        assert [str(a.dtype) for a in ref] == [
            str(t.dtype).removeprefix("torch.") for t in mine]


def test_ssm_init_kinds_draw_the_reference_ranges():
    """ssm_a: A = exp(A_log) in [1, 16]; ssm_dt: softplus(dt_bias) in
    [1e-3, 1e-1]; normal: std ``scale`` (the embedding, 0.02)."""
    _, tc = _configs("mamba2-2.7b", "xla")
    p = SplitModel(tc).init(0, device="cpu")
    mixer = p["blocks"][0]["mixer"]
    a = torch.exp(mixer["A_log"])
    assert mixer["A_log"].dtype == torch.float32
    assert float(a.min()) >= 1.0 and float(a.max()) <= 16.0
    dt = torch.nn.functional.softplus(mixer["dt_bias"])
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5)
    assert float(dt.max()) <= 1e-1 * (1 + 1e-5)
    assert abs(float(p["embed"]["tok"].std()) - 0.02) < 2e-3


def test_greedy_generate_matches_reference():
    from repro.launch.serve import generate as ref_generate
    from repro_torch.launch.serve import generate
    rc, tc = _configs("internlm2-1.8b", "xla")
    rp, tp = _params(rc)
    toks = np.random.default_rng(3).integers(
        0, rc.vocab_size, (B, 24)).astype(np.int32)
    ref = np.asarray(ref_generate(rc, rp, jnp.asarray(toks), steps=5))
    mine = generate(tc, tp, torch.from_numpy(toks), steps=5)
    np.testing.assert_array_equal(mine.numpy(), ref)
