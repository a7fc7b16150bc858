"""Top-k ties go to the lower index, as ``jax.lax.top_k`` breaks them, at
the port's three top-k sites: the MoE router, ``TopKCodec`` and the fused
cohort combine's selection (``utils/topk.py``, one helper for all three).

The inputs are built to tie at the threshold: +/- pairs of one magnitude
and bf16-rounded magnitudes (bf16 payloads have few distinct values).
Indices are compared with ``jax.lax.top_k``; the codec's delivered
values and error-feedback residual, the fused combine's and the MoE
block's output with the reference's."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm.codecs import TopKCodec as RefTopK
from repro.configs import get_config as ref_get_config
from repro.configs import make_reduced as ref_make_reduced
from repro.kernels.comm_fused import ops as ref_fused
from repro.models import moe as ref_moe
from repro.models.api import SplitModel as RefModel
from repro_torch.comm.codecs import TopKCodec
from repro_torch.configs import get_config, make_reduced
from repro_torch.kernels.comm_fused import ops as fused
from repro_torch.models import moe
from repro_torch.models.convert import params_from_numpy
from repro_torch.utils.topk import top_k


def _pairs(rng, shape):
    """+/- pairs of a handful of magnitudes: |x| ties everywhere."""
    mags = rng.choice(np.array([0.5, 1.0, 1.5, 2.0], np.float32), shape)
    return mags * rng.choice(np.array([-1.0, 1.0], np.float32), shape)


def _bf16_rounded(rng, shape):
    """Normal values rounded to bf16 and back: few distinct magnitudes."""
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32) * 0.01)
    return x.to(torch.bfloat16).float().numpy()


INPUTS = {"pairs": _pairs, "bf16": _bf16_rounded}


@pytest.mark.parametrize("kind", list(INPUTS))
@pytest.mark.parametrize("n,k", [(64, 6), (300, 30), (4096, 410), (17, 17),
                                 (9, 1)])
def test_top_k_matches_lax_top_k_with_ties(kind, n, k):
    x = np.abs(INPUTS[kind](np.random.default_rng(n + k), (4, n)))
    rv, ri = jax.lax.top_k(jnp.asarray(x), k)
    tv, ti = top_k(torch.from_numpy(x), k)
    # the inputs do tie at the threshold (bf16 values, from 300 on)
    kth = np.sort(x, axis=1)[:, ::-1][:, k - 1]
    if kind == "pairs" or n >= 300:
        assert ((x == kth[:, None]).sum(1) > 1).any() or k == n
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))


def test_top_k_under_vmap_and_autograd():
    """Runs under ``torch.func.vmap`` (the multi-group server step) and
    passes gradients to the kept values, as ``torch.topk`` does."""
    x = torch.tensor([[1.0, 3.0, 3.0, 0.5, 3.0], [2.0, 2.0, 1.0, 2.0, 0.0]],
                     requires_grad=True)
    v, i = torch.func.vmap(lambda r: top_k(r, 2))(x)
    assert i.tolist() == [[1, 2], [0, 1]]
    v.sum().backward()
    assert x.grad.tolist() == [[0, 1, 1, 0, 0], [1, 1, 0, 0, 0]]


@pytest.mark.parametrize("kind", list(INPUTS))
def test_codec_delivers_what_the_reference_delivers(kind):
    """``TopKCodec``: the same indices, delivered values and residual
    (x - delivered) as the reference's codec."""
    x = INPUTS[kind](np.random.default_rng(3), (16, 64))
    ref, port = RefTopK(0.1), TopKCodec(0.1)
    (ri, rvals, _), rbytes = ref.encode(jnp.asarray(x))
    (ti, tvals, shape), tbytes = port.encode(torch.from_numpy(x))
    assert tbytes == rbytes
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(tvals.numpy(), np.asarray(rvals))
    r_out = np.asarray(ref.decode((ri, rvals, x.shape)))
    t_out = port.decode((ti, tvals, shape)).numpy()
    np.testing.assert_array_equal(t_out, r_out)
    np.testing.assert_array_equal(x - t_out, x - r_out)


@pytest.mark.parametrize("kind", list(INPUTS))
def test_fused_combine_selects_what_the_reference_selects(kind):
    """The fused cohort path's top-k (rows of a stacked cohort) with an
    error-feedback residual: delivered and new residual equal the
    reference's."""
    rng = np.random.default_rng(5)
    x = INPUTS[kind](rng, (4, 512))
    r = INPUTS[kind](rng, (4, 512)) * 0.0
    rd, rr = ref_fused.fused_sparse_roundtrip(jnp.asarray(x), jnp.asarray(r),
                                              k=51)
    td, tr = fused.fused_sparse_roundtrip(torch.from_numpy(x),
                                          torch.from_numpy(r), k=51)
    np.testing.assert_array_equal(td.numpy(), np.asarray(rd))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(rr))


def test_router_ties_pick_the_lower_experts():
    """A router that scores every expert equally: the reference takes
    experts 0..k-1 for every token, and so does the port; the MoE
    block's output and router loss agree."""
    rcfg = ref_make_reduced(ref_get_config("deepseek-v2-lite-16b"))
    cfg = make_reduced(get_config("deepseek-v2-lite-16b"))
    rp = RefModel(rcfg).init(jax.random.PRNGKey(0))
    moe_idx = [i for i, (_, f) in enumerate(cfg.pattern()) if f == "moe"][0]
    rblock = jax.tree.map(np.asarray, rp["blocks"][moe_idx]["ffn"])
    rblock["router"] = np.zeros_like(rblock["router"])   # all gates equal
    pblock = params_from_numpy(rblock, device="cpu")
    x = np.random.default_rng(0).normal(size=(2, 8, cfg.d_model)) \
        .astype(np.float32)
    r_out, r_aux = ref_moe.moe_apply(rcfg, jax.tree.map(jnp.asarray, rblock),
                                     jnp.asarray(x))
    t_out, t_aux = moe.moe_apply(cfg, pblock, torch.from_numpy(x))
    scale = float(np.abs(np.asarray(r_out)).max())
    np.testing.assert_allclose(t_out.numpy(), np.asarray(r_out),
                               atol=1e-5 * scale, rtol=0)
    np.testing.assert_allclose(float(t_aux), float(r_aux), rtol=1e-6)
    gates = torch.full((16, cfg.n_experts), 1.0 / cfg.n_experts)
    assert top_k(gates, cfg.top_k)[1].tolist() == \
        [list(range(cfg.top_k))] * 16


def test_router_tie_changes_the_output_against_other_choices():
    """The tie rule matters: with equal gates, picking the last k experts
    instead gives another output (so the test above can tell)."""
    cfg = dataclasses.replace(make_reduced(get_config(
        "deepseek-v2-lite-16b")), n_shared_experts=0)
    from repro_torch.models import SplitModel
    p = SplitModel(cfg).init(0, device="cpu")
    moe_idx = [i for i, (_, f) in enumerate(cfg.pattern()) if f == "moe"][0]
    block = dict(p["blocks"][moe_idx]["ffn"])
    block["router"] = torch.zeros_like(block["router"])
    x = torch.randn(2, 8, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    low, _ = moe.moe_apply(cfg, block, x)
    flipped = {k: (v.flip(0) if k.startswith("w_") else v)
               for k, v in block.items()}
    high, _ = moe.moe_apply(cfg, flipped, x)
    assert not torch.allclose(low, high)
