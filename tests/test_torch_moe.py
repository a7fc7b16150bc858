"""The port's MoE feed-forward and latent attention (MLA) against the
reference, on reduced deepseek-v2-lite in float32.

The reference's params (its ``init_params`` on a JAX key) are carried
across with ``models/convert.py``; activations come from a numpy seed.
``attn_impl='pallas'`` reaches the port's moe_gmm and flash wrappers,
which take their plain versions on the CPU, and the reference's Pallas
kernels in interpret mode. Tolerance: 2e-5 absolute, and 2e-5 of the
largest magnitude for the MoE outputs (both sides compute in f32 and
differ only in summation order; the reference's fan-in init takes the
expert axis as fan-in, so the reduced experts' weights have std 1/2 and
their outputs reach a few hundred, where f32 rounding alone is ~1e-4).

Routing: ``jax.lax.top_k`` breaks ties toward the lower index and
``torch.topk`` leaves their order unspecified. The router scores here
are f32 softmaxes of random projections, where ties do not occur, so
the tests compare the two as they are rather than sorting."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import make_reduced as ref_make_reduced
from repro.models import attention as ref_attn
from repro.models import moe as ref_moe
from repro.models.params import init_params as ref_init_params
from repro_torch.configs import get_config, make_reduced
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.moe_gmm import kernel as gmm_kernel
from repro_torch.models import attention as attn
from repro_torch.models import moe
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.layers import mlp
from repro_torch.utils.tree import tree_leaves

TOL = 2e-5
NAME = "deepseek-v2-lite-16b"


def _configs(impl="xla", **repl):
    rc = dataclasses.replace(ref_make_reduced(ref_get_config(NAME)),
                             attn_impl=impl, **repl)
    tc = dataclasses.replace(make_reduced(get_config(NAME)),
                             attn_impl=impl, **repl)
    return rc, tc


def _params(defs_fn, rc, seed=0):
    rp = ref_init_params(defs_fn(rc), jax.random.PRNGKey(seed), "float32")
    return rp, params_from_numpy(jax.tree.map(np.asarray, rp), device="cpu")


def _x(shape, seed):
    return (np.random.default_rng(seed).normal(size=shape)
            * 0.5).astype(np.float32)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               b.detach().float().numpy(), atol=tol, rtol=0)


def _close_scaled(a, b):
    a = np.asarray(a, np.float32)
    _close(a, b, TOL * max(1.0, float(np.abs(a).max())))


@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    before = {**fa_kernel.LAUNCHES, **gmm_kernel.LAUNCHES}
    yield
    assert {**fa_kernel.LAUNCHES, **gmm_kernel.LAUNCHES} == before


# ------------------------------------------------------------------ MoE
@pytest.mark.parametrize("shards", [0, 4])
@pytest.mark.parametrize("capacity", [1.25, 0.05])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_moe_apply_matches_reference(impl, capacity, shards):
    """out and aux, global and shard-local dispatch, with and without
    capacity drops."""
    rc, tc = _configs(impl, moe_dispatch_shards=shards)
    rp, tp = _params(ref_moe.moe_defs, rc)
    x = _x((8, 12, rc.d_model), 0)
    r_out, r_aux = jax.jit(lambda p, v: ref_moe.moe_apply(
        rc, p, v, capacity_factor=capacity))(rp, jnp.asarray(x))
    t_out, t_aux = moe.moe_apply(tc, tp, torch.from_numpy(x),
                                 capacity_factor=capacity)
    _close_scaled(r_out, t_out)
    _close(r_aux, t_aux)


def test_dispatch_matches_dense_reference():
    """Capacity-bucketed dispatch == every token through its top-k
    experts densely (tests/test_moe_dispatch.py, on the port)."""
    _, tc = _configs()
    _, p = _params(ref_moe.moe_defs, _configs()[0])
    x = torch.from_numpy(_x((4, 32, tc.d_model), 1))
    out, _ = moe.moe_apply(tc, p, x)
    xt = x.reshape(-1, tc.d_model)
    gates = torch.softmax(xt @ p["router"], -1)
    topw, topi = torch.topk(gates, tc.top_k, dim=-1)
    topw = topw / topw.sum(-1, keepdim=True)

    def ffn_e(e, v):
        g = torch.nn.functional.silu(v @ p["w_gate"][e])
        return (g * (v @ p["w_up"][e])) @ p["w_down"][e]

    ref = torch.zeros_like(xt)
    for j in range(tc.top_k):
        for t in range(xt.shape[0]):
            ref[t] += topw[t, j] * ffn_e(int(topi[t, j]), xt[t])
    ref = ref + mlp(p["shared"], xt, tc.act)
    torch.testing.assert_close(out.reshape(-1, tc.d_model), ref, atol=5e-4,
                               rtol=0)


def test_shard_local_matches_global_when_no_drops():
    rc, tc = _configs()
    _, p = _params(ref_moe.moe_defs, rc)
    x = torch.from_numpy(_x((8, 16, tc.d_model), 2))
    out_g, _ = moe.moe_apply(tc, p, x)
    out_s, _ = moe.moe_apply(dataclasses.replace(tc, moe_dispatch_shards=4),
                             p, x)
    torch.testing.assert_close(out_g, out_s, atol=5e-4, rtol=0)


def test_capacity_drops_zero_contribution():
    """With capacity 0 < C << T, dropped tokens contribute only the
    shared-expert output."""
    rc, tc = _configs()
    _, p = _params(ref_moe.moe_defs, rc)
    x = torch.from_numpy(_x((2, 64, tc.d_model), 3))
    out_tight, _ = moe.moe_apply(tc, p, x, capacity_factor=0.05)
    out_loose, _ = moe.moe_apply(tc, p, x, capacity_factor=4.0)
    assert float((out_tight - out_loose).abs().max()) > 1e-4
    assert bool(torch.isfinite(out_tight).all())


@pytest.mark.parametrize("seed", range(5))
def test_sort_ranking_is_token_order(seed):
    """Positions within each expert are 0..count-1 in increasing token
    order (first come, first served: what capacity dropping relies on),
    in each shard row on its own."""
    rng = np.random.default_rng(seed)
    E, G, N = 5, 3, 64
    flat_e = rng.integers(0, E, size=(G, N))
    pos = moe.positions_in_expert(torch.from_numpy(flat_e), E).numpy()
    for g in range(G):
        for e in range(E):
            idx = np.flatnonzero(flat_e[g] == e)
            assert pos[g, idx].tolist() == list(range(len(idx)))


# ------------------------------------------------------------------ MLA
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_mla_prefill_caches_and_absorbed_decode_match_reference(impl):
    """Prefill (through flash under 'pallas') fills the latent and rope-key
    caches; 4 decode steps run the absorbed path over them."""
    rc, tc = _configs(impl)
    rp, tp = _params(ref_attn.attn_defs, rc, seed=1)
    B, S, steps = 2, 40, 4
    x = _x((B, S + steps, rc.d_model), 4)
    max_len = S + steps

    rcache = ref_attn.init_attn_cache(rc, "attn", B, max_len, jnp.float32)
    tcache = attn.init_attn_cache(tc, "attn", B, max_len, torch.float32,
                                  "cpu")
    r_out, rcache = jax.jit(lambda p, v, c: ref_attn.mla_apply(
        rc, p, v, jnp.arange(S, dtype=jnp.int32), c))(
            rp, jnp.asarray(x[:, :S]), rcache)
    t_out, tcache = attn.mla_apply(tc, tp, torch.from_numpy(x[:, :S]),
                                   torch.arange(S, dtype=torch.int32),
                                   tcache)
    _close(r_out, t_out)
    rleaves, tleaves = jax.tree.leaves(rcache), tree_leaves(tcache)
    assert [a.shape for a in rleaves] == [tuple(t.shape) for t in tleaves]
    for a, t in zip(rleaves, tleaves):
        _close(a, t)

    step = jax.jit(lambda p, v, c, i: ref_attn.mla_apply(
        rc, p, v, i[None], c, i))
    for i in range(S, S + steps):
        r_out, rcache = step(rp, jnp.asarray(x[:, i:i + 1]), rcache,
                             jnp.asarray(i, jnp.int32))
        t_out, tcache = attn.mla_apply(
            tc, tp, torch.from_numpy(x[:, i:i + 1]),
            torch.tensor([i], dtype=torch.int32), tcache, i)
        _close(r_out, t_out)
    for a, t in zip(jax.tree.leaves(rcache), tree_leaves(tcache)):
        _close(a, t)
