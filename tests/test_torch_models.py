"""The port's CNN models against the reference, on the CPU.

The reference's initial parameters are carried into the port with
``models/convert.py`` (same tree, same leaf shapes), and the same numpy
batch goes through both. For every split of the default plan: the
client forward, the server loss and the gradients w.r.t. parameters and
cut features.

In float64 (resnet8 and the VGG family; torch's float64 convolutions
on the CPU are too slow for mobilenet's 14 units here) both packages
agree to 1e-10: the algorithm is the same. In
float32, oneDNN and XLA sum convolutions in different orders, so values
are held to 1e-4, and gradients to 1e-2 in relative L2 norm over the
tree: a rounding difference can flip a max-pool near-tie and route one
window's gradient to another element (measured on vgg-narrow at split
1: 5 of 8192 dfx elements, 1.8e-4 off, where torch in float64 matches
the reference in float64 to 1e-17)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core.split import default_plan
from repro.models import SplitModel as RefModel
from repro_torch.configs import CNNConfig, get_config
from repro_torch.models import SplitModel
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.utils.tree import tree_flatten, tree_unflatten

TOLS = {np.float64: dict(values=1e-10, grads=1e-10),
        np.float32: dict(values=1e-4, grads=1e-2)}

# a narrow member of the VGG family: two max-pool stages, 3 conv units
VGG_NARROW = dict(name="vgg-narrow", family="vgg",
                  stages=((8, 1), (16, 2)))


def _cfgs(name):
    if name == "vgg-narrow":
        import repro.configs.base as rb
        return rb.CNNConfig(**VGG_NARROW), CNNConfig(**VGG_NARROW)
    return ref_get_config(name), get_config(name)


def _np_tree(tree, dtype=None):
    return jax.tree.map(lambda a: np.asarray(a, dtype=dtype), tree)


def _grads_close(port, ref, tol, what):
    """port: tensors or None (a leaf the loss does not reach: zero in
    the reference); relative L2 error over the whole list."""
    ref = [np.asarray(b, np.float64) for b in ref]
    for a, b in zip(port, ref):
        if a is None:
            assert not b.any(), what
    num = sum(float(((a.detach().double().numpy() - b) ** 2).sum())
              for a, b in zip(port, ref) if a is not None)
    den = sum(float((b ** 2).sum()) for b in ref)
    assert num ** 0.5 <= tol * den ** 0.5, (what, (num / den) ** 0.5)


def _check_model(name, dtype):
    tol = TOLS[dtype]
    rcfg, tcfg = _cfgs(name)
    rm, tm = RefModel(rcfg), SplitModel(tcfg)
    assert rm.n_units == tm.n_units
    assert rm.segments() == tm.segments()
    # the port's seeded init, carried to the reference as numpy arrays
    rp_np = _np_tree(params_to_numpy(tm.init(3, device="cpu")), dtype)
    rp = jax.tree.map(jnp.asarray, rp_np)
    tp = params_from_numpy(rp_np, device="cpu")
    leaves, skel = tree_flatten(tp)
    rng = np.random.default_rng(5)
    B = 2
    x = rng.normal(size=(B, 32, 32, 3)).astype(dtype)
    y = rng.integers(0, 10, size=B).astype(np.int32)
    rb = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    tb = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}

    def close(a, b, what):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=tol["values"], rtol=tol["values"],
                                   err_msg=what)

    for s in default_plan(rm.n_units, k=3).split_points:
        assert rm.client_segments(s) == tm.client_segments(s)

        @jax.jit
        def ref_client(p, ct):
            h, vjp = jax.vjp(lambda pp: rm.client_forward(pp, rb, s)["h"],
                             p)
            return h, vjp(ct)[0]

        @jax.jit
        def ref_server(p, h):
            feats = {"h": h, "aux": jnp.zeros((), dtype)}
            (l, _), (gp, gf) = jax.value_and_grad(
                lambda p, f: rm.server_loss(p, f, rb, s), argnums=(0, 1),
                has_aux=True)(p, feats)
            return l, gp, gf["h"]

        # client half: value and vjp with a seeded cotangent
        req = [t.clone().requires_grad_(True) for t in leaves]
        th = tm.client_forward(tree_unflatten(skel, req), tb, s)["h"]
        ct = rng.normal(size=tuple(th.shape)).astype(dtype)
        rh, rg = ref_client(rp, jnp.asarray(ct))
        close(th.detach(), rh, f"{name} h at split {s}")
        tg = torch.autograd.grad(th, req, grad_outputs=torch.from_numpy(ct),
                                 allow_unused=True)
        _grads_close(tg, jax.tree.leaves(rg), tol["grads"],
                     f"{name} client grads at split {s}")

        # server half: loss, grads w.r.t. params and the cut features
        rl, rgp, rgf = ref_server(rp, rh)
        req = [t.clone().requires_grad_(True) for t in leaves]
        hf = torch.tensor(np.asarray(rh)).requires_grad_(True)
        tl, _ = tm.server_loss(tree_unflatten(skel, req),
                               {"h": hf, "aux": torch.zeros((), dtype=hf.dtype)},
                               tb, s)
        close(tl.detach(), rl, f"{name} server loss at split {s}")
        grads = torch.autograd.grad(tl, req + [hf], allow_unused=True)
        _grads_close(grads[-1:], [rgf], tol["grads"],
                     f"{name} dfx at split {s}")
        _grads_close(grads[:-1], jax.tree.leaves(rgp), tol["grads"],
                     f"{name} server grads at split {s}")

    # the monolithic loss (FedAvg baseline / eval)
    (rl, rmet) = jax.jit(rm.full_loss)(rp, rb)
    tl, tmet = tm.full_loss(tp, tb)
    close(tl.detach(), rl, f"{name} full loss")
    assert float(tmet["acc"]) == float(rmet["acc"])


@pytest.mark.parametrize("name", ["resnet8", "mobilenet", "vgg-narrow"])
def test_split_halves_and_grads_match_reference_f32(name):
    _check_model(name, np.float32)


@pytest.mark.parametrize("name", ["resnet8", "vgg-narrow"])
def test_split_halves_and_grads_match_reference_f64(name):
    with jax.enable_x64(True):
        _check_model(name, np.float64)
