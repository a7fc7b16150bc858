"""The port's grouped expert FFN against the reference's Pallas kernel.

On the CPU the wrapper takes its plain version (the reference's
``moe_gmm/ref.py``: f32 einsums, the result in x's dtype); the
reference runs ``moe_gmm`` in interpret mode, as tests/test_kernels.py
does. Inputs come from a numpy seed at the reference test's scales (x
* 0.5, weights * 0.05). Tolerances are the reference's own: atol 1e-5
with an f32 output, 2e-2 with a bf16 one. The CUDA kernel is held
against the plain version on the card by tests/test_torch_cuda.py (and
by ``chip_smoke.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.moe_gmm import ops as ref_ops
from repro.kernels.moe_gmm.kernel import moe_gmm as ref_gmm
from repro_torch.kernels.moe_gmm import kernel as gmm
from repro_torch.kernels.moe_gmm import ops

# tests/test_kernels.py GMM_CASES, then bf16 activations beside f32
# weights (the reference model's Pallas path: bf16 x, f32 params)
GMM_CASES = [
    (4, 64, 128, 256, "silu", "float32", "float32"),
    (2, 128, 64, 512, "gelu", "float32", "float32"),
    (8, 32, 256, 128, "silu", "float32", "float32"),
    (2, 64, 128, 256, "silu", "bfloat16", "bfloat16"),
    (3, 40, 96, 192, "gelu", "float32", "float32"),    # non-128 shapes
    (2, 64, 128, 256, "silu", "bfloat16", "float32"),
    (3, 40, 96, 192, "gelu", "bfloat16", "float32"),
]
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(E, C, d, F, seed=0):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=(E, C, d)) * 0.5).astype(np.float32),
            (rng.normal(size=(E, d, F)) * 0.05).astype(np.float32),
            (rng.normal(size=(E, d, F)) * 0.05).astype(np.float32),
            (rng.normal(size=(E, F, d)) * 0.05).astype(np.float32))


@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    before = dict(gmm.LAUNCHES)
    yield
    assert gmm.LAUNCHES == before


@pytest.mark.parametrize("E,C,d,F,act,xdt,wdt", GMM_CASES)
def test_plain_matches_pallas(E, C, d, F, act, xdt, wdt):
    x, wg, wu, wd = _inputs(E, C, d, F)
    ref = ref_gmm(jnp.asarray(x).astype(xdt),
                  *(jnp.asarray(w).astype(wdt) for w in (wg, wu, wd)),
                  act=act, interpret=True)
    out = gmm.moe_gmm(torch.from_numpy(x).to(_TORCH[xdt]),
                      *(torch.from_numpy(w).to(_TORCH[wdt])
                        for w in (wg, wu, wd)), act=act)
    assert out.dtype == _TORCH[xdt] and tuple(out.shape) == (E, C, d)
    atol = 2e-2 if xdt == "bfloat16" else 1e-5
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), atol=atol)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_expert_ffn_on_a_param_dict(act):
    """``ops.expert_ffn`` reads w_gate / w_up / w_down from the MoE
    param dict, as the reference's wrapper does (which runs its kernel in
    interpret mode here)."""
    x, wg, wu, wd = _inputs(4, 24, 64, 96, seed=1)
    ref = ref_ops.expert_ffn({"w_gate": jnp.asarray(wg),
                              "w_up": jnp.asarray(wu),
                              "w_down": jnp.asarray(wd)}, jnp.asarray(x), act)
    out = ops.expert_ffn({"w_gate": torch.from_numpy(wg),
                          "w_up": torch.from_numpy(wu),
                          "w_down": torch.from_numpy(wd)},
                         torch.from_numpy(x), act)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("bad", ["shape", "dtype", "act"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    x, wg, wu, wd = (torch.from_numpy(a) for a in _inputs(2, 8, 16, 24))
    if bad == "shape":
        wd = wd[:, :, :8]
    elif bad == "dtype":
        wu = wu.to(torch.float16)
    with pytest.raises(ValueError, match="moe_gmm"):
        gmm.moe_gmm(x, wg, wu, wd, act="relu" if bad == "act" else "silu")


# A CUDA call's kernel pair, from the dtypes, C, d, F and the alignment
# alone: f32 x on the fp32 cores; bf16 x with bf16 or f32 weights that
# TMA can take on "stream" up to the threshold and "wgmma" above it; the
# rest of bf16 x (d or F not a multiple of 8, a base off 16 bytes) on
# "mma".
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("above", [False, True])
@pytest.mark.parametrize("d,F", [(2048, 1408), (2044, 1408), (2048, 1404),
                                 (96, 192)])
@pytest.mark.parametrize("xdt,wdt", [("float32", "float32"),
                                     ("float32", "bfloat16"),
                                     ("bfloat16", "float32"),
                                     ("bfloat16", "bfloat16")])
def test_path_choice(xdt, wdt, d, F, above, aligned):
    C = gmm.STREAM_MAX_C + int(above)
    if xdt == "float32":
        want = "f32"
    elif aligned and d % 8 == 0 and F % 8 == 0:
        want = "wgmma" if above else "stream"
    else:
        want = "mma"
    assert gmm._path(_TORCH[xdt], _TORCH[wdt], C, d, F, aligned) == want


def test_serving_shapes_take_the_tma_paths():
    """deepseek-v2-lite's buckets: C 960 a 4 x 2048 prefill, 8 a decode
    step (d 2048, F 1408, bf16 activations; bf16 params, and the
    config's own f32 params). f32 weights TMA cannot take stay on
    "mma"."""
    bf, f32 = torch.bfloat16, torch.float32
    assert gmm._path(bf, bf, 960, 2048, 1408, True) == "wgmma"
    assert gmm._path(bf, bf, 8, 2048, 1408, True) == "stream"
    assert gmm._path(bf, f32, 960, 2048, 1408, True) == "wgmma"
    assert gmm._path(bf, f32, 8, 2048, 1408, True) == "stream"
    assert gmm._path(bf, f32, 8, 2048, 1408, False) == "mma"
    assert gmm._path(bf, f32, 960, 2044, 1408, True) == "mma"


@pytest.mark.parametrize("path,wdt,shape,dtype", [
    ("f32", "float32", (3, 40, 200), "float32"),
    ("mma", "float32", (3, 40, 200), "float32"),
    ("mma", "bfloat16", (3, 40, 200), "float32"),
    ("stream", "bfloat16", (3, 40, 200), "bfloat16"),
    ("wgmma", "bfloat16", (3, 40, 200), "bfloat16"),
    # f32 weights: hi / lo groups of 32, F 200 -> Fp 224
    ("stream", "float32", (3, 40, 448), "bfloat16"),
    ("wgmma", "float32", (3, 40, 448), "bfloat16"),
])
def test_workspace_of_each_path(path, wdt, shape, dtype):
    got = gmm._workspace(path, _TORCH[wdt], 3, 40, 200)
    assert got == (shape, _TORCH[dtype])
    assert gmm._workspace("wgmma", torch.float32, 64, 960, 1408) == (
        (64, 960, 2816), torch.bfloat16)


@pytest.mark.parametrize("view,aligned", [
    ("whole", True), ("expert_slice", True), ("shift", False)])
def test_alignment_of_views(view, aligned):
    """A contiguous bucket tensor and a slice of whole experts start on
    16 bytes; a view one element past a boundary does not (the wrapper
    keeps it: it is contiguous)."""
    x = torch.zeros(4, 8, 64, dtype=torch.bfloat16)
    if view == "expert_slice":
        x = x[1:]
    elif view == "shift":
        x = x.reshape(-1)[1:1 + 3 * 8 * 64].view(3, 8, 64)
    assert x.is_contiguous()
    assert gmm._aligned((x,)) == aligned
