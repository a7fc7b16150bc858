"""The port's flash attention against the reference's Pallas kernel.

On the CPU the wrapper takes its plain version (dense masked softmax
attention); the reference runs ``flash_attention_fwd`` in interpret
mode. Inputs come from a numpy seed. Tolerances are the reference's own
(tests/test_kernels.py): atol 2e-5 in f32, 2e-2 in bf16. The CUDA
kernel is held against the plain version on the card by
tests/test_torch_cuda.py (and by ``chip_smoke.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as ref_ops
from repro.kernels.flash_attention.kernel import \
    flash_attention_fwd as ref_flash
from repro_torch.kernels.flash_attention import kernel as fa
from repro_torch.kernels.flash_attention import ops

# (BH, S, T, D, G, causal, window, dtype): tests/test_kernels.py FA_CASES
FA_CASES = [
    (4, 128, 128, 64, 1, True, 0, "float32"),
    (4, 256, 256, 64, 2, True, 0, "float32"),
    (2, 256, 256, 128, 1, True, 64, "float32"),
    (6, 512, 512, 64, 3, False, 0, "float32"),
    (2, 128, 128, 32, 1, True, 0, "bfloat16"),
    (4, 384, 384, 64, 4, True, 128, "float32"),
    (2, 64, 64, 96, 2, True, 0, "float32"),
]
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(BH, S, T, D, G, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(BH, S, D)).astype(np.float32),
            rng.normal(size=(BH // G, T, D)).astype(np.float32),
            rng.normal(size=(BH // G, T, D)).astype(np.float32))


@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    before = dict(fa.LAUNCHES)
    yield
    assert fa.LAUNCHES == before


@pytest.mark.parametrize("BH,S,T,D,G,causal,window,dtype", FA_CASES)
def test_plain_matches_pallas(BH, S, T, D, G, causal, window, dtype):
    q, k, v = _inputs(BH, S, T, D, G)
    ref = ref_flash(*(jnp.asarray(a).astype(dtype) for a in (q, k, v)),
                    causal=causal, window=window, groups=G, interpret=True)
    out = fa.flash_attention_fwd(
        *(torch.from_numpy(a).to(_TORCH[dtype]) for a in (q, k, v)),
        causal=causal, window=window, groups=G)
    assert out.dtype == _TORCH[dtype] and tuple(out.shape) == (BH, S, D)
    atol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), atol=atol)


@pytest.mark.parametrize("H,K,window", [(8, 4, 0), (8, 2, 48), (4, 4, 0)])
def test_model_layout_adapter_matches_reference(H, K, window):
    """(B,S,H,D) adapter, GQA head order (K, G): q head k*G+g reads kv
    head k, against the reference's ops.flash_attention."""
    B, S, D = 2, 96, 32
    rng = np.random.default_rng(1)
    q = rng.normal(size=(B, S, H, D)).astype(np.float32)
    k = rng.normal(size=(B, S, K, D)).astype(np.float32)
    v = rng.normal(size=(B, S, K, D)).astype(np.float32)
    ref = ref_ops.flash_attention(*map(jnp.asarray, (q, k, v)),
                                  window=window, causal=True)
    out = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              window=window, causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)


def test_fully_masked_rows_are_zero_and_head_dims_may_differ():
    """Non-causal window with T < S leaves late rows no key: they are 0
    (the kernel's l == 0 guard); Dv != D is allowed."""
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.normal(size=(1, 2, 40, 16)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(1, 1, 8, 16)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(1, 1, 8, 24)).astype(np.float32))
    out = fa.flash_attention_bhsd(q, k, v, causal=False, window=4)
    assert tuple(out.shape) == (1, 2, 40, 24)
    assert torch.all(out[:, :, 11:] == 0)           # rows 11.. see no key
    assert torch.all(out[:, :, :11].abs().sum(-1) > 0)


def test_rejects_bad_inputs():
    q = torch.zeros(1, 3, 8, 16)
    with pytest.raises(ValueError):
        fa.flash_attention_bhsd(q, torch.zeros(1, 2, 8, 16),
                                torch.zeros(1, 2, 8, 16))   # 3 % 2 heads
    with pytest.raises(ValueError):
        fa.flash_attention_bhsd(q, torch.zeros(1, 1, 8, 16,
                                               dtype=torch.float64),
                                torch.zeros(1, 1, 8, 16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_mla_head_dims(dtype):
    """MLA's prefill: q/k head dim nope 128 + rope 64, v's 128; the
    scale is 1/sqrt(192), from q's head dim, on both sides."""
    rng = np.random.default_rng(4)
    q, k = (rng.normal(size=(4, 64, 192)).astype(np.float32)
            for _ in range(2))
    v = rng.normal(size=(4, 64, 128)).astype(np.float32)
    ref = ref_flash(*(jnp.asarray(a).astype(dtype) for a in (q, k, v)),
                    causal=True, interpret=True)
    out = fa.flash_attention_fwd(
        *(torch.from_numpy(a).to(_TORCH[dtype]) for a in (q, k, v)),
        causal=True)
    assert tuple(out.shape) == (4, 64, 128)
    atol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), atol=atol)


# (D, Dv) -> the path of bf16 with aligned tensors, and with tensors TMA
# cannot take; float32 always takes the fp32-core kernel
PATH_CASES = {
    (64, 64): ("wgmma", "fp32"),       # zamba2, internlm2
    (120, 120): ("wgmma", "fp32"),     # h2o-danube: TMA pads to 128
    (128, 128): ("wgmma", "fp32"),
    (192, 128): ("wgmma", "fp32"),     # MLA prefill
    (200, 160): ("wgmma", "fp32"),
    (256, 256): ("wgmma", "fp32"),
    (36, 36): ("fp32", "fp32"),        # not a multiple of 8
    (200, 164): ("fp32", "fp32"),
}


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D,Dv", list(PATH_CASES))
def test_path_choice(D, Dv, dtype, aligned):
    want = ("fp32" if dtype == "float32"
            else PATH_CASES[D, Dv][0 if aligned else 1])
    assert fa._path(_TORCH[dtype], D, Dv, aligned) == want


@pytest.mark.parametrize("layout,aligned", [
    ("bhsd", True), ("bshd", True), ("qkv", True), ("shift", False),
    ("d36", False)])
def test_alignment_of_model_layouts(layout, aligned):
    """The model's (B, S, H, D) views and fused-projection slices suit
    TMA; a base pointer off a 16-byte boundary or a row stride that is
    not a multiple of 8 elements does not."""
    B, S, H, D = 2, 16, 4, 64
    x = torch.zeros(B, S, 3 * H, D, dtype=torch.bfloat16)
    if layout == "bhsd":
        ts = [torch.zeros(B, H, S, D, dtype=torch.bfloat16)] * 3
    elif layout == "bshd":
        ts = [torch.zeros(B, S, H, D, dtype=torch.bfloat16).transpose(1, 2)
              ] * 3
    elif layout == "qkv":
        ts = [x[:, :, i * H:(i + 1) * H].transpose(1, 2) for i in range(3)]
    elif layout == "shift":
        ts = [x.view(-1)[1:1 + B * H * S * D].view(B, H, S, D)] * 3
    else:
        ts = [torch.zeros(B, H, S, 36, dtype=torch.bfloat16)] * 3
    strides = [st for t in ts for st in fa._strides(t)]
    assert fa._aligned(ts, strides) == aligned


def test_strides_of_unit_dims_are_contiguous():
    """A dim of size 1 is never stepped: its stride is replaced by the
    contiguous one (TMA checks every stride), the others kept."""
    t = torch.zeros(1, 6, 1, 3, 8).select(2, 0).transpose(1, 2)  # (1,3,6,8)
    assert fa._strides(t) == [144, 8, 24]
    t = torch.zeros(5, 7, 16)[:, None]                             # (5,1,7,16)
    assert fa._strides(t) == [112, 112, 16]
