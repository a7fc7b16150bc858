"""The port's SSD scan against the reference.

The kernel wrapper's plain version (per-chunk arithmetic, f32 carried
state) against ``ssd_scan_pallas`` in interpret mode, with an initial
state; the model's oracle ``ssd_scan_ref`` (state carried in x's dtype)
and ``ssd_decode_step`` against the reference's. Inputs come from a
numpy seed. Tolerances are the reference's own (tests/test_kernels.py):
(atol 2e-4, rtol 1e-5) in f32, (0.1, 3e-2) in bf16. The CUDA kernel is
held against the plain version on the card by tests/test_torch_cuda.py
(and by ``chip_smoke.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.kernel import ssd_scan_pallas
from repro.models import ssm as ref_ssm
from repro_torch.kernels.ssd_scan import kernel as ssd
from repro_torch.models import ssm

# (b, s, h, p, n, chunk, dtype): tests/test_kernels.py SSD_CASES
SSD_CASES = [
    (2, 128, 4, 16, 8, 32, "float32"),
    (1, 256, 2, 64, 32, 64, "float32"),
    (2, 256, 3, 32, 16, 128, "float32"),
    (1, 128, 2, 32, 16, 32, "bfloat16"),
]
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(b, s, h, p, n, seed=0):
    """x, dt (softplus, f32), A (< 0, f32), B, C, initial state."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.normal(size=(b, s, h, p)).astype(f),
            np.log1p(np.exp(rng.normal(size=(b, s, h)))).astype(f),
            (-np.exp(rng.normal(size=(h,)))).astype(f),
            rng.normal(size=(b, s, n)).astype(f),
            rng.normal(size=(b, s, n)).astype(f),
            (rng.normal(size=(b, h, p, n)) * 0.1).astype(f))


def _tol(dtype):
    return (0.1, 3e-2) if dtype == "bfloat16" else (2e-4, 1e-5)


@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    before = dict(ssd.LAUNCHES)
    yield
    assert ssd.LAUNCHES == before


@pytest.mark.parametrize("b,s,h,p,n,chunk,dtype", SSD_CASES)
def test_plain_matches_pallas(b, s, h, p, n, chunk, dtype):
    x, dt, A, B, C, init = _inputs(b, s, h, p, n)
    low = (0, 3, 4, 5)               # x, B, C, init in the activation dtype
    jx = [jnp.asarray(a).astype(dtype) if i in low else jnp.asarray(a)
          for i, a in enumerate((x, dt, A, B, C, init))]
    ty = [torch.from_numpy(a).to(_TORCH[dtype]) if i in low
          else torch.from_numpy(a)
          for i, a in enumerate((x, dt, A, B, C, init))]
    y_r, f_r = ssd_scan_pallas(*jx[:5], chunk=chunk, initial_state=jx[5],
                               interpret=True)
    y, f = ssd.ssd_scan(*ty[:5], chunk=chunk, initial_state=ty[5])
    assert y.dtype == f.dtype == _TORCH[dtype]
    atol, rtol = _tol(dtype)
    np.testing.assert_allclose(y.float().numpy(), np.asarray(y_r, np.float32),
                               atol=atol, rtol=rtol)
    np.testing.assert_allclose(f.float().numpy(), np.asarray(f_r, np.float32),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("with_init", [False, True])
def test_model_oracle_matches_reference(with_init):
    x, dt, A, B, C, init = _inputs(2, 96, 4, 16, 8, seed=1)
    args = (x, dt, A, B, C)
    init_r = jnp.asarray(init) if with_init else None
    init_t = torch.from_numpy(init) if with_init else None
    y_r, f_r = ref_ssm.ssd_scan_ref(*map(jnp.asarray, args), chunk=32,
                                    initial_state=init_r)
    y, f = ssm.ssd_scan_ref(*map(torch.from_numpy, args), chunk=32,
                            initial_state=init_t)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), atol=2e-4,
                               rtol=1e-5)
    np.testing.assert_allclose(f.numpy(), np.asarray(f_r), atol=2e-4,
                               rtol=1e-5)


def test_decode_step_matches_reference_and_the_scan():
    """Step-by-step recurrence: equal to the reference's step, and its
    end state equal to the chunked scan's."""
    b, s, h, p, n = 2, 64, 3, 8, 4
    x, dt, A, B, C, init = _inputs(b, s, h, p, n, seed=2)
    state_r, state = jnp.asarray(init), torch.from_numpy(init)
    for t in range(s):
        sl = slice(t, t + 1)
        y_r, state_r = ref_ssm.ssd_decode_step(
            jnp.asarray(x[:, sl]), jnp.asarray(dt[:, sl]), jnp.asarray(A),
            jnp.asarray(B[:, sl]), jnp.asarray(C[:, sl]), state_r)
        y, state = ssm.ssd_decode_step(
            torch.from_numpy(x[:, sl]), torch.from_numpy(dt[:, sl]),
            torch.from_numpy(A), torch.from_numpy(B[:, sl]),
            torch.from_numpy(C[:, sl]), state)
        np.testing.assert_allclose(y.numpy(), np.asarray(y_r), atol=2e-4,
                                   rtol=1e-5)
    _, f = ssd.ssd_scan(*map(torch.from_numpy, (x, dt, A, B, C)), chunk=32,
                        initial_state=torch.from_numpy(init))
    np.testing.assert_allclose(state.numpy(), f.numpy(), atol=3e-4)


def test_rejects_bad_inputs():
    x, dt, A, B, C, _ = map(torch.from_numpy, _inputs(1, 64, 2, 8, 4))
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssd.ssd_scan(x, dt, A, B, C, chunk=48)
    with pytest.raises(ValueError, match="float32"):
        ssd.ssd_scan(x, dt.double(), A, B, C, chunk=32)
    with pytest.raises(ValueError, match="share"):
        ssd.ssd_scan(x, dt, A, B.to(torch.bfloat16), C, chunk=32)
