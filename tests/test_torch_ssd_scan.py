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


@pytest.mark.parametrize("threads", [1, 3])
def test_plain_is_the_same_bytes_on_any_thread_count(threads):
    """The plain version runs its exps on one CPU thread (the first
    concurrent call of MKL's vector math can return a worker thread's
    chunk at ~1e-4 relative error): its result is the same bytes
    whatever the intra-op thread count, which it leaves as it was."""
    args = [torch.from_numpy(a) for a in _inputs(2, 128, 4, 16, 8)]
    want = ssd.ssd_scan_plain(*args[:5], chunk=32, initial_state=args[5])
    n = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        got = ssd.ssd_scan_plain(*args[:5], chunk=32, initial_state=args[5])
        assert torch.get_num_threads() == threads
    finally:
        torch.set_num_threads(n)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


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


# A CUDA call's kernel, from the dtype, p, n and the alignment alone:
# f32 on the fp32 cores; bf16 with p and n multiples of 8 and x, B, C on
# 16 bytes on "wgmma" (TMA's strides and base); the rest of bf16 on
# "mma".
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("p,n", [(64, 64), (64, 128), (128, 128), (32, 16),
                                 (8, 8), (24, 20), (64, 20), (20, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_path_choice(dtype, p, n, aligned):
    if dtype == "float32":
        want = "f32"
    elif aligned and p % 8 == 0 and n % 8 == 0:
        want = "wgmma"
    else:
        want = "mma"
    assert ssd._path(_TORCH[dtype], p, n, aligned) == want


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "mamba2-2.7b"])
def test_serving_shapes_take_the_wgmma_path(arch):
    """zamba2's (p 64, n 64) and mamba2's (p 64, n 128) SSM layers in
    bf16; their chunk (128) is within the kernel's."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    assert cfg.ssm_chunk <= ssd.MAX_CHUNK
    assert ssd._path(torch.bfloat16, cfg.ssm_head_dim, cfg.ssm_state,
                     True) == "wgmma"
    assert ssd._path(torch.float32, cfg.ssm_head_dim, cfg.ssm_state,
                     True) == "f32"


@pytest.mark.parametrize("view,aligned", [
    ("whole", True), ("head_slice", True), ("shift", False)])
def test_alignment_of_views(view, aligned):
    """A contiguous x and a slice of whole batches start on 16 bytes; a
    view one element past a boundary does not."""
    x = torch.zeros(3, 16, 4, 8, dtype=torch.bfloat16)
    if view == "head_slice":
        x = x[1:]
    elif view == "shift":
        x = x.reshape(-1)[1:1 + 2 * 16 * 4 * 8].view(2, 16, 4, 8)
    assert x.is_contiguous()
    assert ssd._aligned((x,)) == aligned


# (b, h, p, n) -> 64-bit words of the look-back scratch: the ticket (2)
# and one 64 x 64 (n <= 64) or 64 x 128 slot per (batch, head, 64-wide
# p tile)
@pytest.mark.parametrize("b,h,p,n,words", [
    (4, 64, 64, 64, 2 + 256 * 64 * 64),      # zamba2 serving: 8 MB
    (4, 80, 64, 128, 2 + 320 * 64 * 128),    # mamba2's n
    (1, 2, 128, 128, 2 + 4 * 64 * 128),      # two p tiles
    (2, 3, 24, 20, 2 + 6 * 64 * 64),         # padded to 64 x 64
    (2, 8, 64, 64, 2 + 16 * 64 * 64),
    (1, 1, 8, 8, 2 + 64 * 64),               # the smallest wgmma shape
])
def test_lookback_scratch(b, h, p, n, words):
    assert ssd.lookback_scratch(b, h, p, n) == words
    if (b, h, p, n) == (4, 64, 64, 64):
        assert words * 8 == 8 * 2 ** 20 + 16


def test_wrapper_keeps_the_plain_version_on_cpu():
    """A CPU bf16 call at a wgmma-path shape runs the plain version and
    counts no launch, by path or in total."""
    x, dt, A, B, C, init = _inputs(1, 256, 2, 64, 64, seed=3)
    bf = torch.bfloat16
    low = [torch.from_numpy(a).to(bf) for a in (x, B, C, init)]
    y, f = ssd.ssd_scan(low[0], torch.from_numpy(dt), torch.from_numpy(A),
                        low[1], low[2], chunk=128, initial_state=low[3])
    y_p, f_p = ssd.ssd_scan_plain(low[0], torch.from_numpy(dt),
                                  torch.from_numpy(A), low[1], low[2],
                                  chunk=128, initial_state=low[3])
    assert torch.equal(y, y_p) and torch.equal(f, f_p)
    assert set(ssd.LAUNCHES) == {"ssd_scan", "ssd_scan_f32", "ssd_scan_mma",
                                 "ssd_scan_wgmma"}

