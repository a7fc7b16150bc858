"""The port's four comm kernels against the reference's Pallas kernels.

On the CPU each wrapper takes its plain PyTorch version (the CUDA kernel
runs on the card only, see ``test_cuda_kernels_match_plain_versions``);
the reference runs its Pallas kernels in interpret mode and its jnp
oracles. Inputs come from numpy seeds. int8 ``q`` must be identical and
``scale``/``zp`` bit-equal to the oracle (IEEE fp32 elementwise ops in
the same order); float outputs agree within 1e-6, the reference's own
contract (tests/test_fused_comm.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.comm_fused import ops as ref_fused_ops
from repro.kernels.comm_fused.kernel import (int8_roundtrip_pallas,
                                             sparse_combine_pallas)
from repro.kernels.int8_quant import ops as ref_int8_ops
from repro.kernels.int8_quant.kernel import (int8_dequantize_pallas,
                                             int8_quantize_pallas)
from repro.kernels.int8_quant.ref import (int8_dequantize_ref,
                                          int8_quantize_ref)
from repro_torch.kernels.comm_fused import kernel as tcf
from repro_torch.kernels.comm_fused import ops as tcf_ops
from repro_torch.kernels.int8_quant import kernel as tiq
from repro_torch.kernels.int8_quant import ops as tiq_ops

TOL = 1e-6


def _rows(r, g, seed):
    return (np.random.default_rng(seed).normal(size=(r, g)) * 3.0
            ).astype(np.float32)


def _edge_rows():
    """All-zero (post-ReLU), constant nonzero (scale floor 1e-12), half
    zeros, and values on exact .5 rounding boundaries (mn 0, mx 254 ->
    scale 1, zp -127, x/scale + zp = k + .5)."""
    x = _rows(6, 256, 99) * 2.0
    x[0] = 0.0
    x[1] = 2.5
    x[2] = np.maximum(x[2], 0.0)
    x[3, 0], x[3, 1] = 0.0, 254.0
    x[3, 2:] = np.arange(254, dtype=np.float32) + 0.5
    x[4] = np.arange(256, dtype=np.float32) * 1e-3 - 7.0
    return x


SHAPES = [(1, 256), (300, 256), (7, 1), (5, 10), (37, 16), (3, 255)]
CASES = [pytest.param(_rows(r, g, r * 1000 + g), id=f"{r}x{g}")
         for r, g in SHAPES] + [pytest.param(_edge_rows(), id="edge")]


@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    """On CPU tensors the wrappers take the plain path: no launch."""
    before = {**tiq.LAUNCHES, **tcf.LAUNCHES}
    yield
    assert {**tiq.LAUNCHES, **tcf.LAUNCHES} == before
    assert all(v == 0 for v in before.values())


@pytest.mark.parametrize("x", CASES)
def test_int8_quantize_bit_equal_to_oracle(x):
    """The reference's CPU path runs its jnp oracle op by op: the port
    is bit-equal to it."""
    q_o, s_o, z_o = int8_quantize_ref(jnp.asarray(x))
    q, s, z = tiq.int8_quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_o))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_o))
    np.testing.assert_array_equal(z.numpy(), np.asarray(z_o))


@pytest.mark.parametrize("x", CASES)
def test_int8_quantize_matches_pallas(x):
    """The jitted Pallas kernel (interpret mode) lets XLA turn the
    constant division by 254 into a multiply by its reciprocal, so its
    scale may sit 1 ulp from the true division the oracle, the port and
    the CUDA kernel compute, and zp = -127 - mn/scale then moves by up to
    2 ulp of (|zp| + 254) (measured: 8 ulp of a zp near 0); q is the
    same on these inputs."""
    q_r, s_r, z_r = int8_quantize_pallas(jnp.asarray(x), interpret=True)
    q, s, z = tiq.int8_quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_r))
    np.testing.assert_array_max_ulp(s.numpy(), np.asarray(s_r), maxulp=1)
    eps = float(np.finfo(np.float32).eps)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_r), rtol=2 * eps,
                               atol=2 * eps * 254)


@pytest.mark.parametrize("x", CASES)
def test_int8_dequantize_and_roundtrip_match_reference(x):
    q_r, s_r, z_r = int8_quantize_pallas(jnp.asarray(x), interpret=True)
    d_r = int8_dequantize_pallas(q_r, s_r, z_r, interpret=True)
    d = tiq.int8_dequantize_rows(torch.tensor(np.asarray(q_r)),
                                 torch.tensor(np.asarray(s_r)),
                                 torch.tensor(np.asarray(z_r)))
    np.testing.assert_allclose(d.numpy(), np.asarray(d_r), atol=TOL,
                               rtol=TOL)
    rt = tcf.int8_roundtrip(torch.from_numpy(x))
    rt_o = int8_dequantize_ref(*int8_quantize_ref(jnp.asarray(x)))
    np.testing.assert_allclose(rt.numpy(), np.asarray(rt_o), atol=TOL,
                               rtol=TOL)
    # against the Pallas kernel, the 1-ulp scale/zp difference above is
    # amplified by |q - zp| <= 254: allow 1e-6 of the row's magnitude
    rt_r = int8_roundtrip_pallas(jnp.asarray(x), interpret=True)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rt_r),
                               atol=TOL * max(1.0, float(np.abs(x).max())))


@pytest.mark.parametrize("d,n,k", [(1, 8, 2), (5, 33, 4), (130, 17, 5)])
@pytest.mark.parametrize("scale", [1.0, 33 / 4])
def test_sparse_combine_matches_pallas(d, n, k, scale):
    rng = np.random.default_rng(d * n + k)
    y = rng.normal(size=(d, n)).astype(np.float32)
    mask = np.zeros((d, n), np.float32)
    for i in range(d):
        mask[i, rng.choice(n, size=k, replace=False)] = 1.0
    out_r, res_r = sparse_combine_pallas(jnp.asarray(y), jnp.asarray(mask),
                                         scale, interpret=True)
    out, res = tcf.sparse_combine(torch.from_numpy(y),
                                  torch.from_numpy(mask), scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_r), atol=TOL)
    np.testing.assert_allclose(res.numpy(), np.asarray(res_r), atol=TOL)


@pytest.mark.parametrize("shape", [(1,), (10,), (255,), (256,), (257,),
                                   (4, 16, 16, 16), (2, 3, 5, 7)])
def test_public_int8_ops_match_reference(shape):
    """Any-rank tensors: grouping, tail edge-padding and the reshape back
    are the reference's."""
    x = np.random.default_rng(len(shape) + shape[-1]).normal(
        size=shape).astype(np.float32)
    q_r, s_r, z_r, shp = ref_int8_ops.int8_quantize(jnp.asarray(x))
    q, s, z, shp_t = tiq_ops.int8_quantize(torch.from_numpy(x))
    assert tuple(shp) == shp_t
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_r))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_r))
    np.testing.assert_array_equal(z.numpy(), np.asarray(z_r))
    d_r = ref_int8_ops.int8_dequantize(q_r, s_r, z_r, shp)
    d = tiq_ops.int8_dequantize(q, s, z, shp_t)
    np.testing.assert_allclose(d.numpy(), np.asarray(d_r), atol=TOL)


# Lists for the list API. vgg16's model legs send the client portion's
# leaves (at split 3: BN scale / shift of 64 and 128, conv weights of
# 1728, 36864 and 73728 values, i.e. group rows (1, 64), (7, 256),
# (144, 256), (1, 128) and (288, 256)); a feature transfer is a list of
# one, (2048, 256) or (4096, 256) rows.
VGG_LEG = [(64,), (64,), (3, 3, 3, 64), (64,), (64,), (3, 3, 64, 64),
           (128,), (128,), (3, 3, 64, 128)]
MANY_CASES = {
    "vgg16_leg": VGG_LEG,
    "features_2048_rows": [(32, 64, 16, 16)],
    "features_4096_rows": [(32, 128, 16, 16)],
    "one_value": [(1,)],
    "g_not_multiple_of_4": [(7,), (3, 85), (2, 129)],
    # past the segment cap: two launches on the card
    "over_segment_cap": [((37 * i) % 600 + 1,)
                         for i in range(tiq.MAX_SEGMENTS + 6)],
    "empty": [],
}


def _leaves(shapes, seed):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=s) * rng.uniform(0.01, 3.0)).astype(np.float32)
            for s in shapes]


@pytest.mark.parametrize("name", list(MANY_CASES))
def test_int8_many_bit_equal_to_reference_per_leaf(name):
    """The list API (one launch per list on the card; on the CPU the
    per-leaf loop of the plain versions) against the reference's public
    ops applied leaf by leaf: q, scale, zp and the dequantized tensor
    bit-equal, shapes and grouping the reference's."""
    xs = _leaves(MANY_CASES[name], len(name))
    payloads = tiq_ops.int8_quantize_many([torch.from_numpy(x) for x in xs])
    ys = tiq_ops.int8_dequantize_many(payloads)
    assert len(payloads) == len(ys) == len(xs)
    for x, (q, s, z, shp), y in zip(xs, payloads, ys):
        q_r, s_r, z_r, shp_r = ref_int8_ops.int8_quantize(jnp.asarray(x))
        assert shp == tuple(shp_r)
        np.testing.assert_array_equal(q.numpy(), np.asarray(q_r))
        np.testing.assert_array_equal(s.numpy(), np.asarray(s_r))
        np.testing.assert_array_equal(z.numpy(), np.asarray(z_r))
        y_r = ref_int8_ops.int8_dequantize(q_r, s_r, z_r, shp_r)
        assert y.dtype == torch.float32
        np.testing.assert_array_equal(y.numpy(), np.asarray(y_r))


def test_int8_many_bf16_features_bit_equal_to_reference():
    """bf16 features (an LM's cut-layer activations) through the list API
    and back to bf16 against the reference's public ops on the same bf16
    values: the reference quantizes in f32 and dequantizes to the
    payload's dtype; q, scale, zp (the wire bytes) and the bf16 tensor
    bit-equal."""
    x = torch.from_numpy(_leaves([(4, 8, 96)], 5)[0]).to(torch.bfloat16)
    xr = jnp.asarray(x.to(torch.float32).numpy()).astype(jnp.bfloat16)
    [(q, s, z, shp)] = tiq_ops.int8_quantize_many([x])
    [y] = tiq_ops.int8_dequantize_many([(q, s, z, shp)],
                                       dtype=torch.bfloat16)
    q_r, s_r, z_r, shp_r = ref_int8_ops.int8_quantize(xr)
    assert shp == tuple(shp_r) and tuple(q.shape) == (12, 256)
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_r))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_r))
    np.testing.assert_array_equal(z.numpy(), np.asarray(z_r))
    y_r = ref_int8_ops.int8_dequantize(q_r, s_r, z_r, shp_r,
                                       dtype=jnp.bfloat16)
    assert y.dtype == torch.bfloat16 and y_r.dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        y.to(torch.float32).numpy(), np.asarray(y_r.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", [torch.int8, torch.float32])
def test_list_buffers_keep_each_tensor_on_16_bytes(dtype):
    """On the card a list's outputs are cut from one buffer: each
    tensor starts on 16 bytes, so the kernels' vector loads and stores
    stay on the vector path, and no two overlap."""
    sizes = [1, 64, 1728, 7, 0, 255, 36864]
    parts = tiq._buffer(sizes, dtype, "cpu")
    assert [p.numel() for p in parts] == sizes
    assert all(p.data_ptr() % 16 == 0 for p in parts)
    spans = sorted((p.data_ptr(), p.data_ptr() + p.numel() * p.element_size())
                   for p in parts)
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))


@pytest.mark.parametrize("d,n", [(1, 1), (3, 7), (4, 300), (2, 1000)])
def test_fused_ops_match_reference(d, n):
    rng = np.random.default_rng(7 * d + n)
    x = rng.normal(size=(d, n)).astype(np.float32)
    r = (rng.normal(size=(d, n)) * 0.1).astype(np.float32)
    out_r, res_r = ref_fused_ops.fused_int8_roundtrip(jnp.asarray(x),
                                                      jnp.asarray(r))
    out, res = tcf_ops.fused_int8_roundtrip(torch.from_numpy(x),
                                            torch.from_numpy(r))
    np.testing.assert_allclose(out.numpy(), np.asarray(out_r), atol=TOL)
    np.testing.assert_allclose(res.numpy(), np.asarray(res_r), atol=TOL)
    k = max(1, int(np.ceil(0.25 * n)))
    out_r, res_r = ref_fused_ops.fused_sparse_roundtrip(
        jnp.asarray(x), jnp.asarray(r), k=k)
    out, res = tcf_ops.fused_sparse_roundtrip(
        torch.from_numpy(x), torch.from_numpy(r), k=k)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_r), atol=TOL)
    np.testing.assert_allclose(res.numpy(), np.asarray(res_r), atol=TOL)
    idx = np.stack([rng.choice(n, size=k, replace=False) for _ in range(d)])
    out_r, _ = ref_fused_ops.fused_sparse_roundtrip(
        jnp.asarray(x), None, k=k, scale=n / k, indices=idx)
    out, _ = tcf_ops.fused_sparse_roundtrip(
        torch.from_numpy(x), None, k=k, scale=n / k, indices=idx)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_r), atol=TOL)
    assert tcf_ops.int8_group_geometry(n) == \
        ref_fused_ops.int8_group_geometry(n)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    with pytest.raises(ValueError):
        tiq.int8_quantize_rows(torch.zeros(4, dtype=torch.float32))
    with pytest.raises(ValueError):
        tiq.int8_quantize_rows(torch.zeros((2, 4), dtype=torch.float64))
    with pytest.raises(ValueError):
        tiq.int8_quantize_rows(torch.zeros((2, 4), device="meta"))
    with pytest.raises(ValueError):
        tcf.sparse_combine(torch.zeros((2, 4)), torch.zeros((2, 5)), 1.0)
    with pytest.raises(ValueError):             # one group size a tensor
        tiq.int8_quantize_segments([torch.zeros(4)], [])
    with pytest.raises(ValueError):             # 1-D tensors only
        tiq.int8_quantize_segments([torch.zeros((2, 4))], [4])
    with pytest.raises(ValueError):             # all on one device
        tiq.int8_quantize_segments([torch.zeros(4),
                                    torch.zeros(4, device="meta")], [4, 4])
    q, s, z = tiq.int8_quantize_rows(torch.ones((2, 4)))
    with pytest.raises(ValueError):             # 9 values, 2 rows of 4
        tiq.int8_dequantize_segments([q], [s], [z], [9])


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    """On the card: each kernel against its plain version (run on the
    machine with the card; chip_smoke.py does the same at the main
    path's shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels run only there")
    dev = torch.device("cuda")
    for x in [_rows(r, g, r + g) for r, g in SHAPES] + [_edge_rows()]:
        xt = torch.from_numpy(x).to(dev)
        q, s, z = tiq.int8_quantize_rows(xt)
        qp, sp, zp = tiq.int8_quantize_plain(xt)
        assert torch.equal(q, qp) and torch.equal(s, sp) \
            and torch.equal(z, zp)
        d = tiq.int8_dequantize_rows(q, s, z)
        assert float((d - tiq.int8_dequantize_plain(q, s, z)).abs().max()) \
            <= TOL
        rt = tcf.int8_roundtrip(xt)
        assert float((rt - tcf.int8_roundtrip_plain(xt)).abs().max()) <= TOL
    y = torch.randn(4, 4099, device=dev)
    mask = (torch.rand(4, 4099, device=dev) < 0.1).float()
    out, res = tcf.sparse_combine(y, mask, 2.0)
    op, rp = tcf.sparse_combine_plain(y, mask, 2.0)
    assert torch.equal(out, op) and torch.equal(res, rp)
