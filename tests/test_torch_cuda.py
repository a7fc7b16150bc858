"""The port's LM kernels and its int8 list kernels against their plain
versions, on the card.

Imports torch and the port only (the card's machine has no JAX, and
this file needs no conftest), so it runs there as

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda \\
        tests/test_torch_cuda.py

and skips everywhere else: a CUDA kernel has no CPU mode. Tolerances
are the reference's kernel tolerances (tests/test_kernels.py): flash
atol 2e-5 in f32 and 2e-2 in bf16; ssd (atol 2e-4, rtol 1e-5) in f32
and (0.1, 3e-2) in bf16; moe_gmm atol 1e-5 with an f32 output and 2e-2
with a bf16 one; the int8 quantize / dequantize pair bit-equal (q, scale,
zp and the dequantized values); int8_roundtrip within 1e-6."""
import math

import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels.comm_fused import kernel as cf
from repro_torch.kernels.flash_attention import kernel as fa
from repro_torch.kernels.int8_quant import kernel as iq
from repro_torch.kernels.int8_quant import ops as iq_ops
from repro_torch.kernels.moe_gmm import kernel as gmm
from repro_torch.kernels.ssd_scan import kernel as ssd

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
FA_TOL = {"float32": (2e-5, 0.0), "bfloat16": (2e-2, 0.0)}
SSD_TOL = {"float32": (2e-4, 1e-5), "bfloat16": (0.1, 3e-2)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


FA_CASES = [  # (B, H, K, S, T, D, Dv, causal, window)
    (1, 128, 128, 2048, 2048, 64, 64, True, 0),     # the serving shape
    (2, 8, 2, 300, 300, 64, 64, True, 128),         # GQA + window
    (1, 4, 4, 200, 200, 120, 120, True, 0),         # h2o-danube head dim
    (2, 6, 2, 130, 130, 64, 64, False, 0),          # non-causal, ragged S
    (1, 2, 1, 100, 60, 80, 48, True, 0),            # S != T, D != Dv
    (1, 2, 2, 40, 8, 16, 24, False, 4),             # fully-masked rows
    (1, 2, 2, 70, 70, 36, 36, True, 0),             # D % 8 != 0: the
                                                    # fp32-core path
    (1, 2, 1, 100, 100, 200, 160, True, 0),         # D, Dv > 128
    (1, 16, 16, 1024, 1024, 192, 128, True, 0),     # MLA prefill: q/k
                                                    # nope 128 + rope 64
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,K,S,T,D,Dv,causal,window", FA_CASES)
def test_flash_kernel_matches_plain(card, B, H, K, S, T, D, Dv, causal,
                                    window, dtype):
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(*shape, generator=g).to(_DTYPES[dtype]).to(card)
    q, k, v = r(B, H, S, D), r(B, K, T, D), r(B, K, T, Dv)
    # fresh contiguous tensors: bf16 with head dims that are multiples of
    # 8 takes the wgmma path, D 36 the fp32-core one
    want = ("fp32" if dtype == "float32" or D % 8 or Dv % 8 else "wgmma")
    _flash_matches_plain(q, k, v, causal, window, dtype, want)


def _flash_matches_plain(q, k, v, causal, window, dtype, path):
    """One launch, on ``path`` (by the per-path count), within the
    dtype's tolerance of the plain version; -> (out, plain)."""
    n = dict(fa.LAUNCHES)
    out = fa.flash_attention_bhsd(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == n["flash_attention"] + 1
    assert {p: fa.LAUNCHES[f"flash_attention_{p}"]
            - n[f"flash_attention_{p}"] for p in fa.PATHS} == {
        p: int(p == path) for p in fa.PATHS}
    plain = fa.attention_plain(q, k, v, causal=causal, window=window)
    atol, rtol = FA_TOL[dtype]
    torch.testing.assert_close(out.float(), plain.float(), atol=atol,
                               rtol=rtol)
    return out, plain


# (layout, B, H, K, S, T, D, Dv, causal, window, bf16 path). layout
# "bhsd": contiguous (B, H, S, D); "bshd": (B, S, H, D) tensors passed
# as transposed views, as the model does; "qkv": q, k, v slices of one
# fused (B, S, H + 2K, D) projection; "shift": every tensor one element
# past a 16-byte boundary (TMA refuses it)
FA_PATH_CASES = [
    ("bhsd", 4, 16, 16, 2048, 2048, 192, 128, True, 0, "wgmma"),  # MLA
    ("bhsd", 1, 4, 4, 512, 512, 256, 256, True, 0, "wgmma"),
    ("bhsd", 1, 4, 2, 300, 300, 120, 120, True, 0, "wgmma"),  # zero fill
    ("bhsd", 2, 4, 2, 333, 457, 64, 64, True, 0, "wgmma"),    # S != T
    ("bhsd", 2, 4, 2, 333, 200, 128, 64, False, 0, "wgmma"),
    ("bhsd", 2, 8, 8, 1000, 1000, 128, 128, True, 200, "wgmma"),  # window
    ("bhsd", 1, 4, 4, 700, 700, 64, 64, False, 100, "wgmma"),
    ("bhsd", 2, 16, 4, 512, 512, 64, 64, True, 0, "wgmma"),   # GQA G = 4
    ("bhsd", 1, 2, 2, 300, 40, 64, 64, False, 8, "wgmma"),    # rows 47..
                                                              # see no key
    ("bshd", 2, 16, 16, 2048, 2048, 192, 128, True, 0, "wgmma"),
    ("qkv", 2, 32, 8, 1024, 1024, 64, 64, True, 0, "wgmma"),
    ("shift", 1, 4, 2, 300, 300, 64, 64, True, 0, "fp32"),
    ("bhsd", 1, 2, 1, 100, 100, 200, 164, True, 0, "fp32"),   # Dv % 8
]


def _layout(layout, B, H, K, S, T, D, Dv, r):
    if layout == "bhsd":
        return r(B, H, S, D), r(B, K, T, D), r(B, K, T, Dv)
    if layout == "bshd":
        return (r(B, S, H, D).transpose(1, 2), r(B, T, K, D).transpose(1, 2),
                r(B, T, K, Dv).transpose(1, 2))
    if layout == "qkv":
        qkv = r(B, S, H + 2 * K, D).transpose(1, 2)
        return qkv[:, :H], qkv[:, H:H + K], qkv[:, H + K:]
    def shifted(*shape):
        n = math.prod(shape)
        return r(n + 1)[1:].view(*shape)
    return shifted(B, H, S, D), shifted(B, K, T, D), shifted(B, K, T, Dv)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout,B,H,K,S,T,D,Dv,causal,window,path",
                         FA_PATH_CASES)
def test_flash_paths_match_plain(card, layout, B, H, K, S, T, D, Dv, causal,
                                 window, path, dtype):
    g = torch.Generator().manual_seed(1)

    def r(*shape):
        return torch.randn(*shape, generator=g).to(_DTYPES[dtype]).to(card)
    q, k, v = _layout(layout, B, H, K, S, T, D, Dv, r)
    out, plain = _flash_matches_plain(q, k, v, causal, window, dtype,
                                      "fp32" if dtype == "float32" else path)
    empty = ~fa._mask(S, T, causal, window, card).any(dim=-1)
    assert torch.all(out[:, :, empty] == 0)


SSD_CASES = [  # (b, s, h, p, n, chunk, bf16 path)
    (4, 2048, 64, 64, 64, 128, "wgmma"),   # the serving shape (zamba2-1.2b)
    (1, 512, 4, 64, 128, 128, "wgmma"),    # mamba2's state size
    (2, 256, 3, 32, 16, 32, "wgmma"),
    (1, 256, 2, 128, 128, 64, "wgmma"),    # two p tiles
    (1, 192, 2, 24, 20, 64, "mma"),        # n, p % 8 != 0: no TMA
]


def _ssd_inputs(b, s, h, p, n, dtype, card, with_init=True, shift=False):
    """The reference kernel test's distributions (normal x, B, C;
    softplus dt; A = -exp(normal); initial state normal * 0.1). shift:
    x, B and C one element past a 16-byte boundary."""
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(*shape, generator=g)
    low = _DTYPES[dtype]
    x, B, C = (r(b, s, h, p).to(low), r(b, s, n).to(low),
               r(b, s, n).to(low))
    dt, A = F.softplus(r(b, s, h)), -torch.exp(r(h))
    init = (r(b, h, p, n) * 0.1).to(low)
    x, dt, A, B, C, init = (t.to(card) for t in (x, dt, A, B, C, init))
    if shift:
        x, B, C = (torch.cat([t.new_zeros(1), t.reshape(-1)])[1:].view(
            t.shape) for t in (x, B, C))
    return x, dt, A, B, C, init if with_init else None


def _ssd_matches_plain(x, dt, A, B, C, init, chunk, path):
    """One wrapper call: one launch, on ``path``, within SSD_TOL of the
    plain version."""
    before = dict(ssd.LAUNCHES)
    y, f = ssd.ssd_scan(x, dt, A, B, C, chunk=chunk, initial_state=init)
    torch.cuda.synchronize()
    assert ssd.LAUNCHES["ssd_scan"] == before["ssd_scan"] + 1
    assert ssd.LAUNCHES[f"ssd_scan_{path}"] == before[f"ssd_scan_{path}"] + 1
    y_p, f_p = ssd.ssd_scan_plain(x, dt, A, B, C, chunk=chunk,
                                  initial_state=init)
    atol, rtol = SSD_TOL[str(x.dtype).split(".")[-1]]
    torch.testing.assert_close(y.float(), y_p.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(f.float(), f_p.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,p,n,chunk,path", SSD_CASES)
def test_ssd_kernel_matches_plain(card, b, s, h, p, n, chunk, path, dtype):
    """Each case with an initial state, on its path (f32: the fp32
    cores)."""
    x, dt, A, B, C, init = _ssd_inputs(b, s, h, p, n, dtype, card)
    _ssd_matches_plain(x, dt, A, B, C, init, chunk,
                       "f32" if dtype == "float32" else path)


# bf16 cases of the wgmma path's look-back and edges, and the mma path
# (b, s, h, p, n, chunk, initial state, shift, path)
SSD_PATH_CASES = [
    # 128 chunks on 16 chains: 2048 items, many more than the card
    # holds at once, so blocks wait on the chunk before theirs
    (2, 8192, 8, 64, 64, 64, True, False, "wgmma"),
    (2, 8192, 8, 64, 64, 64, False, False, "wgmma"),
    (4, 2048, 64, 64, 64, 128, False, False, "wgmma"),  # serving, no init
    (1, 4096, 4, 64, 128, 64, True, False, "wgmma"),    # n 128, 64 chunks
    (2, 2048, 2, 128, 64, 32, True, False, "wgmma"),    # two p tiles
    (1, 480, 2, 64, 64, 40, True, False, "wgmma"),      # chunk 40
    (2, 256, 3, 8, 8, 128, False, False, "wgmma"),      # p, n 8
    (1, 128, 1, 64, 64, 128, True, False, "wgmma"),     # one chunk
    (2, 1024, 4, 64, 64, 128, True, True, "mma"),       # off 16 bytes
    (1, 256, 2, 64, 68, 64, False, False, "mma"),       # n % 8 != 0
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,p,n,chunk,with_init,shift,path",
                         SSD_PATH_CASES)
def test_ssd_paths_match_plain(card, b, s, h, p, n, chunk, with_init, shift,
                               path):
    x, dt, A, B, C, init = _ssd_inputs(b, s, h, p, n, "bfloat16", card,
                                       with_init, shift)
    _ssd_matches_plain(x, dt, A, B, C, init, chunk, path)


GMM_CASES = [  # (E, C, d, F, act, x dtype, weight dtype, scale, path)
    (4, 64, 128, 256, "silu", "float32", "float32", "ref", "f32"),
    (2, 128, 64, 512, "gelu", "float32", "float32", "ref", "f32"),
    (8, 32, 256, 128, "silu", "float32", "float32", "ref", "f32"),
    (2, 64, 128, 256, "silu", "bfloat16", "bfloat16", "ref", "stream"),
    (3, 40, 96, 192, "gelu", "float32", "float32", "ref", "f32"),  # non-128
    (3, 40, 96, 192, "gelu", "bfloat16", "float32", "ref", "stream"),  # mixed
    (2, 9, 33, 20, "silu", "float32", "float32", "ref", "f32"),    # odd d
    (2, 9, 33, 20, "silu", "bfloat16", "bfloat16", "ref", "mma"),
    (4, 24, 64, 48, "silu", "float32", "bfloat16", "ref", "f32"),  # bf16
                                                    # params, f32 compute
    (3, 40, 96, 192, "gelu", "bfloat16", "bfloat16", "ref", "stream"),
    (2, 130, 72, 40, "silu", "bfloat16", "bfloat16", "ref", "wgmma"),  # ragged
                                                    # tiles, partial slab
    (2, 24, 33, 20, "silu", "bfloat16", "bfloat16", "ref", "mma"),  # d % 8
    (2, 24, 33, 20, "silu", "bfloat16", "float32", "ref", "mma"),
    (2, 24, 64, 36, "gelu", "bfloat16", "float32", "ref", "mma"),  # F % 8
    (64, 8, 2048, 1408, "silu", "bfloat16", "bfloat16", "model", "stream"),
    (64, 8, 2048, 1408, "silu", "bfloat16", "float32", "model", "stream"),
    (8, 200, 2048, 1408, "silu", "bfloat16", "bfloat16", "model", "wgmma"),
    (8, 200, 2048, 1408, "silu", "bfloat16", "float32", "model", "wgmma"),
]


def gmm_inputs(E, C, d, F, xdt, wdt, scale, gen):
    """"ref": the reference kernel test's scales (x * 0.5, w * 0.05).
    "model": unit-normal x (the RMS-normed hidden) and each weight
    scaled by 1/sqrt of its contracted dim, so g, u and y are O(1):
    |y| <= ~4 at d 2048, where a one-ulp difference of two bf16
    roundings (2^-6 at [2, 4)) is inside the 2e-2 tolerance."""
    sx, sg, sd = ((0.5, 0.05, 0.05) if scale == "ref"
                  else (1.0, d ** -0.5, F ** -0.5))
    x = torch.randn(E, C, d, generator=gen) * sx
    wg = torch.randn(E, d, F, generator=gen) * sg
    wu = torch.randn(E, d, F, generator=gen) * sg
    wd = torch.randn(E, F, d, generator=gen) * sd
    return (x.to(_DTYPES[xdt]),) + tuple(w.to(_DTYPES[wdt])
                                         for w in (wg, wu, wd))


def _gmm_matches_plain(x, wg, wu, wd, act, path):
    """One launch, on ``path`` (by the per-path count), within the
    output dtype's tolerance of the plain version."""
    n = dict(gmm.LAUNCHES)
    y = gmm.moe_gmm(x, wg, wu, wd, act=act)
    torch.cuda.synchronize()
    assert gmm.LAUNCHES["moe_gmm"] == n["moe_gmm"] + 1
    assert {p: gmm.LAUNCHES[f"moe_gmm_{p}"] - n[f"moe_gmm_{p}"]
            for p in gmm.PATHS} == {p: int(p == path) for p in gmm.PATHS}
    assert y.dtype == x.dtype and y.shape == x.shape
    plain = gmm.moe_gmm_plain(x, wg, wu, wd, act=act)
    atol = 1e-5 if x.dtype == torch.float32 else 2e-2
    torch.testing.assert_close(y.float(), plain.float(), atol=atol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("E,C,d,F,act,xdt,wdt,scale,path", GMM_CASES)
def test_moe_gmm_kernel_matches_plain(card, E, C, d, F, act, xdt, wdt,
                                      scale, path):
    g = torch.Generator().manual_seed(0)
    x, wg, wu, wd = (t.to(card) for t in gmm_inputs(E, C, d, F, xdt, wdt,
                                                      scale, g))
    _gmm_matches_plain(x, wg, wu, wd, act, path)


# bf16 x, with bf16 and with f32 weights, at the edges of the stream and
# wgmma paths: (E, C, d, F, act, shift, path); C is an offset from the
# threshold when given as a string. shift: x one element past a 16-byte
# boundary. F 200 and 136 leave h's last group of 32 partly pad (f32
# weights); C 100 leaves the second consumer's rows all past C.
_T = "threshold"
GMM_PATH_CASES = [
    (4, _T, 512, 1408, "silu", False, "stream"),
    (4, _T + "+1", 512, 1408, "silu", False, "wgmma"),
    (2, 130, 256, 200, "gelu", False, "wgmma"),       # ragged rows and F
    (2, 960, 2048, 1408, "silu", False, "wgmma"),     # the prefill's C
    (2, 100, 72, 1408, "silu", False, "wgmma"),       # a partial k slab
    (1, 8, 2048, 1408, "gelu", False, "stream"),      # E 1
    (1, 300, 128, 96, "gelu", False, "wgmma"),
    (2, 5, 64, 64, "silu", False, "stream"),          # C < 8
    (3, 17, 192, 136, "silu", False, "stream"),       # F % 64 != 0
    (2, 16, 256, 128, "silu", True, "mma"),           # misaligned view
    (2, 200, 256, 128, "silu", True, "mma"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("wdt", ["bfloat16", "float32"])
@pytest.mark.parametrize("E,C,d,F,act,shift,path", GMM_PATH_CASES)
def test_moe_gmm_paths_match_plain(card, E, C, d, F, act, shift, path,
                                   wdt):
    if isinstance(C, str):
        C = gmm.STREAM_MAX_C + (1 if C.endswith("+1") else 0)
    g = torch.Generator().manual_seed(2)
    x, wg, wu, wd = (t.to(card) for t in gmm_inputs(
        E, C, d, F, "bfloat16", wdt, "model", g))
    if shift:
        x = torch.cat([x.new_zeros(1), x.reshape(-1)])[1:].view(E, C, d)
        assert x.data_ptr() % 16 != 0 and x.is_contiguous()
    _gmm_matches_plain(x, wg, wu, wd, act, path)


# the int8 list kernels: the cases of tests/test_torch_kernels.py
# (MANY_CASES: a vgg16 model leg, the two feature shapes, one value, g
# not a multiple of 4, a list past the segment cap, an empty list) and
# tensors that are views off 16 bytes (x) and off 4 bytes (q)
INT8_CASES = {
    "vgg16_leg": [(64,), (64,), (3, 3, 3, 64), (64,), (64,),
                  (3, 3, 64, 64), (128,), (128,), (3, 3, 64, 128)],
    "features_2048_rows": [(32, 64, 16, 16)],
    "features_4096_rows": [(32, 128, 16, 16)],
    "one_value": [(1,)],
    "g_not_multiple_of_4": [(7,), (3, 85), (2, 129)],
    "over_segment_cap": [((37 * i) % 600 + 1,)
                         for i in range(iq.MAX_SEGMENTS + 6)],
    "empty": [],
    "odd_offset_views": [(3, 3, 64, 64), (300,), (1728,)],
}


def _at_odd_offset(t):
    """A contiguous copy of t whose base sits one element past an
    aligned one."""
    flat = torch.cat([t.new_zeros(1), t.reshape(-1)])[1:]
    return flat.view(t.shape)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(INT8_CASES))
def test_int8_segments_match_plain(card, name):
    g = torch.Generator().manual_seed(len(name))
    xs = [(torch.randn(s, generator=g) * (0.05 + 3 * i / 7)).to(card)
          for i, s in enumerate(INT8_CASES[name])]
    odd = name == "odd_offset_views"
    if odd:
        xs = [_at_odd_offset(x) for x in xs]
        assert all(x.data_ptr() % 16 for x in xs)
    flats = [x.reshape(-1) for x in xs]
    groups = [iq_ops.group_size(f.numel()) for f in flats]
    launches = -(-len(flats) // iq.MAX_SEGMENTS)
    before = dict(iq.LAUNCHES)
    got = iq.int8_quantize_segments(flats, groups)
    want = iq.int8_quantize_segments_plain(flats, groups)
    torch.cuda.synchronize()
    assert iq.LAUNCHES["int8_quantize"] - before["int8_quantize"] \
        == launches
    assert len(got) == len(want) == len(xs)
    for (q, s, z), (qp, sp, zp) in zip(got, want):
        assert q.shape == qp.shape and s.shape == sp.shape
        assert torch.equal(q, qp) and torch.equal(s, sp) \
            and torch.equal(z, zp)
    qs, ss, zs = ([p[i] for p in got] for i in range(3))
    if odd:                    # q off 4 bytes: the per-value path
        qs = [_at_odd_offset(q) for q in qs]
        assert all(q.data_ptr() % 4 for q in qs)
    numels = [f.numel() for f in flats]
    out = iq.int8_dequantize_segments(qs, ss, zs, numels)
    ref = iq.int8_dequantize_segments_plain(qs, ss, zs, numels)
    torch.cuda.synchronize()
    assert iq.LAUNCHES["int8_dequantize"] - before["int8_dequantize"] \
        == launches
    for o, r, n in zip(out, ref, numels):
        assert o.shape == (n,) and torch.equal(o, r)


# the int8 kernels at the LM training path's shapes: internlm2-1.8b's
# bf16 features at batch 32, seq 64 (16384 rows of 256) and a cohort of
# 4 clients' features (65536 rows) on the fused path
LM_FEATURES = (32, 64, 2048)


def _bf16_valued(shape, seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * 3.0).to(torch.bfloat16)


@pytest.mark.cuda
def test_int8_lm_features_bf16_match_plain(card):
    """A bf16 feature tensor through the list API (f32 cast, one launch a
    direction, bf16 back) against the plain per-tensor loop with the
    same casts: q, scale, zp and the bf16 x' bit-equal."""
    x = _bf16_valued(LM_FEATURES, 19).to(card)
    before = dict(iq.LAUNCHES)
    [(q, s, z, shape)] = iq_ops.int8_quantize_many([x])
    [y] = iq_ops.int8_dequantize_many([(q, s, z, shape)],
                                      dtype=torch.bfloat16)
    flat = x.to(torch.float32).reshape(-1)
    [(qp, sp, zp)] = iq.int8_quantize_segments_plain([flat], [iq_ops.GROUP])
    [yp] = iq.int8_dequantize_segments_plain([qp], [sp], [zp], [flat.numel()])
    torch.cuda.synchronize()
    assert {k: iq.LAUNCHES[k] - before[k] for k in before} \
        == {"int8_quantize": 1, "int8_dequantize": 1}
    assert tuple(q.shape) == (16384, 256) and shape == LM_FEATURES
    assert torch.equal(q, qp) and torch.equal(s, sp) and torch.equal(z, zp)
    assert y.dtype == torch.bfloat16
    assert torch.equal(y, yp.reshape(LM_FEATURES).to(torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [8192, 65536])
def test_int8_roundtrip_cohort_matches_plain(card, rows):
    """int8_roundtrip at vgg16's cohort (8192 rows) and internlm2-1.8b's
    (65536 rows of bf16 features as f32) against its plain version,
    within 1e-6."""
    x = _bf16_valued((rows, 256), rows).to(card, torch.float32)
    before = cf.LAUNCHES["int8_roundtrip"]
    out = cf.int8_roundtrip(x)
    ref = cf.int8_roundtrip_plain(x)
    torch.cuda.synchronize()
    assert cf.LAUNCHES["int8_roundtrip"] == before + 1
    assert float((out - ref).abs().max()) <= 1e-6
