"""The port's comm layer against the reference, on the CPU: every codec
with and without error feedback, the channel's sequential and cohort
methods, and the model legs.

Contract (the reference's own, tests/test_fused_comm.py): wire bytes
and meters BIT-equal, delivered tensors and residuals within 1e-6 (of
the tensor's magnitude, see ``_close``), the rand-k draw stream
identical. Inputs are seeded numpy normals, which
have no magnitude ties, so top-k selects the same survivors in
``lax.top_k`` and ``torch.topk``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import make_channel as ref_make_channel
from repro.comm.codecs import get_codec as ref_get_codec
from repro.configs.base import CommConfig as RefCommConfig
from repro_torch.comm import make_channel
from repro_torch.comm.codecs import get_codec
from repro_torch.configs import CommConfig
from repro_torch.kernels.int8_quant import ops as tiq_ops

TOL = 1e-6
CODECS = ["fp32", "bf16", "fp16", "int8", "topk", "randk"]


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _close(port, ref, what="", mag=None):
    """Within 1e-6 of the magnitude of what was sent: the reference's
    fused path is one jitted XLA program, which turns the int8 codec's
    division by 254 into a reciprocal multiply, so its group scale can
    sit 1 ulp from the true division of the port (and of the reference's
    own sequential path); dequantized values then move by a few ulp of
    the group's largest value (measured: 1.03e-6 on delivered values and
    2.5e-6 on residuals, for traffic up to ~12 in magnitude). A residual
    inherits that error from the tensor it was cut from, so it is held
    against the traffic's magnitude, not its own."""
    ref = np.asarray(ref)
    if mag is None:
        mag = float(np.abs(ref).max()) if ref.size else 1.0
    np.testing.assert_allclose(port.detach().numpy(), ref,
                               atol=TOL * max(1.0, mag), rtol=TOL,
                               err_msg=what)


@pytest.mark.parametrize("name", CODECS)
@pytest.mark.parametrize("shape", [(1,), (7,), (300,), (2, 8, 8, 16)])
def test_codec_roundtrip_matches_reference(name, shape):
    rc = ref_get_codec(name, topk_frac=0.25)
    tc = get_codec(name, topk_frac=0.25)
    for i in range(3):                 # three calls: rand-k's stream
        x = _np(shape, 10 * i + len(shape), scale=2.0)
        ry, rb = rc.roundtrip(jnp.asarray(x))
        ty, tb = tc.roundtrip(torch.from_numpy(x))
        assert tb == rb
        assert tuple(ty.shape) == tuple(ry.shape)
        _close(ty, ry, f"{name} call {i}")
    assert tc.name == rc.name
    for n in (0, 1, 10, 255, 256, 257, 100000):
        assert tc.estimate_bytes(n) == rc.estimate_bytes(n)
        assert tc.estimate_bytes(n, 16) == rc.estimate_bytes(n, 16)
    if name == "randk":
        assert tc.state() == rc.state()
        assert np.array_equal(tc.draw_indices(1000, 7),
                              rc.draw_indices(1000, 7))


def _pair(**kw):
    return (ref_make_channel(RefCommConfig(**kw)),
            make_channel(CommConfig(**kw)))


def _assert_same_state(rch, tch, mag):
    for attr in ("up_bytes", "down_bytes", "disp_up_bytes",
                 "disp_down_bytes"):
        assert getattr(tch, attr) == getattr(rch, attr), attr
    assert set(tch._residuals) == set(rch._residuals)
    for k, r in rch._residuals.items():
        _close(tch._residuals[k], r, f"residual {k}", mag=mag)
    assert tch.residual_norm() == pytest.approx(rch.residual_norm(),
                                                rel=1e-5)
    assert tch.export_codec_state() == rch.export_codec_state()


def _traffic(n_rounds=3, cids=(0, 1, 2)):
    """Per round: (cid, features, dfx, model leaves); the cut shape
    changes in the last round (a re-split resets residuals)."""
    out = []
    for rnd in range(n_rounds):
        shape = (4, 8, 8, 16) if rnd < n_rounds - 1 else (4, 16, 16, 8)
        for c in cids:
            s = 100 * rnd + c
            out.append((rnd, c, _np(shape, s, 3.0), _np(shape, s + 50),
                        [_np((3, 3, 3, 16), s + 60), _np((16,), s + 70),
                         _np((10,), s + 80)]))
    return out


# the largest magnitude in _traffic() (residual tolerances scale by it)
_MAG = max(float(np.abs(a).max()) for t in _traffic()
           for a in (t[2], t[3], *t[4]))

CHANNEL_CASES = [
    dict(codec="int8"),
    dict(codec="int8", dispatch_codec="int8", error_feedback=True),
    dict(codec="topk", error_feedback=True, topk_frac=0.2),
    dict(codec="randk", grad_codec="randk", dispatch_codec="randk",
         error_feedback=True),
    dict(codec="randk", dispatch_codec="topk"),
    dict(codec="bf16", grad_codec="fp16", error_feedback=True),
    dict(codec="fp32", dispatch_codec="int8"),
]


@pytest.mark.parametrize("kw", CHANNEL_CASES,
                         ids=lambda kw: "-".join(f"{v}" for v in kw.values()))
def test_channel_sequential_matches_reference(kw):
    rch, tch = _pair(**kw)
    assert tch.dispatch_passthrough == rch.dispatch_passthrough
    for rnd, c, h, dfx, leaves in _traffic():
        if c == 0:
            rch.reset_round()
            tch.reset_round()
        r_out = rch.uplink_features(c, {"h": jnp.asarray(h),
                                        "aux": jnp.zeros(())})
        t_out = tch.uplink_features(c, {"h": torch.from_numpy(h),
                                        "aux": torch.zeros(())})
        _close(t_out["h"], r_out["h"], f"up {rnd} {c}")
        _close(tch.downlink_grads(c, torch.from_numpy(dfx)),
               rch.downlink_grads(c, jnp.asarray(dfx)), f"down {rnd} {c}")
        for a, b in zip(tch.dispatch_leaves(c, [torch.from_numpy(x)
                                                for x in leaves]),
                        rch.dispatch_leaves(c, [jnp.asarray(x)
                                                for x in leaves])):
            _close(a, b, f"dispatch {rnd} {c}")
        for a, b in zip(tch.collect_leaves(c, [torch.from_numpy(x)
                                               for x in leaves]),
                        rch.collect_leaves(c, [jnp.asarray(x)
                                               for x in leaves])):
            _close(a, b, f"collect {rnd} {c}")
        assert tch.round_payload_split(c) == rch.round_payload_split(c)
        assert tch.round_dispatch_split(c) == rch.round_dispatch_split(c)
    _assert_same_state(rch, tch, _MAG)


@pytest.mark.parametrize("kw", CHANNEL_CASES,
                         ids=lambda kw: "-".join(f"{v}" for v in kw.values()))
def test_channel_cohort_matches_reference(kw):
    """The fused cohort path: one call per direction and leg."""
    rch, tch = _pair(**kw)
    rounds = {}
    for rnd, c, h, dfx, leaves in _traffic():
        rounds.setdefault(rnd, []).append((c, h, dfx, leaves))
    for rnd, items in rounds.items():
        rch.reset_round()
        tch.reset_round()
        r_up = rch.uplink_features_cohort(
            [(c, {"h": jnp.asarray(h), "aux": jnp.zeros(())})
             for c, h, _, _ in items])
        t_up = tch.uplink_features_cohort(
            [(c, {"h": torch.from_numpy(h), "aux": torch.zeros(())})
             for c, h, _, _ in items])
        for a, b in zip(t_up, r_up):
            _close(a["h"], b["h"], f"up {rnd}")
        r_dn = rch.downlink_grads_cohort([(c, jnp.asarray(d))
                                          for c, _, d, _ in items])
        t_dn = tch.downlink_grads_cohort([(c, torch.from_numpy(d))
                                          for c, _, d, _ in items])
        for a, b in zip(t_dn, r_dn):
            _close(a, b, f"down {rnd}")
        for leg in ("dispatch_leaves_cohort", "collect_leaves_cohort"):
            r_l = getattr(rch, leg)([(c, [jnp.asarray(x) for x in lv])
                                     for c, _, _, lv in items])
            t_l = getattr(tch, leg)([(c, [torch.from_numpy(x) for x in lv])
                                     for c, _, _, lv in items])
            for ta, ra in zip(t_l, r_l):
                for a, b in zip(ta, ra):
                    _close(a, b, f"{leg} {rnd}")
        for c, *_ in items:
            assert tch.round_payload_split(c) == rch.round_payload_split(c)
            assert tch.round_dispatch_split(c) == \
                rch.round_dispatch_split(c)
    _assert_same_state(rch, tch, _MAG)


def test_cohort_path_equals_sequential_path_in_the_port():
    """The port's own contract between its two paths: identical bytes,
    residuals and rand-k streams; tensors within 1e-6."""
    kw = dict(codec="int8", grad_codec="topk", dispatch_codec="randk",
              error_feedback=True)
    seq, coh = make_channel(CommConfig(**kw)), make_channel(CommConfig(**kw))
    items = [(c, torch.from_numpy(_np((4, 8, 8, 16), c, 2.0)))
             for c in range(4)]
    s_out = [seq.uplink_features(c, x) for c, x in items]
    c_out = coh.uplink_features_cohort(items)
    for a, b in zip(c_out, s_out):
        assert float((a - b).abs().max()) <= TOL
    s_out = [seq.downlink_grads(c, x) for c, x in items]
    c_out = coh.downlink_grads_cohort(items)
    for a, b in zip(c_out, s_out):
        assert float((a - b).abs().max()) <= TOL
    legs = [(c, [x[0, 0], x[1, 1, 1]]) for c, x in items]
    s_legs = [seq.dispatch_leaves(c, lv) for c, lv in legs]
    for a, b in zip(coh.dispatch_leaves_cohort(legs), s_legs):
        for u, v in zip(a, b):
            assert float((u - v).abs().max()) <= TOL
    assert coh.total_bytes == seq.total_bytes
    assert set(coh._residuals) == set(seq._residuals)
    assert coh.export_codec_state() == seq.export_codec_state()


def test_residual_quarantine_matches_reference():
    rch, tch = _pair(codec="int8", error_feedback=True)
    for c in (0, 1):
        x = _np((64,), c, 3.0)
        rch.uplink_features(c, jnp.asarray(x))
        tch.uplink_features(c, torch.from_numpy(x))
    for ch in (rch, tch):
        ch.quarantine_residuals(0)
        ch.quarantine_residuals(1)
        ch.release_residuals(0, restore=True)
        ch.release_residuals(1, restore=False)
    _assert_same_state(rch, tch, _MAG)
    assert tch.ef_discarded_mass == pytest.approx(rch.ef_discarded_mass,
                                                  rel=1e-5)
    assert tch.residual_elements_of(0) == rch.residual_elements_of(0)
    assert tch.residual_norm_of(0) == pytest.approx(
        rch.residual_norm_of(0), rel=1e-5)


# vgg16's client portion at split 3 (BN scale / shift and conv weights)
VGG_LEAVES = [(64,), (64,), (3, 3, 3, 64), (64,), (64,), (3, 3, 64, 64),
              (128,), (128,), (3, 3, 64, 128)]


def test_model_legs_one_list_call_match_reference_per_leaf(monkeypatch):
    """Each int8 model leg goes through one quantize and one dequantize
    list call (one launch each on the card) and gives what the
    reference's per-leaf loop gives, over three rounds with error
    feedback: bytes exact, delivered tensors and residuals within the
    tolerance above, the same per-leaf residual keys."""
    calls = {"q": [], "d": []}
    for key, name in (("q", "int8_quantize_segments"),
                      ("d", "int8_dequantize_segments")):
        fn = getattr(tiq_ops, name)

        def counted(*a, _fn=fn, _key=key):
            calls[_key].append(len(a[0]))
            return _fn(*a)
        monkeypatch.setattr(tiq_ops, name, counted)
    rch, tch = _pair(codec="int8", dispatch_codec="int8",
                     error_feedback=True)
    sent = []
    for rnd in range(3):
        rch.reset_round()
        tch.reset_round()
        for c in (0, 1):
            leaves = [_np(s, 1000 * rnd + 20 * c + i, 0.1)
                      for i, s in enumerate(VGG_LEAVES)]
            sent += leaves
            for leg in ("dispatch_leaves", "collect_leaves"):
                n = len(calls["q"])
                t_out = getattr(tch, leg)(c, [torch.from_numpy(x)
                                              for x in leaves])
                assert calls["q"][n:] == calls["d"][n:] == [len(leaves)]
                r_out = getattr(rch, leg)(c, [jnp.asarray(x)
                                              for x in leaves])
                assert len(t_out) == len(r_out) == len(leaves)
                for a, b in zip(t_out, r_out):
                    assert tuple(a.shape) == tuple(b.shape)
                    _close(a, b, f"{leg} {rnd} {c}")
            assert tch.round_dispatch_split(c) == rch.round_dispatch_split(c)
    assert len(tch._residuals) == 2 * 2 * len(VGG_LEAVES)
    _assert_same_state(rch, tch, max(float(np.abs(a).max()) for a in sent))
