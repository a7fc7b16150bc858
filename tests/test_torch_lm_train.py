"""S²FL training of a dense LM on the port against a live reference run
(tests/torch_engine_golden.py ``make_lm_pair``): reduced internlm2-1.8b
(2 layers, d_model 256, vocab 512, float32), seq 32, 120 samples / 6
clients / alpha 0.3, 3 clients a round, batch 8, 2 rounds, the same
initial params on both sides.

Clock, wire bytes and every round's splits are EXACTLY equal. Losses and
final params are held to tolerances set from the dtype and the path:
- float32, plain legs (s2fl, sfl, fedavg): 1e-5 / 5e-5 (measured
  4.8e-7 / 2.4e-7);
- the fused int8 cohort path: 1e-4 / 1e-4 (measured 1.7e-5 / 5.5e-6);
- int8 on every leg with error feedback: 1e-3 / 5e-3, as the CNN's
  (tests/test_torch_engine_codecs.py): a weight within rounding distance
  of a .5 boundary moves by one step of its group (measured 3.7e-4 /
  1.9e-3);
- bfloat16 activations: 2e-3 / 1e-3. oneDNN and XLA sum bf16 products
  in different orders, so a bf16 rounding of an activation can differ
  by an ulp (measured 2.8e-4 / 1.0e-4);
- bfloat16 activations with int8 on every leg and error feedback: 2e-3
  / 2e-2, one int8 step of the widest group (measured 8.5e-5 /
  1.03e-2)."""
import jax
import numpy as np
import pytest
from torch_engine_golden import compare, make_lm_pair

from repro_torch.utils.tree import tree_leaves

ARCH = "internlm2-1.8b"
F32 = dict(loss_tol=1e-5, param_tol=5e-5)


def _run(**kw):
    ref, port = make_lm_pair(ARCH, **kw)
    ref.run(rounds=2)
    port.run(rounds=2)
    return ref, port


@pytest.mark.parametrize("mode", ["s2fl", "sfl", "fedavg"])
def test_lm_modes_match_reference(mode):
    ref, port = _run(mode=mode)
    compare(ref, port, **F32)
    # an LM's evaluation has no accuracy; the loss is the same function
    test = port.data[0]
    ev_r, ev_p = ref.evaluate(test), port.evaluate(test)
    assert ev_r["acc"] is None and ev_p["acc"] is None
    assert abs(ev_r["loss"] - ev_p["loss"]) <= F32["loss_tol"]


def test_lm_int8_all_legs_with_feedback_matches_reference():
    ref, port = _run(comm={"codec": "int8", "dispatch_codec": "int8",
                           "error_feedback": True})
    compare(ref, port, loss_tol=1e-3, param_tol=5e-3)
    assert port.history[-1]["comm_dispatch"] > 0.0
    assert port.channel.residual_norm() == pytest.approx(
        ref.channel.residual_norm(), rel=1e-2)


def test_lm_fused_int8_matches_reference():
    ref, port = _run(fused_comm=True,
                     comm={"codec": "int8", "error_feedback": True})
    compare(ref, port, loss_tol=1e-4, param_tol=1e-4)


def test_lm_bf16_matches_reference():
    ref, port = _run(dtype="bfloat16")
    compare(ref, port, loss_tol=2e-3, param_tol=1e-3)


def test_lm_bf16_int8_with_feedback_matches_reference():
    """bf16 activations through int8 on every leg with error feedback:
    the features reach the codec in bf16, are quantized in f32 and come
    back as bf16 on both sides, so the wire bytes are equal. A weight
    that bf16 rounding leaves on the other side of a .5 boundary moves
    by one step of its int8 group, (max - min) / 254: the widest such
    step in these params is 1.03e-2 (measured: every difference above
    1e-3 is one step of its group), so the param tolerance is 2e-2, and
    at most 1 in 1000 weights may differ by more than 1e-3 (measured 255
    of 2.2 M)."""
    ref, port = _run(dtype="bfloat16",
                     comm={"codec": "int8", "dispatch_codec": "int8",
                           "error_feedback": True})
    compare(ref, port, loss_tol=2e-3, param_tol=2e-2)
    assert port.history[-1]["comm_up"] > 0.0
    diffs = [np.abs(np.asarray(a) - b.numpy()).reshape(-1)
             for a, b in zip(jax.tree.leaves(ref.params),
                             tree_leaves(port.params))]
    off = sum(int((d > 1e-3).sum()) for d in diffs)
    assert off <= 1e-3 * sum(d.size for d in diffs)
