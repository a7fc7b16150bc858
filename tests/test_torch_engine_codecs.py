"""The port's engine against a live reference run on the golden config
(tests/torch_engine_golden.py) with int8 on every leg and error
feedback, and the FedAvg baseline with the int8 model legs (broadcast
and QSGD-style update upload).

Clock and wire bytes are EXACTLY equal. On the int8 model legs a
weight within rounding distance of a .5 boundary moves by one
quantization step of its 256-value group (range/254); error feedback
carries the step back a round later. Measured: losses 1.5e-4, params
2.7e-3 (about one step of a conv weight group) with EF; 3.6e-7 /
4.2e-6 for FedAvg."""
import pytest
from torch_engine_golden import compare, run_pair


def test_engine_int8_all_legs_with_feedback_matches_reference():
    ref, port = run_pair(comm={"codec": "int8", "dispatch_codec": "int8",
                               "error_feedback": True})
    compare(ref, port, loss_tol=1e-3, param_tol=5e-3)
    assert port.history[-1]["comm_dispatch"] > 0.0
    assert port.channel.residual_norm() == pytest.approx(
        ref.channel.residual_norm(), rel=1e-2)


def test_engine_fedavg_int8_legs_matches_reference():
    ref, port = run_pair(mode="fedavg", rounds=2,
                         comm={"dispatch_codec": "int8"})
    compare(ref, port, loss_tol=1e-4, param_tol=1e-4)
