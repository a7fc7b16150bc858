"""The port's fused cohort path (``fused_comm``: one kernel call per
direction) against a live reference run on the golden config
(tests/torch_engine_golden.py), with int8 and top-k and error feedback.

Clock and wire bytes are EXACTLY equal; losses and params measured
5e-6 / 8.6e-6 (int8) and 1.2e-7 / 6.1e-7 (top-k)."""
import pytest
from torch_engine_golden import compare, run_pair


@pytest.mark.parametrize("codec,tol", [("int8", 1e-4), ("topk", 1e-5)])
def test_engine_fused_comm_matches_reference(codec, tol):
    ref, port = run_pair(comm={"codec": codec, "error_feedback": True},
                         fused_comm=True)
    compare(ref, port, loss_tol=tol, param_tol=tol)
    assert set(port.channel._residuals) == set(ref.channel._residuals)
