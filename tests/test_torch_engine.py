"""The port's S²FL engine against a live reference run on the golden
config (see tests/torch_engine_golden.py): the fp32 seed path, the int8
cut-layer codec, and the SFL baseline.

Simulated clock and wire bytes come from the same Python float
arithmetic in both packages, so they must be EXACTLY equal. Losses and
parameters differ by conv summation order (oneDNN vs XLA): measured
6e-7 / 1.5e-6 (fp32), 2e-7 / 1.1e-6 (sfl); with int8 a feature within
rounding distance of a .5 boundary can move by one quantization step,
measured 1.9e-5 / 1.0e-5."""
import pytest
from torch_engine_golden import compare, run_pair


@pytest.mark.parametrize("mode,comm,loss_tol,param_tol", [
    ("s2fl", {}, 1e-5, 1e-5),
    ("s2fl", {"codec": "int8"}, 1e-4, 1e-4),
    ("sfl", {}, 1e-5, 1e-5),
], ids=["fp32", "int8", "sfl"])
def test_engine_matches_reference(mode, comm, loss_tol, param_tol):
    ref, port = run_pair(mode=mode, comm=comm)
    compare(ref, port, loss_tol, param_tol)
    if not comm and mode == "s2fl":
        # the seed path: nothing metered on the fp32 model legs
        assert port.history[-1]["comm_dispatch"] == 0.0
