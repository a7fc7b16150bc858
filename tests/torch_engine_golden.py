"""Shared runner for the engine parity tests (tests/test_torch_engine*.py).

The reference's golden engine config (tests/test_error_feedback.py):
resnet8 S²FL, 240 samples / 6 clients / alpha=0.3 / seed 0, 3 rounds of
4 clients, batch 16, group 2, default plan. Both engines run live from
the same initial parameters (the reference's, carried across as numpy
arrays), on the same numpy data and the same numpy RNG streams."""
import jax
import numpy as np

import repro.configs.base as rcb
import repro_torch.configs.base as tcb
from repro.configs import get_config as ref_get_config
from repro.core.engine import EngineConfig as RefEngineConfig
from repro.core.engine import S2FLEngine as RefEngine
from repro.data.partition import federate
from repro.data.synthetic import make_image_dataset
from repro.models import SplitModel as RefModel
from repro_torch.configs import get_config
from repro_torch.core.engine import EngineConfig, S2FLEngine
from repro_torch.models import SplitModel
from repro_torch.models.convert import params_from_numpy
from repro_torch.utils.tree import tree_leaves


def run_pair(mode="s2fl", rounds=3, comm=None, **engine_kw):
    """-> (reference engine, port engine), both run for ``rounds``."""
    comm = comm or {}
    ds = make_image_dataset(240, seed=0)
    fed = federate(ds, 6, alpha=0.3, seed=0)
    common = dict(mode=mode, rounds=rounds, clients_per_round=4,
                  batch_size=16, group_size=2, seed=0, **engine_kw)
    ref = RefEngine(RefModel(ref_get_config("resnet8")), fed,
                    RefEngineConfig(comm=rcb.CommConfig(**comm), **common))
    port = S2FLEngine(SplitModel(get_config("resnet8")), fed,
                      EngineConfig(comm=tcb.CommConfig(**comm), **common),
                      device="cpu")
    port.params = params_from_numpy(
        jax.tree.map(np.asarray, ref.params), device="cpu")
    ref.run(rounds=rounds)
    port.run(rounds=rounds)
    return ref, port


def compare(ref, port, loss_tol, param_tol):
    """clock and comm exactly equal; per-round losses and final params
    within their tolerances. -> (loss diff, param diff) measured."""
    assert port.clock == ref.clock
    assert port.comm == ref.comm
    for hr, hp in zip(ref.history, port.history):
        for k in ("clock", "comm", "comm_up", "comm_down",
                  "comm_dispatch", "committed", "pending"):
            assert hp[k] == hr[k], k
    dl = max(abs(hr["loss"] - hp["loss"])
             for hr, hp in zip(ref.history, port.history))
    rl = jax.tree.leaves(ref.params)
    pl = tree_leaves(port.params)
    assert [a.shape for a in rl] == [tuple(b.shape) for b in pl]
    dp = max(float(np.abs(np.asarray(a) - b.numpy()).max())
             for a, b in zip(rl, pl))
    assert dl <= loss_tol and dp <= param_tol, (dl, dp)
    return dl, dp
