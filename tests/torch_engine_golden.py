"""Shared runner for the engine parity tests (tests/test_torch_engine*.py).

The reference's golden engine config (tests/test_error_feedback.py):
resnet8 S²FL, 240 samples / 6 clients / alpha=0.3 / seed 0, 3 rounds of
4 clients, batch 16, group 2, default plan. Both engines run live from
the same initial parameters (the reference's, carried across as numpy
arrays), on the same numpy data and the same numpy RNG streams."""
import math

import jax
import numpy as np
import torch

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

# One intra-op thread in each process that runs these engines. The
# suite runs in several worker processes on the same cores; with
# torch's default of one OpenMP thread per core in every worker, the
# threads (which spin while they wait) oversubscribe the cores and made
# the engine files 6x slower under `-n 6` (the slice-8 files: 619 s,
# against 104 s with one thread). The results hold either way.
torch.set_num_threads(1)


def _track_rounds(eng):
    """Record each driver round's chosen splits and batch fractions on
    ``eng.rounds`` (cids as plain ints), by wrapping its driver."""
    eng.rounds = []
    inner = eng.driver.run_round

    def run_round(*a, **kw):
        rec = inner(*a, **kw)
        fracs = getattr(eng.scheduler, "selected_fracs", None) or {}
        eng.rounds.append(({int(c): int(s) for c, s in rec.splits.items()},
                           {int(c): float(f) for c, f in fracs.items()}))
        return rec

    eng.driver.run_round = run_round


def make_pair(mode="s2fl", rounds=3, comm=None, driver=None,
              fault_plan=None, recorder=None, **engine_kw):
    """-> (reference engine, port engine) built on the golden config from
    the same initial params, not yet run. ``driver``: DriverConfig
    fields; ``fault_plan``: a factory called with each package's
    ``FaultPlan`` class; ``recorder``: a factory called with each
    package's ``observe`` module. Both engines record their rounds'
    splits and batch fractions on ``.rounds``."""
    import repro.core.faults as ref_faults
    import repro.observe as ref_observe
    import repro_torch.core.faults as port_faults
    import repro_torch.observe as port_observe
    comm = comm or {}
    driver = driver or {}
    ds = make_image_dataset(240, seed=0)
    fed = federate(ds, 6, alpha=0.3, seed=0)
    common = dict(mode=mode, rounds=rounds, clients_per_round=4,
                  batch_size=16, group_size=2, seed=0, **engine_kw)

    def extras(faults, observe):
        return dict(
            fault_plan=fault_plan(faults.FaultPlan) if fault_plan else None,
            recorder=recorder(observe) if recorder else None)

    ref = RefEngine(RefModel(ref_get_config("resnet8")), fed,
                    RefEngineConfig(comm=rcb.CommConfig(**comm),
                                    driver=rcb.DriverConfig(**driver),
                                    **common),
                    **extras(ref_faults, ref_observe))
    port = S2FLEngine(SplitModel(get_config("resnet8")), fed,
                      EngineConfig(comm=tcb.CommConfig(**comm),
                                   driver=tcb.DriverConfig(**driver),
                                   **common),
                      device="cpu", **extras(port_faults, port_observe))
    port.params = params_from_numpy(
        jax.tree.map(np.asarray, ref.params), device="cpu")
    _track_rounds(ref)
    _track_rounds(port)
    return ref, port


def run_pair(mode="s2fl", rounds=3, comm=None, **kw):
    """-> (reference engine, port engine), both run for ``rounds``
    (``make_pair``'s arguments)."""
    ref, port = make_pair(mode, rounds, comm, **kw)
    ref.run(rounds=rounds)
    port.run(rounds=rounds)
    return ref, port


def param_diff(ref_params, port_params):
    """Largest |reference - port| over all leaves (shapes must agree)."""
    rl = jax.tree.leaves(ref_params)
    pl = tree_leaves(port_params)
    assert [a.shape for a in rl] == [tuple(b.shape) for b in pl]
    return max(float(np.abs(np.asarray(a) - b.numpy()).max())
               for a, b in zip(rl, pl))


def compare(ref, port, loss_tol, param_tol):
    """clock and comm exactly equal, and every round's splits and batch
    fractions; per-round losses and final params within their
    tolerances. -> (loss diff, param diff) measured."""
    assert port.clock == ref.clock
    assert port.comm == ref.comm
    assert port.rounds == ref.rounds
    assert len(port.history) == len(ref.history)
    for hr, hp in zip(ref.history, port.history):
        for k in ("clock", "comm", "comm_up", "comm_down",
                  "comm_dispatch", "committed", "pending"):
            assert hp[k] == hr[k], k
    # a round that trained nothing records nan on both sides
    assert [math.isnan(h["loss"]) for h in ref.history] \
        == [math.isnan(h["loss"]) for h in port.history]
    dl = max((abs(hr["loss"] - hp["loss"])
              for hr, hp in zip(ref.history, port.history)
              if not math.isnan(hr["loss"])), default=0.0)
    dp = param_diff(ref.params, port.params)
    assert dl <= loss_tol and dp <= param_tol, (dl, dp)
    return dl, dp
