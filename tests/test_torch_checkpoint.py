"""The port's checkpoints (checkpoint/{__init__,state}.py): the
reference's ``.npz`` format, path for path, so a run-state snapshot of
either package restores into the other.

* Port against port: 1 round, snapshot, restore into a fresh engine, 2
  more rounds equals a straight 3-round run BIT-EXACTLY (params,
  history, clock, wire bytes, splits), on the fp32 sync path and under
  int8 with error feedback (the residuals restored).
* Across packages, both ways, on the golden config
  (tests/torch_engine_golden.py) with int8 features and error feedback:
  a snapshot after round 1 restored by the other package continues to
  the writer's straight run: clock, wire bytes and splits EXACTLY,
  losses and params within 1e-4 (measured, 1 and 8 CPU threads:
  9.5e-6 / 8.5e-6 at most). The model legs stay fp32 there: under an
  int8 dispatch codec the two packages' params differ by one int8 step
  of a near-boundary weight whether or not a snapshot is taken
  (ROADMAP §3).
* ``prng_key`` holds the words of the reference's ``PRNGKey(seed + 1)``.
"""
import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as ref_load
from repro.checkpoint import restore_run_state as ref_restore
from repro.checkpoint import save_run_state as ref_save
from repro_torch.checkpoint import (load_checkpoint, restore_run_state,
                                    save_checkpoint, save_run_state)
from repro_torch.core.engine import EngineConfig, S2FLEngine
from repro_torch.models import SplitModel
from repro_torch.configs import get_config
from repro_torch.utils.tree import tree_leaves
from torch_engine_golden import make_pair, param_diff

TOL = 1e-4
CODECS = {"fp32": {}, "int8_ef": {"codec": "int8", "dispatch_codec": "int8",
                                   "error_feedback": True}}


def _same_run(a, b):
    assert a.clock == b.clock and a.comm == b.comm
    assert a.history == b.history


@pytest.mark.parametrize("codec", list(CODECS))
def test_port_resume_is_bit_exact(codec, tmp_path):
    comm = CODECS[codec]
    _, straight = make_pair(comm=comm)
    straight.run(rounds=3)
    _, first = make_pair(comm=comm)
    first.run(rounds=1)
    path = str(tmp_path / "r1.npz")
    save_run_state(path, first)
    _, resumed = make_pair(comm=comm)
    restore_run_state(path, resumed)
    assert len(resumed.history) == 1
    resumed.run(rounds=2)
    _same_run(straight, resumed)
    assert resumed.rounds == straight.rounds[1:]
    for a, b in zip(tree_leaves(straight.params),
                    tree_leaves(resumed.params)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert set(resumed.channel._residuals) \
        == set(straight.channel._residuals)
    for k, r in straight.channel._residuals.items():
        assert torch.equal(r, resumed.channel._residuals[k])
    if codec == "int8_ef":
        assert straight.channel._residuals        # something restored


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_snapshot_restores_across_packages(writer, tmp_path):
    comm = {"codec": "int8", "error_feedback": True}
    path = str(tmp_path / "r1.npz")
    ref1, port1 = make_pair(comm=comm)
    if writer == "reference":
        ref1.run(rounds=1)
        ref_save(path, ref1)
    else:
        port1.run(rounds=1)
        save_run_state(path, port1)
    straight_ref, straight_port = make_pair(comm=comm)
    ref2, port2 = make_pair(comm=comm)
    if writer == "reference":
        straight, resumed = straight_ref, port2
        restore_run_state(path, port2)
    else:
        straight, resumed = straight_port, ref2
        ref_restore(path, ref2)
    straight.run(rounds=3)
    resumed.run(rounds=2)
    assert resumed.clock == straight.clock
    assert resumed.comm == straight.comm
    assert resumed.rounds == straight.rounds[1:]
    for a, b in zip(straight.history, resumed.history):
        for k in ("round", "clock", "comm", "comm_up", "comm_down",
                  "comm_dispatch", "committed", "pending"):
            assert a[k] == b[k], k
        assert abs(a["loss"] - b["loss"]) <= TOL
    if writer == "reference":
        assert param_diff(straight.params, resumed.params) <= TOL
        assert set(resumed.channel._residuals) \
            == set(straight.channel._residuals)
    else:
        assert param_diff(resumed.params, straight.params) <= TOL


@pytest.mark.parametrize("seed", [0, 7, 123456])
def test_prng_key_is_the_references(seed):
    m = SplitModel(get_config("resnet8"))
    data = {0: {"x": np.zeros((4, 32, 32, 3), np.float32),
                "y": np.zeros(4, np.int32)}}
    eng = S2FLEngine(m, data, EngineConfig(seed=seed), device="cpu")
    want = np.asarray(jax.random.PRNGKey(seed + 1))
    assert eng._key.dtype == want.dtype
    assert np.array_equal(eng._key, want)


def test_tree_files_are_the_references(tmp_path):
    """A tree of tensors written by the port reads back through either
    package's loader with its paths, dtypes and values."""
    tree = {"b": [torch.arange(6, dtype=torch.float32).view(2, 3),
                  (torch.ones(2, dtype=torch.int32),)],
            "a": {"z": torch.tensor(2.5, dtype=torch.float64)}}
    path = str(tmp_path / "t.npz")
    save_checkpoint(path, tree, extra={"n": np.int64(3)})
    for load in (load_checkpoint, ref_load):
        back, extra = load(path)
        assert extra == {"n": 3}
        assert isinstance(back["b"][1], tuple)
        got = [np.asarray(x) for x in jax.tree.leaves(back)]
        want = [t.numpy() for t in tree_leaves(tree)]
        assert [g.dtype for g in got] == [w.dtype for w in want]
        assert all(np.array_equal(g, w) for g, w in zip(got, want))
    back, _ = load_checkpoint(path, like=tree)
    assert np.array_equal(back["b"][0], tree["b"][0].numpy())
    with pytest.raises(ValueError, match="mismatch"):
        load_checkpoint(path, like={"a": {"z": 0}})
