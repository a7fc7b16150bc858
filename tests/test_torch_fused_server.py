"""The port's multi-group server step (``fused_server``: same-signature
groups' Eq.-3 losses, gradients and Eq.-4 updates in one
``torch.func.vmap`` call) against a live reference run of its vmapped,
jitted step, on the golden config (tests/torch_engine_golden.py) with
two local steps, where the cohort's two groups share a signature.

Clock, wire bytes and every round's splits are EXACTLY equal. Params are
held to 1e-4, and so are losses under int8; measured against the
reference, at most over 1 and 8 CPU threads: int8 5.2e-5 (losses) /
3.6e-5 (params), top-k 9.1e-4 / 6.1e-5. Top-k's losses are held to the
reference's own fused-versus-sequential 1e-3 (tests/test_fused_comm.py):
the port's SEQUENTIAL path drifts as far from the reference's at two
local steps (8.6e-4 / 6.2e-5, 1 to 8 CPU threads), because a few-ulp
difference in a feature moves which values pass top-k's threshold and
error feedback carries that on; the reference's fused path is within
1.2e-7 of its sequential one. The port's fused path against its own sequential path: 4.9e-5 /
2.0e-5 (int8) on the CPU, where oneDNN sums the vmapped (grouped)
convolutions in another order."""
import math

import pytest
import torch

from torch_engine_golden import compare, make_pair
from repro_torch.core.engine import _sgd, _tree_index, _tree_stack
from repro_torch.utils.tree import get_subtree, tree_leaves

TOL = 1e-4
LOSS_TOL = {"int8": 1e-4, "topk": 1e-3}


def _count_multi(ref, port):
    """Count the batched server calls of both engines and the groups
    each call stacked."""
    import jax
    calls = {"ref": [], "port": []}
    get = ref._get_multi_server_step

    def ref_get(gsplits):
        fn = get(gsplits)

        def counted(sp, feats, batches):
            calls["ref"].append(int(jax.tree.leaves(sp)[0].shape[0]))
            return fn(sp, feats, batches)
        return counted

    ref._get_multi_server_step = ref_get
    step = port._multi_server_step

    def port_step(gsplits, sp, feats, batches):
        calls["port"].append(int(tree_leaves(sp)[0].shape[0]))
        return step(gsplits, sp, feats, batches)

    port._multi_server_step = port_step
    return calls


@pytest.mark.parametrize("codec", ["int8", "topk"])
def test_fused_server_matches_reference(codec):
    ref, port = make_pair(comm={"codec": codec, "error_feedback": True},
                          local_steps=2, fused_comm=True, fused_server=True)
    calls = _count_multi(ref, port)
    ref.run(rounds=3)
    port.run(rounds=3)
    # the multi-group path ran: every local step stacked both groups
    assert calls["port"] and calls["port"] == calls["ref"]
    assert all(g >= 2 for g in calls["port"])
    compare(ref, port, loss_tol=LOSS_TOL[codec], param_tol=TOL)
    assert set(port.channel._residuals) == set(ref.channel._residuals)


def _run_port(fused_server):
    _, port = make_pair(comm={"codec": "int8", "error_feedback": True},
                        local_steps=2, fused_comm=True,
                        fused_server=fused_server)
    port.run(rounds=3)
    return port


def test_fused_server_matches_sequential_server_path():
    seq, fused = _run_port(False), _run_port(True)
    assert fused.clock == seq.clock and fused.comm == seq.comm
    assert fused.rounds == seq.rounds
    for a, b in zip(seq.history, fused.history):
        assert a["comm"] == b["comm"] and a["clock"] == b["clock"]
        assert abs(a["loss"] - b["loss"]) <= TOL
    dp = max(float((a - b).abs().max())
             for a, b in zip(tree_leaves(seq.params),
                             tree_leaves(fused.params)))
    assert dp <= TOL
    assert set(seq.channel._residuals) == set(fused.channel._residuals)
    assert abs(seq.channel.residual_norm()
               - fused.channel.residual_norm()) <= 1e-2


def test_multi_server_step_keeps_unreached_leaves_bit_equal():
    """The client half's leaves of a server copy get a zero gradient
    under vmap (no gradient on the sequential path): the update must
    leave them bit-equal, and the server half's update, the losses and
    dfx must agree with the sequential step's within 1e-4."""
    _, port = make_pair()
    m, split = port.model, 2
    gen = torch.Generator().manual_seed(0)
    batches = [[{"x": torch.randn(8, 32, 32, 3, generator=gen),
                 "y": torch.randint(0, 10, (8,), generator=gen)}
                for _ in range(2)] for _ in range(2)]
    feats = [[m.client_forward(port.params, b, split) for b in g]
             for g in batches]
    new, vals, dfx = port._multi_server_step(
        (split, split), _tree_stack([port.params] * 2),
        _tree_stack(feats), _tree_stack(batches))
    for gi in range(2):
        got = _tree_index(new, gi)
        for name, path in m.segments():
            if name in m.client_segments(split):
                for x, y in zip(tree_leaves(get_subtree(got, path)),
                                tree_leaves(get_subtree(port.params,
                                                        path))):
                    assert torch.equal(x, y), name
        loss, sgrads, dfxs = port._server_step(
            port.params, feats[gi], batches[gi], (split, split))
        want = _sgd(port.params, sgrads, port.ecfg.lr)
        assert abs(float(loss) - float(vals[gi])) <= TOL
        for x, y in zip(tree_leaves(got), tree_leaves(want)):
            assert float((x - y).abs().max()) <= TOL
        for x, y in zip(tree_leaves(_tree_index(dfx, gi)),
                        tree_leaves(dfxs)):
            assert float((x - y).abs().max()) <= TOL
    assert all(math.isfinite(float(v)) for v in vals)
