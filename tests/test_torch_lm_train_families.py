"""S²FL training of the hybrid and MoE LM families on the port against a
live reference run (``make_lm_pair``, as tests/test_torch_lm_train.py):
reduced zamba2-1.2b (an SSM block and the shared attention block, which
Algorithm 1 aggregates once whichever side trains it), reduced
deepseek-v2-lite-16b (MLA in both layers, a dense and an MoE FFN whose
router loss is summed into the loss), and the multi-group server step
(``fused_server``: 4 clients a round, so two groups of 2 share a
signature and ride one ``torch.func.vmap`` call) on the dense and the
MoE config.

Clock, wire bytes and splits are EXACTLY equal; losses within 1e-5 and
final params within 5e-5 in float32 (measured at most 3.2e-7 / 5.5e-6,
the MoE's largest; the vmapped MoE step 2.4e-7 / 4.2e-6)."""
import pytest
from torch_engine_golden import compare, make_lm_pair

F32 = dict(loss_tol=1e-5, param_tol=5e-5)


@pytest.mark.parametrize("arch,kw", [
    ("zamba2-1.2b", {}),
    ("zamba2-1.2b", {"fused_comm": True,
                     "comm": {"codec": "topk", "error_feedback": True}}),
    ("deepseek-v2-lite-16b", {}),
], ids=["zamba2", "zamba2-fused-topk", "deepseek"])
def test_lm_families_match_reference(arch, kw):
    ref, port = make_lm_pair(arch, **kw)
    ref.run(rounds=2)
    port.run(rounds=2)
    compare(ref, port, **F32)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "deepseek-v2-lite-16b"])
def test_lm_fused_server_matches_reference(arch):
    ref, port = make_lm_pair(arch, fused_server=True, clients_per_round=4)
    stacked = []
    inner = port._multi_server_step

    def multi(gsplits, sp, *a):
        stacked.append(len(gsplits))
        return inner(gsplits, sp, *a)

    port._multi_server_step = multi
    ref.run(rounds=2)
    port.run(rounds=2)
    assert stacked, "no batched server step ran"
    compare(ref, port, **F32)
