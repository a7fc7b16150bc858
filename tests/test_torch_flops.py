"""Parameter trees and Eq.-1 accounting of the port against the
reference: leaf order of the port's flatten, the numpy<->tensor bridge,
the literal per-unit cost table against the live XLA cost analysis, and
the analytic transformer costs of every LM config, bit for bit."""
import jax
import numpy as np
import pytest

from repro.configs import get_config as ref_get_config
from repro.models import SplitModel as RefModel
from repro.utils import flops as ref_flops
from repro_torch.configs import CNNConfig, get_config, list_configs
from repro_torch.models import SplitModel
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.utils import flops
from repro_torch.utils.tree import tree_leaves


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


@pytest.mark.parametrize("name", ["resnet8", "vgg16", "mobilenet"])
def test_leaf_order_matches_jax_flatten(name):
    """Model legs flatten each client portion and key residuals and
    rand-k draws by leaf index: the port's flatten must walk the tree in
    jax.tree.flatten's order (dict keys sorted)."""
    rm = RefModel(ref_get_config(name))
    rp = _np_tree(jax.jit(rm.init)(jax.random.PRNGKey(0)))
    tp = params_from_numpy(rp, device="cpu")
    ref_leaves = jax.tree.leaves(rp)
    port_leaves = tree_leaves(tp)
    assert len(ref_leaves) == len(port_leaves)
    for a, b in zip(ref_leaves, port_leaves):
        np.testing.assert_array_equal(a, b.numpy())
    # and back again, leaf for leaf
    back = params_to_numpy(tp)
    for a, b in zip(jax.tree.leaves(back), ref_leaves):
        np.testing.assert_array_equal(a, b)
    # the port's own init has the reference's shapes in the same order
    mine = tree_leaves(SplitModel(get_config(name)).init(0, device="cpu"))
    assert [tuple(t.shape) for t in mine] == [a.shape for a in ref_leaves]


@pytest.mark.parametrize("name", ["resnet8", "vgg16", "mobilenet"])
def test_flops_table_matches_live_reference(name):
    """The literal unit-cost table equals the reference's live XLA cost
    analysis, so the Eq.-1 inputs are identical at every split."""
    rcfg, tcfg = ref_get_config(name), get_config(name)
    assert flops.CNN_UNIT_COSTS[name] == ref_flops._cnn_unit_costs(rcfg)
    rm, tm = RefModel(rcfg), SplitModel(tcfg)
    for s in range(0, rm.n_units + 1):
        assert flops.split_costs(tm, s) == ref_flops.split_costs(rm, s)


def test_deepseek_costs_equal_reference_and_untabled_cnn_refused():
    """deepseek-v2-lite-16b's full-width segment parameter counts equal
    the reference's (15.7 B in all) and so does its ``split_costs``; a
    CNN with no unit-cost table is refused."""
    name = "deepseek-v2-lite-16b"
    rm, tm = RefModel(ref_get_config(name)), SplitModel(get_config(name))
    counts = flops.segment_param_counts(tm)
    assert counts == ref_flops.segment_param_counts(rm)
    assert sum(counts.values()) == 15_706_484_224
    assert flops.split_costs(tm, 1, seq_len=64) \
        == ref_flops.split_costs(rm, 1, seq_len=64)
    narrow = CNNConfig(name="vgg-narrow", family="vgg",
                       stages=((8, 1), (16, 2)))
    with pytest.raises(KeyError, match="no unit-cost table"):
        flops.split_costs(SplitModel(narrow), 1)


LM_CONFIGS = [n for n in list_configs()
              if not isinstance(get_config(n), CNNConfig)]


@pytest.mark.parametrize("name", LM_CONFIGS)
def test_lm_split_costs_bit_equal_to_reference(name):
    """Every LM config at full width, seq 64: the Eq.-1 inputs at splits
    1, the middle and n_layers - 1, and ``model_flops_6nd``, equal the
    reference's floats bit for bit (the simulated clock is built from
    them)."""
    rcfg, tcfg = ref_get_config(name), get_config(name)
    rm, tm = RefModel(rcfg), SplitModel(tcfg)
    n = tcfg.n_layers
    for s in (1, n // 2, n - 1):
        assert flops.split_costs(tm, s, seq_len=64) \
            == ref_flops.split_costs(rm, s, seq_len=64), (name, s)
    assert flops.model_flops_6nd(tcfg, 4096) \
        == ref_flops.model_flops_6nd(rcfg, 4096)


def test_internlm2_split_costs_pinned():
    """internlm2-1.8b at split 3, seq 64: the numbers the full-width card
    run's simulated clock is built from."""
    c = flops.split_costs(SplitModel(get_config("internlm2-1.8b")), 3,
                          seq_len=64)
    assert (c["w_size"], c["wc_size"], c["feat_size"], c["fc"], c["fs"]) \
        == (1889110016.0, 378286080.0, 131072.0, 72628568064.0,
            581179539456.0)
