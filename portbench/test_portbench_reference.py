"""The plain reference against the port's CPU path on reduced internlm2
and deepseek, in float32 (where both compute the same equations, they
agree to rounding), and the S²FL reference's clock and bytes against the
port's engine (exact)."""
import dataclasses

import pytest
import torch

from portbench import traffic, weights
from portbench.cell import find_cell
from portbench.drivers import s2fl_train
from portbench.drivers.prefill import rel_err
from portbench.reference import lm as ref

DEV = torch.device("cpu")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg(name, **kw):
    from repro_torch.configs import get_config, make_reduced
    cfg = make_reduced(get_config(name), n_layers=3, d_model=256)
    return dataclasses.replace(cfg, **kw)


@pytest.mark.parametrize("name,impl", [
    ("internlm2-1.8b", "xla"), ("internlm2-1.8b", "pallas"),
    ("deepseek-v2-lite-16b", "xla"), ("deepseek-v2-lite-16b", "pallas")])
def test_prefill_reference_matches_the_port_in_f32(name, impl):
    from repro_torch.models import transformer as tf
    cfg = _cfg(name, dtype="float32", attn_impl=impl)
    W = weights.make_weights(tf.model_defs(cfg), 11, "float32", DEV)
    tok = torch.randint(0, cfg.vocab_size, (2, 48),
                        generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        lg, caches, _ = tf.prefill(cfg, W, tok, 60)
    rl, rc = ref.prefill(cfg, W, tok)
    assert rel_err(lg[:, -1, :cfg.vocab_size].float(), rl) < 1e-5
    for layer, c in rc.items():
        for n, t in c.items():
            assert rel_err(caches[layer][n][:, :48].float(), t) < 1e-5


def test_fp8_control_rounds_and_keeps_gradients():
    x = torch.linspace(-3, 3, 101, requires_grad=True)
    y = ref.fp8(x)
    assert not torch.equal(y, x) and float((y - x).detach().abs().max()) < 0.2
    y.sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))


def test_capacity_drops_first_come_first_served():
    cfg = _cfg("deepseek-v2-lite-16b", dtype="float32")
    p = weights.make_weights(
        {"ffn": __import__("repro_torch.models.moe", fromlist=["x"])
         .moe_defs(cfg)}, 5, "float32", DEV)["ffn"]
    # the router sends every token to experts 0 and 1 first
    p["router"] = torch.zeros_like(p["router"])
    p["router"][:, 0] = 1.0
    p["router"][:, 1] = 0.5
    x = torch.ones(1, 64, cfg.d_model)
    out = ref.moe(cfg, p, x, ref.ident)
    # T 64, k 2, E 4: C = max(8, ceil8(int(1.25 * 2 * 64 / 4))) = 40; the
    # first 40 tokens get both experts, the rest only the shared one
    shared = ref.swiglu(p["shared"], x.reshape(64, -1), ref.ident)
    kept = (out.reshape(64, -1) - shared).abs().sum(-1) > 0
    assert kept[:40].all() and not kept[40:].any()


def _train_cell(**mix):
    cell = find_cell("s2fl_train.internlm2-1.8b.int8ef")
    cell.mix = dict(cell.mix, sequences=160, seq_len=8, batch=4, **mix)
    return cell


def test_s2fl_reference_follows_the_port_in_f32():
    """Reduced internlm2 (8 layers: split points 1, 2, 4), f32
    activations, through the warm-up into the sliding split's steady
    state, whose last round gives the clients splits of their own: the
    losses and the per-leaf norms agree to rounding, the clock and the
    wire bytes exactly."""
    from repro_torch.models.transformer import model_defs
    cell = _train_cell()
    cfg = _cfg("internlm2-1.8b", dtype="float32", attn_impl="xla")
    cfg = dataclasses.replace(cfg, n_layers=8, block_pattern=("attn",) * 8,
                              ffn_pattern=("dense",) * 8)
    seed = 2 ** 31 + 7
    data = traffic.federated_lm(cell.mix, seed)
    w0 = weights.make_weights(model_defs(cfg), seed, "float32", DEV)
    eng = s2fl_train._engine(cfg, cell.mix, data, w0, DEV)
    losses = [eng.run_round()["loss"]
              for _ in range(cell.mix["checked_rounds"])]
    prog = {"losses": losses, "grad": {}, "change": {},
            "clock": eng.clock, "comm": eng.comm}
    refr = s2fl_train.reference_readings(cell, cfg, data, seed, DEV)
    prog["grad"] = prog["change"] = refr["grad"]
    warm, last = refr["splits"][0], refr["splits"][-1]
    assert len(set(warm.values())) == 1 and len(set(last.values())) > 1
    assert len(refr["splits"]) > 3
    assert prog["clock"] == refr["clock"] and prog["comm"] == refr["comm"]
    for a, b in zip(losses, refr["losses"]):
        assert a == pytest.approx(b, rel=1e-5)
    change = s2fl_train._norms(eng.params, w0)
    gap, _ = s2fl_train.leaf_gap(change, refr["change"], refr["grad"])
    assert gap < 1e-4
    assert s2fl_train.split_points(8, 3) == (1, 2, 4)
    assert s2fl_train.split_points(24, 3) == (3, 6, 12)


def test_steady_splits_match_the_median():
    """§3.1: each client's split is the one whose recorded time lies
    closest to the median of all the participants' times."""
    from portbench.reference.s2fl import steady_splits
    table = {0: {1: 1.0, 2: 2.0, 4: 4.0}, 1: {1: 3.0, 2: 6.0, 4: 12.0},
             2: {1: 0.5, 2: 2.9, 4: 9.0}}
    # median of the nine times: 3.0
    assert steady_splits([0, 1, 2], table, (1, 2, 4)) == {0: 2, 1: 1, 2: 2}
    assert steady_splits([0], table, (1, 2, 4)) == {0: 2}
