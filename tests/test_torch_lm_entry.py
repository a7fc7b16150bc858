"""The LM entry points of the port on the CPU, and the kernel wrappers'
refusal of a gradient.

- ``repro_torch.launch.train --arch internlm2-1.8b --reduced`` trains,
  and its simulated clock and wire bytes equal ``repro.launch.train``'s
  on the same arguments (the initial params differ: each package draws
  its own, so losses are not compared here; tests/test_torch_lm_train.py
  compares them from shared params).
- Each of ``repro_torch.examples.{federated_lm,quickstart,paper_repro,
  serve_decode}`` runs on ``--device cpu`` at its smallest arguments.
- The flash attention, SSD scan and moe_gmm wrappers raise when an
  input requires a gradient under grad mode, on the CPU as on the card
  (their kernels have no backward; the reference's cannot be
  differentiated either), and run under ``torch.no_grad()``; their plain
  functions still give gradients. An LM configured with
  ``attn_impl="pallas"`` refuses to train."""
import dataclasses
import json
import math

import numpy as np
import pytest
import torch
import torch_engine_golden  # noqa: F401  (one intra-op thread)

from repro.launch import train as ref_train
from repro_torch.configs import get_config, make_reduced
from repro_torch.core.engine import EngineConfig, S2FLEngine
from repro_torch.data.partition import federate
from repro_torch.data.synthetic import make_lm_dataset
from repro_torch.kernels.flash_attention.kernel import (attention_plain,
                                                        flash_attention_bhsd)
from repro_torch.kernels.moe_gmm.kernel import moe_gmm, moe_gmm_plain
from repro_torch.kernels.ssd_scan.kernel import ssd_scan, ssd_scan_plain
from repro_torch.launch import train
from repro_torch.models import SplitModel

CLI = ["--arch", "internlm2-1.8b", "--reduced", "--rounds", "2",
       "--n-train", "120", "--seq-len", "16"]


def test_train_cli_lm_matches_reference_clock_and_comm(tmp_path):
    train.main(["--device", "cpu", *CLI, "--out", str(tmp_path / "p.json")])
    ref_train.main([*CLI, "--out", str(tmp_path / "r.json")])
    with open(tmp_path / "p.json") as f:
        port = json.load(f)
    with open(tmp_path / "r.json") as f:
        ref = json.load(f)
    assert port["clock"] == ref["clock"] and port["comm"] == ref["comm"]
    assert [(h["clock"], h["comm"]) for h in port["history"]] \
        == [(h["clock"], h["comm"]) for h in ref["history"]]
    assert all(math.isfinite(h["loss"]) for h in port["history"])
    assert port["final"]["acc"] is None and ref["final"]["acc"] is None


@pytest.mark.parametrize("name,argv", [
    ("federated_lm", ["--rounds", "1", "--seq-len", "8"]),
    ("quickstart", []),
    ("paper_repro", ["--rounds", "1", "--clients", "6",
                     "--local-steps", "1"]),
    ("serve_decode", ["--batch", "1", "--prompt-len", "8", "--gen", "2"]),
])
def test_examples_run_on_cpu(name, argv, capsys):
    import importlib
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    out = mod.main(["--device", "cpu", *argv])
    text = capsys.readouterr().out
    if name == "serve_decode":
        assert tuple(out.shape) == (1, 2)
    elif name == "paper_repro":
        assert set(out) == {"fedavg", "sfl", "s2fl"}
        assert all(0.0 <= acc <= 1.0 for acc, _ in out.values())
    else:
        assert math.isfinite(out.history[-1]["loss"]) and out.clock > 0
    assert text.strip()


def _r(gen, *shape, scale=1.0):
    return torch.from_numpy(
        (gen.normal(size=shape) * scale).astype(np.float32))


def _flash_inputs(gen):
    return _r(gen, 1, 4, 16, 8), _r(gen, 1, 2, 16, 8), _r(gen, 1, 2, 16, 8)


def _ssd_inputs(gen):
    b, s, h, p, n = 1, 16, 2, 4, 8
    return (_r(gen, b, s, h, p), torch.rand(b, s, h) * 0.5,
            -torch.rand(h) - 0.5, _r(gen, b, s, n), _r(gen, b, s, n))


def _gmm_inputs(gen):
    E, C, d, F = 2, 8, 16, 32
    return (_r(gen, E, C, d), _r(gen, E, d, F, scale=0.2),
            _r(gen, E, d, F, scale=0.2), _r(gen, E, F, d, scale=0.2))


WRAPPERS = {
    "flash_attention": (_flash_inputs,
                        lambda *t: flash_attention_bhsd(*t),
                        lambda *t: attention_plain(*t)),
    "ssd_scan": (_ssd_inputs, lambda *t: ssd_scan(*t, chunk=8)[0],
                 lambda *t: ssd_scan_plain(*t, chunk=8)[0]),
    "moe_gmm": (_gmm_inputs, lambda *t: moe_gmm(*t),
                lambda *t: moe_gmm_plain(*t)),
}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrapper_refuses_a_gradient(name):
    make, wrapper, plain = WRAPPERS[name]
    ins = make(np.random.default_rng(0))
    with torch.no_grad():                       # serving: runs
        want = plain(*ins)
        np.testing.assert_array_equal(wrapper(*ins).numpy(), want.numpy())
    assert torch.isfinite(wrapper(*ins)).all()  # no input requires grad
    # any one input that requires a gradient is refused under grad mode
    for i in range(len(ins)):
        req = [t.clone().requires_grad_(j == i) for j, t in enumerate(ins)]
        with pytest.raises(RuntimeError,
                           match=f"{name}: the kernel has no backward.*"
                                 f"attn_impl=\"xla\""):
            wrapper(*req)
        with torch.no_grad():
            wrapper(*req)
    # the plain function stays differentiable
    req = [t.clone().requires_grad_(True) for t in ins]
    grads = torch.autograd.grad(plain(*req).square().sum(), req)
    assert all(g is not None and bool(torch.isfinite(g).all())
               and bool(g.abs().sum() > 0) for g in grads)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "zamba2-1.2b",
                                  "deepseek-v2-lite-16b"])
def test_lm_training_through_kernels_is_refused(arch):
    """The client forward runs under no_grad, so the refusal comes from
    the first step that needs a gradient."""
    cfg = dataclasses.replace(make_reduced(get_config(arch)),
                              attn_impl="pallas")
    ds = make_lm_dataset(24, seq_len=32, vocab=256, seed=0)
    eng = S2FLEngine(SplitModel(cfg), federate(ds, 2, seed=0),
                     EngineConfig(rounds=1, clients_per_round=2,
                                  batch_size=4), device="cpu")
    with pytest.raises(RuntimeError, match="no backward"):
        eng.run_round()
