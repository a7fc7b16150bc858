"""The port stands alone: no module of ``src/repro_torch`` (nor
``chip_smoke.py``) imports JAX, the reference package or ``ml_dtypes``,
the trainer and the server import with JAX and the reference blocked,
they run on the card unless the CPU is asked for, every trainer flag
runs on the CPU, S²FL training of an LM still raises before any work,
and the MoE / MLA archs that slice 3 ported resolve, build and serve."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import dataclasses

import pytest
import torch

from repro_torch.configs import get_config, make_reduced
from repro_torch.launch import serve, train
from repro_torch.models import SplitModel

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro", "ml_dtypes")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


def test_no_port_module_imports_jax_or_the_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    bad = [f"{f.relative_to(ROOT)}:{line} imports {mod}"
           for f in files for mod, line in _imported_roots(f)
           if mod in FORBIDDEN]
    assert not bad, bad


def test_trainer_imports_with_jax_and_reference_blocked():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import repro_torch.launch.train\n"
            "import repro_torch.core.engine\n"
            "import repro_torch.kernels.comm_fused.ops\n"
            "import repro_torch.launch.serve\n"
            "import repro_torch.kernels.flash_attention.ops\n"
            "import repro_torch.kernels.ssd_scan.ops\n"
            "import repro_torch.kernels.moe_gmm.ops\n"
            "import repro_torch.models.moe\n"
            "import repro_torch.core.faults\n"
            "import repro_torch.core.control\n"
            "import repro_torch.core.fleet\n"
            "import repro_torch.checkpoint\n"
            "import repro_torch.checkpoint.state\n"
            "import repro_torch.observe\n"
            "import repro_torch.observe.trace\n"
            "import repro_torch.observe.metrics\n"
            "import repro_torch.observe.critical\n"
            "import repro_torch.observe.export\n"
            "import repro_torch.observe.history\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


SMALL = ["--arch", "resnet8", "--rounds", "1", "--clients", "2",
         "--per-round", "2", "--batch-size", "4", "--n-train", "16"]


def test_default_device_is_cuda_and_never_falls_back(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default runs there")
    assert train.build_parser().get_default("device") == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(SMALL)
    assert "round" not in capsys.readouterr().out   # no training happened


@pytest.mark.parametrize("flags", [["--arch", "internlm2-1.8b"]])
def test_flags_of_unported_modules_raise(flags, tmp_path, capsys):
    """S²FL training of the LM families is the one refusal left."""
    with pytest.raises(NotImplementedError, match="later slice"):
        train.main(["--device", "cpu", *SMALL, *flags,
                    "--out", str(tmp_path / "o.json")])
    assert not (tmp_path / "o.json").exists()
    assert "round" not in capsys.readouterr().out


@pytest.mark.parametrize("flags", [
    ["--fleet-size", "100"], ["--clusters", "4"],
    ["--cluster-quorum", "0.5"], ["--fault-kill-prob", "0.1"],
    ["--fault-plan", "plan.json"], ["--checkpoint-every", "1"],
    ["--resume-from", "checkpoints/round00001.npz"],
    ["--trace-out", "t.json"], ["--metrics-out", "m.jsonl"],
    ["--resource-aware"], ["--auto-knobs"], ["--scheduler", "joint"],
    ["--fused-server"],
])
def test_flags_of_ported_modules_run(flags, tmp_path, monkeypatch):
    """The 13 flag sets that raised until their modules were ported now
    train on the CPU and write ``--out`` (and what the flag writes)."""
    from repro_torch.core.faults import FaultPlan
    monkeypatch.chdir(tmp_path)
    cpu = ["--device", "cpu", *SMALL]
    if flags[0] == "--fault-plan":
        FaultPlan.random([0, 1], 1, seed=0, kill_prob=0.5).to_file(
            "plan.json")
    if flags[0] == "--resume-from":      # a snapshot of a first call
        train.main([*cpu, "--checkpoint-every", "1"])
        cpu += ["--rounds", "2"]
    train.main([*cpu, *flags, "--out", "o.json"])
    with open("o.json") as f:
        out = json.load(f)
    assert len(out["history"]) == (2 if flags[0] == "--resume-from" else 1)
    wrote = {"--checkpoint-every": "checkpoints/round00001.npz",
             "--trace-out": "t.json", "--metrics-out": "m.jsonl"}
    if flags[0] in wrote:
        assert (tmp_path / wrote[flags[0]]).exists()


def test_cpu_run_when_asked(tmp_path):
    out = tmp_path / "o.json"
    train.main(["--device", "cpu", *SMALL, "--codec", "int8",
                "--out", str(out)])
    assert out.exists()


def test_server_defaults_to_cuda_and_never_falls_back(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default runs there")
    assert serve.build_parser().get_default("device") == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", "zamba2-1.2b", "--gen", "2"])
    assert "generated" not in capsys.readouterr().out


def test_server_cpu_run_when_asked(capsys):
    out = serve.main(["--device", "cpu", "--arch", "zamba2-1.2b",
                      "--batch", "2", "--prompt-len", "8", "--gen", "3"])
    assert tuple(out.shape) == (2, 3)
    assert "generated" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "kimi-k2-1t-a32b"])
def test_moe_and_mla_archs_raise_naming_slice_3(arch, capsys):
    """Slice 3 ported these archs, so the refusal this test held is gone
    (the name is kept): the id resolves, the CLI serves its reduced
    variant on the CPU, and S²FL training of an LM still raises, naming
    the later slice."""
    cfg = get_config(arch)
    assert cfg.arch_type == "moe" and "moe" in {f for _, f in cfg.pattern()}
    out = serve.main(["--device", "cpu", "--arch", arch, "--batch", "2",
                      "--prompt-len", "8", "--gen", "3"])
    assert tuple(out.shape) == (2, 3)
    assert "generated" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="later slice"):
        train.main(["--device", "cpu", "--arch", arch])


@pytest.mark.parametrize("field", [
    {"mla": True, "kv_lora_rank": 32, "qk_rope_head_dim": 16,
     "qk_nope_head_dim": 16, "v_head_dim": 32},
    {"ffn_pattern": ("moe",), "n_experts": 4, "top_k": 2, "moe_d_ff": 32},
])
def test_moe_and_mla_configs_raise_naming_slice_3(field):
    """Slice 3 ported latent attention and the MoE feed-forward, so the
    refusal this test held is gone (the name is kept): a config with
    either field builds, and its forward, prefill and a decode step run
    on the CPU with finite logits."""
    from repro_torch.models import transformer as tf
    cfg = dataclasses.replace(
        make_reduced(get_config("internlm2-1.8b"), n_layers=1), **field)
    params = SplitModel(cfg).init(0, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 12),
                           generator=torch.Generator().manual_seed(0))
    logits, aux = tf.forward(cfg, params, tokens)
    assert bool(torch.isfinite(logits).all()) and bool(torch.isfinite(aux))
    last, caches, n = tf.prefill(cfg, params, tokens, 16)
    step, _ = tf.decode_step(cfg, params, tokens[:, -1:], caches, n)
    assert bool(torch.isfinite(last).all() and torch.isfinite(step).all())
