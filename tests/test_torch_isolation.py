"""The port stands alone: no module of ``src/repro_torch`` (nor
``chip_smoke.py``) imports JAX or the reference package, the trainer
imports with both blocked, it runs on the card unless the CPU is asked
for, and the flags of modules not ported yet raise before any work."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.launch import train

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


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


@pytest.mark.parametrize("flags", [
    ["--fleet-size", "100"], ["--clusters", "4"],
    ["--cluster-quorum", "0.5"], ["--fault-kill-prob", "0.1"],
    ["--fault-plan", "plan.json"], ["--checkpoint-every", "1"],
    ["--resume-from", "x.npz"], ["--trace-out", "t.json"],
    ["--metrics-out", "m.jsonl"], ["--resource-aware"], ["--auto-knobs"],
    ["--scheduler", "joint"], ["--fused-server"],
    ["--arch", "internlm2-1.8b"],
])
def test_flags_of_unported_modules_raise(flags, tmp_path, capsys):
    with pytest.raises(NotImplementedError):
        train.main(["--device", "cpu", *SMALL, *flags,
                    "--out", str(tmp_path / "o.json")])
    assert not (tmp_path / "o.json").exists()
    assert "round" not in capsys.readouterr().out


def test_cpu_run_when_asked(tmp_path):
    out = tmp_path / "o.json"
    train.main(["--device", "cpu", *SMALL, "--codec", "int8",
                "--out", str(out)])
    assert out.exists()
