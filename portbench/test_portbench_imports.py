"""No module the benchmark runs imports JAX, flax or the JAX package
``repro`` (top-level names compared whole: ``repro_torch`` is not
``repro``); the reference imports nothing of the port; nothing reads
``benchmarks/``."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(p for p in HERE.rglob("*.py")
                 if not p.name.startswith("test_"))


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(
    HERE)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not set(_imports(path)) & FORBIDDEN
    assert "benchmarks/" not in path.read_text()


def test_the_reference_imports_nothing_of_the_port():
    for path in (HERE / "reference").glob("*.py"):
        assert "repro_torch" not in set(_imports(path)), path
        assert "repro_torch" not in path.read_text(), path


def test_a_run_loads_no_jax_module():
    """Import everything a run imports (the harness, every driver,
    reader and config, and the port's modules they reach) in a fresh
    process and look at sys.modules by top-level name."""
    code = (
        "import sys, importlib\n"
        "from portbench import run, cell\n"
        "from portbench.drivers import prefill, s2fl_train\n"
        "spec = cell.benchmark()\n"
        "for w in spec['workloads']:\n"
        "    c = cell.find_cell(w['name'])\n"
        "    c.build_config(); c.driver()\n"
        "    [cell.metric_reader(m['name']) for m in c.per_layer]\n"
        "import repro_torch.core.engine, repro_torch.models.transformer\n"
        "import repro_torch.kernels.int8_quant.kernel\n"
        "print(run.forbidden_modules())\n")
    src = HERE.parent / "src"
    out = subprocess.run([sys.executable, "-c", code], cwd=HERE.parent,
                         capture_output=True, text=True, timeout=300,
                         env={"PYTHONPATH": f"{src}:{HERE.parent}",
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_compare_whole():
    from portbench import run
    sys.modules.setdefault("repro_torch_lookalike", sys)
    try:
        assert "repro_torch_lookalike" not in run.forbidden_modules()
    finally:
        sys.modules.pop("repro_torch_lookalike", None)
