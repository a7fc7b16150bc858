"""The port's production-mesh dry-run (``repro_torch.launch.dryrun``):
the fused S²FL step traced on a fake (4, 2) group at reduced width (the
counterpart of the reference's ``test_fused_step_lowers_on_small_mesh``,
a JAX host-mesh lowering that fails on the reference's side), and every
step kind traced on the production (16, 16) mesh at full width and two
layers (six for zamba2), each of which needs one of the repairs of the
step builders and the model code (on a mesh of 256 ranks the batch and
the heads are sharded at once). Records carry every key of the
reference's.

A process joins one process group in its life, so each mesh is traced
in a subprocess with a time limit. ``repro.launch.dryrun`` is never
imported here (it sets a 512-device XLA flag at import)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config, list_configs
from repro_torch.configs.base import CNNConfig
from repro_torch.launch import dryrun
from repro_torch.models import transformer as tf

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 600

# the reference's record (``src/repro/launch/dryrun.py:108-118``)
REF_KEYS = {"arch", "shape", "chips", "t_compute_s", "t_memory_s",
            "t_collective_s", "dominant", "hlo_flops", "hlo_bytes",
            "coll_bytes", "model_flops", "useful_ratio", "flops_estimated",
            "multi_pod", "lower_s", "compile_s", "bytes_per_device",
            "argument_bytes", "output_bytes", "peak_bytes", "coll_counts"}


def _traced(code: str) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=TIMEOUT_S)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("RESULT ")]
    assert len(line) == 1, out.stdout[-2000:] + out.stderr[-2000:]
    return json.loads(line[0][len("RESULT "):])


SMALL = """
import json
from repro_torch.configs import get_config, make_reduced
from repro_torch.launch import dryrun
mesh = dryrun.fake_mesh((4, 2), ("data", "model"), device="cpu")
out = {}
for arch in ("internlm2-1.8b", "zamba2-1.2b"):
    out[arch] = dryrun.dryrun_step(
        make_reduced(get_config(arch)), mesh, "train_4k", device="cpu",
        batch=8, seq=32, split=1, n_groups=2, verbose=False)
print("RESULT " + json.dumps(out, default=str))
"""


@pytest.fixture(scope="module")
def small():
    return _traced(SMALL)


def _live_share(cfg) -> float:
    """The share of the config's parameters that its forward reads: a
    ``shared_attn`` block declares a dense FFN and its norm, as the
    reference's does, and runs the shared block's instead, so 6·N·D
    counts them though no product reads them."""
    from repro_torch.models.params import count_params
    defs = tf.model_defs(cfg)
    dead = sum(count_params({k: b[k] for k in ("ffn", "norm2") if k in b})
               for (mixer, _), b in zip(cfg.pattern(), defs["blocks"])
               if mixer == "shared_attn")
    total = count_params(defs)
    return (total - dead) / total


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "zamba2-1.2b"])
def test_fused_step_traces_on_small_mesh(small, arch):
    """Reduced config, fake (4, 2) mesh, batch 8, seq 32, split 1, two
    groups (the reference's ``DRYRUN_SMALL``): FLOPs > 0, useful ratio
    in (0, 1] once 6·N·D counts only the parameters the forward reads
    (zamba2's shared-attention blocks carry a third of its reduced
    parameters unread: its ratio on all of them is 1.07), collectives
    issued (the grouped batch moves over ``data``, partial sums over
    ``model``)."""
    from repro_torch.configs import make_reduced
    r = small[arch]
    assert REF_KEYS <= set(r)
    live = _live_share(make_reduced(get_config(arch)))
    assert r["hlo_flops"] > 0 and 0 < r["useful_ratio"] * live <= 1, r
    if arch == "internlm2-1.8b":
        assert live == 1.0
    assert r["chips"] == 8 and r["mesh"] == {"data": 4, "model": 2}
    assert r["coll_bytes"] > 0 and r["coll_counts"]["all-gather"] > 0
    assert r["argument_bytes"] > 0 and r["peak_bytes"] > r["argument_bytes"]


# (arch, shape) -> (layers, the repair it fails without on torch 2.13).
# Each pair failed at the parent of these repairs. The SSD scan's local
# run, the decode's scores over a head-dim-sharded cache, the whole batch
# before the balance permutation and the embedding reduced before the
# frontend's ``cat`` fail without them only on torch 2.11, where the
# card's host runs them (chip_smoke's dryrun phase, the matrix). Here
# internlm2's decode needs q's heads whole or those scores, and
# h2o-danube's long_500k needs q's heads whole.
PRODUCTION = {
    # the shard-local MoE dispatch: tokens pinned to the batch layout
    # around its reshapes (``moe._rows_of``)
    ("deepseek-v2-lite-16b", "train_4k"): (2, "moe dispatch"),
    # six layers reach the shared attention block, whose products
    # flatten batch and heads, both sharded (a strided shard): DTensor's
    # planning runs outside the fake mode (``hlo.local_ops_only``)
    ("zamba2-1.2b", "train_4k"): (6, "strided shards"),
    ("internlm2-1.8b", "train_4k"): (2, "the dense train step"),
    # q's 16 heads over model = 16 with 8 kv heads: the attention runs on
    # each rank's heads (``attention.grouped_attention``); the caches'
    # fills are constants (``transformer.cache_fill``), not ``.item()``
    ("internlm2-1.8b", "prefill_32k"): (2, "attention heads, cache fills"),
    # decode caches sharded over the head dim (8 kv heads, model 16):
    # q's heads whole or the scores over the head dim
    ("internlm2-1.8b", "decode_32k"): (2, "head-dim caches"),
    # a window's slot positions are a DTensor: masks out of place; q's
    # 32 heads made whole over the caches sharded on the sequence
    ("h2o-danube-3-4b", "long_500k"): (2, "window masks, whole q heads"),
}

PROD = """
import dataclasses, json
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
mesh = dryrun.production_mesh(device="cpu")
out = {}
for (arch, shape), layers in %r:
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, n_layers=layers,
                              block_pattern=cfg.block_pattern[:layers],
                              ffn_pattern=cfg.ffn_pattern[:layers])
    try:
        out[arch + "|" + shape] = dryrun.dryrun_step(
            cfg, mesh, shape, device="cpu", verbose=False)
    except Exception as e:
        out[arch + "|" + shape] = {"error": repr(e)[:2000]}
try:
    dryrun.start_fake_group(512)
    out["other world"] = "joined"
except RuntimeError as e:
    out["other world"] = str(e)
print("RESULT " + json.dumps(out, default=str))
""" % ([(pair, layers) for pair, (layers, _) in PRODUCTION.items()],)


@pytest.fixture(scope="module")
def production():
    return _traced(PROD)


@pytest.mark.parametrize("pair", list(PRODUCTION),
                         ids=["-".join(p) for p in PRODUCTION])
def test_step_traces_on_the_production_mesh(production, pair):
    """Full width, two layers (six for zamba2), the (16, 16) mesh of a
    fake 256-rank group: the trace completes and its record has every
    key of the reference's, with nonzero FLOPs, bytes and peak; a train
    step moves bytes between ranks."""
    r = production["|".join(pair)]
    assert "error" not in r, r
    assert REF_KEYS <= set(r)
    assert r["chips"] == 256 and r["mesh"] == {"data": 16, "model": 16}
    assert r["hlo_flops"] > 0 and r["hlo_bytes"] > 0 and r["peak_bytes"] > 0
    assert r["flops_estimated"] is False and r["compile_s"] == 0.0
    assert r["bytes_per_device"] == r["peak_bytes"] - r["argument_bytes"]
    assert r["dominant"] in ("compute", "memory", "collective")
    if pair[1] == "train_4k":
        assert r["coll_bytes"] > 0
        # the new params are the arguments' shards, less the batch
        assert 0 < r["output_bytes"] <= r["argument_bytes"]


def test_one_world_size_a_process(production):
    assert "fake group of 512" in production["other world"]


def test_cache_fills_are_init_caches_values():
    """``cache_fill`` names the one value of each ``init_caches`` leaf,
    for every LM config (the prefill builder fills caches from it)."""
    for name in list_configs():
        cfg = get_config(name)
        if isinstance(cfg, CNNConfig):
            continue
        for layer in tf.init_caches(cfg, 2, 8, device="cpu"):
            for k, t in layer.items():
                assert bool((t == tf.cache_fill(k)).all()), (name, k)


def test_cli_reports_a_failed_pair_and_exits_1(tmp_path, capsys):
    """A pair that fails is an error record (written to ``--json``) and
    the run exits 1; a shape that does not apply is a skip record."""
    out = tmp_path / "o.json"
    assert dryrun.main(["--device", "cpu", "--arch", "no-such-arch",
                        "--shape", "train_4k", "--json", str(out)]) == 1
    recs = json.loads(out.read_text())
    assert len(recs) == 1 and "error" in recs[0]
    assert "FAILED" in capsys.readouterr().err
    assert dryrun.main(["--device", "cpu", "--arch", "internlm2-1.8b",
                        "--shape", "long_500k", "--json", str(out)]) == 0
    assert json.loads(out.read_text())[0]["skipped"] is True


def test_cli_defaults_to_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun.main(["--arch", "internlm2-1.8b", "--shape", "decode_32k"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun.dryrun_one("internlm2-1.8b", "decode_32k")


def test_lm_archs_are_the_references():
    """``--all`` walks the same 10 LM configs, 34 applicable pairs."""
    from repro_torch.launch.steps import SHAPES, shape_applicable
    archs = dryrun.lm_archs()
    assert len(archs) == 10
    assert sum(shape_applicable(get_config(a), s)
               for a in archs for s in SHAPES) == 34
