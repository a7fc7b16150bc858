"""A cell of ``BENCHMARK.json`` and what one run of it gives back.

A cell is found by name: its entry in ``workloads`` names the
configuration (``configs/<config>.json``: the source's numbers, the
name of the port's config they are held to under ``port_config``, and
the dtypes it runs in under ``run_as``) and the traffic mix
(``traffic/<mix>.json``, whose ``kind`` names its module in
``drivers/``); ``limits/<workload>.json`` holds the limits of the numbers
its ``correct`` compares; each per-layer metric is read by
``metrics/<metric>.py``.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_module(path: Path, name: str):
    """Import the file at ``path`` under the module name ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    workload: str
    config: str
    traffic: str
    chips: int
    sizes: dict              # configs/<config>.json
    mix: dict                # traffic/<traffic>.json
    limits: dict             # limits/<workload>.json
    end_to_end: list         # this cell's end-to-end metric entries
    per_layer: list          # this cell's per-layer metric entries

    def build_config(self):
        """The port's config, as ``configs/<config>.json`` states it."""
        return build_config(self.config, self.sizes)

    def driver(self):
        return importlib.import_module(
            f"portbench.drivers.{self.mix['kind']}")


# the source's keys (Hugging Face names) -> the port's ModelConfig fields
# that hold them; a key the source leaves null reads as 0
HELD = {"num_hidden_layers": "n_layers", "hidden_size": "d_model",
        "intermediate_size": "d_ff", "num_attention_heads": "n_heads",
        "head_dim": "head_dim", "vocab_size": "vocab_size",
        "tie_word_embeddings": "tie_embeddings",
        "kv_lora_rank": "kv_lora_rank", "q_lora_rank": "q_lora_rank",
        "qk_nope_head_dim": "qk_nope_head_dim",
        "qk_rope_head_dim": "qk_rope_head_dim", "v_head_dim": "v_head_dim",
        "n_shared_experts": "n_shared_experts",
        "num_experts_per_tok": "top_k", "moe_intermediate_size": "moe_d_ff"}
# keys the port's config takes from the source as given
TAKEN = {"rms_norm_eps": "norm_eps", "rope_theta": "rope_theta"}


def build_config(name: str, sizes: dict):
    """The port's config ``sizes["port_config"]`` in the dtypes of
    ``sizes["run_as"]``, with the source's norm epsilon and rotary base,
    checked against every number of the source it holds: the widths and
    depth above, grouped kv heads where attention is not latent, latent
    attention where the source has a kv rank, the dense layers before
    the first MoE layer, and plain rotary (the port scales no rotary:
    a ``rope_scaling`` group has to read as YaRN at factor 1)."""
    from repro_torch.configs import get_config
    rope_scaling = sizes.get("rope_scaling") or {}
    if rope_scaling.get("factor", 1) != 1:
        raise ValueError(f"{name}: the port applies plain rotary, not "
                         f"rope_scaling {rope_scaling}")
    run_as = sizes["run_as"]
    cfg = get_config(sizes["port_config"])
    cfg = dataclasses.replace(
        cfg, dtype=run_as["activations"], param_dtype=run_as["params"],
        **{f: type(getattr(cfg, f))(sizes[k]) for k, f in TAKEN.items()
           if k in sizes})
    want = {f: 0 if sizes[k] is None else sizes[k]
            for k, f in HELD.items() if k in sizes}
    want["mla"] = bool(sizes.get("kv_lora_rank"))
    if not want["mla"]:
        want["n_kv_heads"] = sizes["num_key_value_heads"]
    want["n_experts"] = sizes.get("n_routed_experts") or 0
    if want["n_experts"]:
        k, L = sizes["first_k_dense_replace"], sizes["num_hidden_layers"]
        want["ffn_pattern"] = ("dense",) * k + ("moe",) * (L - k)
    got = {f: getattr(cfg, f) for f in want}
    if got != want:
        raise ValueError(f"{name}: the port's config {got} is not the "
                         f"source's {want}")
    return cfg


def _reports(metric: dict, workload: str, e2e_of_cell) -> bool:
    if "workloads" in metric:
        return workload in metric["workloads"]
    return metric.get("moves") in e2e_of_cell if "moves" in metric else True


def find_cell(workload: str, spec: dict | None = None) -> Cell:
    spec = spec or benchmark()
    entry = next((w for w in spec["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; known: "
                       f"{[w['name'] for w in spec['workloads']]}")
    with open(HERE / "configs" / f"{entry['config']}.json") as f:
        sizes = json.load(f)
    with open(HERE / "traffic" / f"{entry['traffic']}.json") as f:
        mix = json.load(f)
    with open(HERE / "limits" / f"{workload}.json") as f:
        limits = json.load(f)
    e2e = [m for m in spec["end_to_end"] if _reports(m, workload, ())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if _reports(m, workload, names)]
    return Cell(workload=workload, config=entry["config"],
                traffic=entry["traffic"], chips=entry["chips"], sizes=sizes,
                mix=mix, limits=limits, end_to_end=e2e, per_layer=per_layer)


def metric_reader(name: str):
    """``read(run) -> float | None`` of ``metrics/<name>.py``."""
    return load_module(HERE / "metrics" / f"{name}.py",
                       "portbench_metric_" + re.sub(r"\W", "_", name)).read


@dataclasses.dataclass
class Check:
    """One number ``correct`` compares, beside its limit: the run is
    correct where every value is at most its limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclasses.dataclass
class Outcome:
    """What a driver's run gives back to ``run.py``."""
    e2e: dict                # end-to-end metric name -> value (host clock)
    setup_s: float
    attempted: int
    failed: int
    checks: list             # [Check]
    memory_peak_bytes: int
    trace: object = None     # tracing.Trace of the window (--trace 1)
    context: dict = dataclasses.field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c.ok for c in self.checks) \
            and self.failed == 0
