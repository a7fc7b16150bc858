"""BENCHMARK.json against the benchmark's contract, and the harness
finding each cell's configuration, traffic mix, limits and per-layer
readers by name (CPU, no card)."""
import json
import re

import pytest

from portbench import cell as cell_mod

SPEC = cell_mod.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
WORKLOADS = [w["name"] for w in SPEC["workloads"]]
CATALOG_DEEPSEEK = {
    "attention_bias": False, "first_k_dense_replace": 1,
    "hidden_act": "silu", "hidden_size": 2048, "intermediate_size": 10944,
    "kv_lora_rank": 512, "max_position_embeddings": 163840,
    "model_type": "deepseek_v2", "moe_intermediate_size": 1408,
    "moe_layer_freq": 1, "n_group": 1, "n_routed_experts": 64,
    "n_shared_experts": 2, "norm_topk_prob": False,
    "num_attention_heads": 16, "num_experts_per_tok": 6,
    "num_hidden_layers": 27, "num_key_value_heads": 16,
    "q_lora_rank": None, "qk_nope_head_dim": 128, "qk_rope_head_dim": 64,
    "rms_norm_eps": 1e-06, "rope_theta": 10000, "routed_scaling_factor": 1,
    "scoring_func": "softmax", "seq_aux": True, "tie_word_embeddings": False,
    "topk_group": 1, "topk_method": "greedy", "v_head_dim": 128,
    "vocab_size": 102400,
    "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40,
                     "mscale": 0.707, "mscale_all_dim": 0.707,
                     "original_max_position_embeddings": 4096,
                     "type": "yarn"}}


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w
               for w in SPEC["command"])
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_units_and_entry_keys():
    names = set()
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])


def test_every_cell_reports_setup_another_e2e_and_a_layer_metric():
    for w in WORKLOADS:
        c = cell_mod.find_cell(w)
        names = {m["name"] for m in c.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert c.per_layer
        for m in c.per_layer:
            assert m["moves"] in names


@pytest.mark.parametrize("workload", WORKLOADS)
def test_harness_finds_the_cell_by_name(workload):
    c = cell_mod.find_cell(workload)
    cfg = c.build_config()
    assert cfg.n_layers == c.sizes["num_hidden_layers"]
    assert cfg.d_model == c.sizes["hidden_size"]
    assert c.driver().run
    for m in c.per_layer:
        assert callable(cell_mod.metric_reader(m["name"]))
    assert c.limits and all(v >= 0 for v in c.limits.values())


def test_config_files_hold_the_source_numbers():
    for c in SPEC["configs"]:
        assert c["file"].startswith("portbench/configs/")
        with open(cell_mod.ROOT / c["file"]) as f:
            sizes = json.load(f)
        if c["name"] == "deepseek-v2-lite-16b":
            for k, v in CATALOG_DEEPSEEK.items():
                if k not in c["reduced"]:
                    assert sizes[k] == v, k
            assert sizes["source"] == c["source"]


def test_no_width_changes_inside_a_listed_group():
    """A group in ``reduced`` keeps the source's keys, and its widths
    (``*_dim``, ``*_rank``, ``*_size``) as published."""
    with open(cell_mod.HERE / "configs" / "deepseek-v2-lite-16b.json") as f:
        sizes = json.load(f)
    for k, group in CATALOG_DEEPSEEK.items():
        if isinstance(group, dict):
            assert set(sizes[k]) == set(group), k
            for sub, v in group.items():
                if sub.endswith(("_dim", "_rank", "_size")):
                    assert sizes[k][sub] == v, (k, sub)


@pytest.mark.parametrize("factor,refused", [(1, False), (40, True)])
def test_rope_scaling_is_held_to_plain_rotary(factor, refused):
    c = cell_mod.find_cell("prefill.deepseek-v2-lite-16b.f32w.b8x2048")
    sizes = dict(c.sizes, rope_scaling=dict(c.sizes["rope_scaling"],
                                            factor=factor))
    if refused:
        with pytest.raises(ValueError):
            cell_mod.build_config(c.config, sizes)
    else:
        assert cell_mod.build_config(c.config, sizes).rope_theta == 10000


@pytest.mark.parametrize("key,value", [
    ("hidden_size", 1024), ("num_key_value_heads", 16),
    ("num_hidden_layers", 23)])
def test_a_config_that_departs_from_its_source_is_refused(key, value):
    sizes = dict(cell_mod.find_cell(WORKLOADS[-1]).sizes, **{key: value})
    with pytest.raises(ValueError):
        cell_mod.build_config("internlm2-1.8b", sizes)


def test_the_config_runs_in_its_stated_dtypes():
    for w in WORKLOADS:
        c = cell_mod.find_cell(w)
        cfg = c.build_config()
        assert cfg.dtype == c.sizes["run_as"]["activations"]
        assert cfg.param_dtype == c.sizes["run_as"]["params"]
        assert cfg.norm_eps == c.sizes["rms_norm_eps"]


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        cell_mod.find_cell("no.such.cell")
