"""The port's step builders (``repro_torch.launch.steps``) and meshes
(``repro_torch.launch.mesh``) against the reference's: the four shapes,
which apply to which config, the default split, the abstract inputs
(shapes and dtypes, decode caches and the frontend prefix included), the
config the train step runs, and the builders' placements -- all on
stand-in meshes of the production sizes, which need no ranks."""
import dataclasses

import jax
import numpy as np
import pytest
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.placement_types import Placement

import repro.launch.steps as ref_steps
from repro.configs import get_config as ref_get_config
from repro_torch.configs import get_config, list_configs
from repro_torch.configs.base import CNNConfig
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import steps
from repro_torch.models import sharding
from repro_torch.utils.tree import tree_leaves

from test_torch_sharding import MESHES

LM_CONFIGS = [n for n in list_configs()
              if not isinstance(get_config(n), CNNConfig)]


def test_shapes_equal_reference():
    assert steps.SHAPES == ref_steps.SHAPES
    assert steps.DEFAULT_GROUPS == ref_steps.DEFAULT_GROUPS


@pytest.mark.parametrize("arch", LM_CONFIGS)
def test_shape_applicable_and_default_split_equal_reference(arch):
    rcfg, cfg = ref_get_config(arch), get_config(arch)
    for shape in steps.SHAPES:
        assert steps.shape_applicable(cfg, shape) == \
            ref_steps.shape_applicable(rcfg, shape)
    assert steps.long_context_ok(cfg) == ref_steps.long_context_ok(rcfg)
    assert steps.default_split(cfg) == ref_steps.default_split(rcfg)


@pytest.mark.parametrize("shape", list(steps.SHAPES))
@pytest.mark.parametrize("arch", LM_CONFIGS)
def test_input_specs_equal_reference(arch, shape):
    ref = ref_steps.input_specs(ref_get_config(arch), shape)
    port = steps.input_specs(get_config(arch), shape)
    assert sorted(ref) == sorted(port)
    ref_leaves = jax.tree.leaves(ref)
    port_leaves = tree_leaves(port)
    assert len(ref_leaves) == len(port_leaves) > 0
    for r, p in zip(ref_leaves, port_leaves):
        assert p.device.type == "meta"
        assert tuple(p.shape) == r.shape
        assert str(p.dtype).split(".")[-1] == np.dtype(r.dtype).name
    if steps.SHAPES[shape]["kind"] != "decode":
        assert ("prefix" in port) == bool(get_config(arch).frontend)


class _Captured(Exception):
    pass


def _captured_train_args(module, cfg, mesh, monkeypatch, **kw):
    """The arguments ``build_train_step`` hands to
    ``make_s2fl_train_step`` (the config it runs included)."""
    seen = {}

    def capture(cfg, split, n_groups, lr, dp_axes=None, group_members=1):
        seen.update(cfg=cfg, split=split, n_groups=n_groups, lr=lr,
                    dp_axes=tuple(dp_axes), group_members=group_members)
        raise _Captured
    monkeypatch.setattr(module, "make_s2fl_train_step", capture)
    with pytest.raises(_Captured):
        module.build_train_step(cfg, mesh, **kw)
    return seen


FIELDS = ("remat", "remat_policy", "scan_layers", "moe_dispatch_shards",
          "moe_dispatch_axes")


@pytest.mark.parametrize("kw", [{}, {"remat_policy": "dots"},
                                {"scan_layers": False, "n_groups": 2},
                                {"remat": False, "split": 3}])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "deepseek-v2-lite-16b",
                                  "kimi-k2-1t-a32b", "zamba2-1.2b"])
def test_build_train_step_config_equals_reference(arch, mesh, kw,
                                                  monkeypatch):
    """remat forced (unless asked off), remat_policy / scan_layers
    carried, MoE dispatch shard-local over the data axes, the default
    split, the groups and ``group_members`` -- as the reference's."""
    m = MESHES[mesh]
    ref = _captured_train_args(ref_steps, ref_get_config(arch), m,
                               monkeypatch, **kw)
    port = _captured_train_args(steps, get_config(arch), m, monkeypatch,
                                **kw)
    port_cfg, ref_cfg = port.pop("cfg"), ref.pop("cfg")
    assert {f: getattr(port_cfg, f) for f in FIELDS} == \
        {f: getattr(ref_cfg, f) for f in FIELDS}
    assert port == ref


def _is_placements(x) -> bool:
    return isinstance(x, list) and bool(x) and all(
        isinstance(p, Placement) for p in x)


def test_builders_placements_and_abstract_args():
    """The builders' placements follow the specs on the mesh: params by
    ``model_param_specs``, the batch over the data axes (perm and the
    decode index replicated), caches by ``cache_specs``; the abstract
    args are the input specs and the abstract params."""
    cfg, m = get_config("zamba2-1.2b"), MESHES["16x16"]
    pspecs = sharding.model_param_specs(cfg, m)
    want_params = [sharding.to_placements(s, m) for s in
                   tree_leaves(pspecs, is_leaf=sharding.is_spec)]

    _, (ppl, bpl), (opl, lpl), (pabs, babs) = steps.build_train_step(cfg, m)
    assert tree_leaves(ppl, is_leaf=_is_placements) == want_params
    assert bpl["perm"] == [Replicate(), Replicate()]
    assert bpl["tokens"] == bpl["labels"] == [Shard(0), Replicate()]
    assert lpl == [Replicate(), Replicate()] and opl is ppl
    assert sorted(babs) == ["labels", "perm", "tokens"]
    assert len(tree_leaves(pabs)) == len(want_params)

    _, (_, bpl), (lg, cpl), (_, babs) = steps.build_prefill_step(cfg, m)
    assert bpl == {"tokens": [Shard(0), Replicate()]}
    assert lg == [Shard(0), Replicate()]
    assert tuple(babs["tokens"].shape) == (32, 32768)
    kv = cpl[cfg.pattern().index(("shared_attn", "dense"))]
    assert kv["k"] == [Shard(0), Shard(2)]          # batch, kv heads

    _, (_, bpl), _, (_, babs) = steps.build_step(cfg, m, "long_500k")
    assert bpl["index"] == [Replicate(), Replicate()]
    assert bpl["token"] == [Replicate(), Replicate()]        # batch 1
    kv = bpl["caches"][cfg.pattern().index(("shared_attn", "dense"))]
    assert kv["k"] == [Shard(1), Shard(2)]          # sequence, kv heads
    assert tuple(babs["caches"][0]["state"].shape)[0] == 1


def test_production_mesh_needs_its_world_size():
    """Without a process group of 256 (512) ranks the production mesh
    raises, naming the world size it needs; a host mesh needs a group."""
    with pytest.raises(RuntimeError, match="world size 256"):
        mesh_mod.make_production_mesh()
    with pytest.raises(RuntimeError, match="world size 512"):
        mesh_mod.make_production_mesh(multi_pod=True)
    with pytest.raises(RuntimeError, match="process group"):
        mesh_mod.make_host_mesh(2, 1, device="cpu")


def test_train_config_is_the_reference_replacement():
    """``train_config`` alone: a dense config gains remat; an MoE config
    keeps its remat and gains shard-local dispatch; a config with the
    dispatch set keeps it."""
    m = MESHES["2x16x16"]
    dense = steps.train_config(get_config("internlm2-1.8b"), m)
    assert dense.remat and not dense.moe_dispatch_shards
    moe = steps.train_config(get_config("deepseek-v2-lite-16b"), m)
    assert moe.moe_dispatch_shards == 32
    assert moe.moe_dispatch_axes == ("pod", "data")
    preset = dataclasses.replace(get_config("deepseek-v2-lite-16b"),
                                 moe_dispatch_shards=4)
    assert steps.train_config(preset, m).moe_dispatch_shards == 4
