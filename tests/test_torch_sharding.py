"""The port's sharding rules (``repro_torch.models.sharding``) against the
reference's (``repro.models.sharding``), entry for entry, on stand-in
meshes of the production sizes (16 x 16 and 2 x 16 x 16): a stand-in
needs only the axis names and sizes, so no 256 ranks are needed (the
reference's own tests do the same, ``tests/test_sharding_dryrun.py``).
Also the counterparts of that file's divisibility and kimi tests, the
batch and cache specs, the placements a spec maps to, and the abstract
params."""
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

from repro.configs import get_config as ref_get_config
from repro.models import sharding as ref_sharding
from repro.models import transformer as ref_tf
from repro.models.params import abstract_params as ref_abstract_params
from repro_torch.configs import get_config, list_configs
from repro_torch.configs.base import CNNConfig
from repro_torch.models import sharding
from repro_torch.models import transformer as tf
from repro_torch.models.params import abstract_params
from repro_torch.utils.tree import tree_leaves

LM_CONFIGS = [n for n in list_configs()
              if not isinstance(get_config(n), CNNConfig)]


class StandInMesh:
    """Axis names and sizes, as both packages' spec functions read them
    (the reference: ``axis_names`` / ``devices.shape``; the port:
    ``mesh_dim_names`` / ``shape``)."""

    def __init__(self, names, shape):
        self.axis_names = self.mesh_dim_names = tuple(names)
        self.shape = tuple(shape)

        class _D:
            pass
        self.devices = _D()
        self.devices.shape = self.shape


MESHES = {"16x16": StandInMesh(("data", "model"), (16, 16)),
          "2x16x16": StandInMesh(("pod", "data", "model"), (2, 16, 16))}


def _ref_leaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, P))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", LM_CONFIGS)
def test_param_specs_equal_reference(arch, mesh):
    m = MESHES[mesh]
    ref = _ref_leaves(ref_sharding.model_param_specs(ref_get_config(arch), m))
    port = tree_leaves(sharding.model_param_specs(get_config(arch), m),
                       is_leaf=sharding.is_spec)
    assert len(ref) == len(port) > 0
    assert [tuple(r) for r in ref] == port


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "kimi-k2-1t-a32b",
                                  "mamba2-2.7b", "internvl2-1b",
                                  "gemma3-27b"])
def test_param_specs_divisible(arch):
    """Each mesh axis is claimed at most once a param, and a claimed dim
    divides by the axis's size."""
    from repro_torch.models.params import is_def
    cfg = get_config(arch)
    defs = tree_leaves(tf.model_defs(cfg), is_leaf=is_def)
    specs = tree_leaves(sharding.model_param_specs(cfg, MESHES["16x16"]),
                        is_leaf=sharding.is_spec)
    assert len(defs) == len(specs)
    for d, s in zip(defs, specs):
        used = [ax for ax in s if ax is not None]
        assert len(used) == len(set(used)), (d, s)
        for dim, ax in zip(d.shape, s):
            if ax in ("model", "data"):
                assert dim % 16 == 0, (d, s)


def test_kimi_experts_sharded_two_axes():
    """The 1T MoE shards experts over ``model`` and expert ff over
    ``data`` (fsdp_ff), or it cannot fit 256 chips."""
    cfg = get_config("kimi-k2-1t-a32b")
    specs = sharding.model_param_specs(cfg, MESHES["16x16"])
    moe_spec = specs["blocks"][1]["ffn"]["w_gate"]
    assert moe_spec[0] == "model" and "data" in moe_spec, moe_spec


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("ndim,batch", [(2, 256), (3, 32), (2, 128), (2, 1),
                                        (3, 1), (2, None), (1, 24)])
def test_batch_spec_equals_reference(mesh, ndim, batch):
    m = MESHES[mesh]
    want = tuple(ref_sharding.batch_spec(m, ndim, batch_size=batch))
    got = sharding.batch_spec(m, ndim, batch_size=batch)
    assert got == want
    if batch == 1:                        # falls back to replicated
        assert got == (None,) * ndim


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ["zamba2-1.2b", "internlm2-1.8b",
                                  "deepseek-v2-lite-16b", "gemma3-27b",
                                  "mamba2-2.7b", "h2o-danube-3-4b"])
def test_cache_specs_equal_reference(arch, shape, mesh):
    """Decode caches: batch over the data axes, or at batch 1 the
    sequence dim (long context); kv heads / head_dim / latent rank over
    ``model``; window positions and SSM states small."""
    from repro.launch.steps import SHAPES
    m = MESHES[mesh]
    batch, seq = SHAPES[shape]["batch"], SHAPES[shape]["seq"]
    rcfg, cfg = ref_get_config(arch), get_config(arch)
    ref_abs = jax.eval_shape(functools.partial(ref_tf.init_caches, rcfg,
                                               batch, seq))
    port_abs = tf.init_caches(cfg, batch, seq, device="meta")
    ref = ref_sharding.cache_specs(rcfg, m, ref_abs, batch)
    port = sharding.cache_specs(cfg, m, port_abs, batch)
    assert len(ref) == len(port) == cfg.n_layers
    for r, p in zip(ref, port):
        assert sorted(r) == sorted(p)
        assert {k: tuple(v) for k, v in r.items()} == p
    if batch == 1:
        seq_sharded = [sp for layer in port for k, sp in layer.items()
                       if k in ("k", "v", "latent")]
        dp = sharding.data_axes(m)
        assert bool(seq_sharded) == (cfg.arch_type != "ssm")
        assert all(sp[1] == (dp if len(dp) > 1 else dp[0])
                   for sp in seq_sharded)


def test_spec_to_placements():
    """Each mesh dim a tensor dim names becomes ``Shard(dim)`` there, the
    others ``Replicate()``; a tensor dim over two mesh dims is sharded
    on both; a mesh dim of one rank replicates."""
    m2, m3 = MESHES["16x16"], MESHES["2x16x16"]
    assert sharding.to_placements(("data", None, "model"), m2) == [
        Shard(0), Shard(2)]
    assert sharding.to_placements((None, None), m2) == [Replicate()] * 2
    assert sharding.to_placements((("pod", "data"), None), m3) == [
        Shard(0), Shard(0), Replicate()]
    assert sharding.to_placements((), m3) == [Replicate()] * 3
    with pytest.raises(ValueError, match="claimed twice"):
        sharding.to_placements(("model", "model"), m2)
    one = StandInMesh(("data", "model"), (4, 1))      # one rank holds all
    assert sharding.to_placements(("data", "model"), one) == [
        Shard(0), Replicate()]
    assert sharding.data_axes(m3) == ("pod", "data")
    assert sharding.data_shards(m3) == 32


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "gemma3-27b",
                                  "deepseek-v2-lite-16b"])
def test_abstract_params_equal_reference(arch):
    """Meta tensors with the reference's ShapeDtypeStructs' shapes and
    dtypes (gemma3 keeps bf16 params), no storage."""
    rcfg, cfg = ref_get_config(arch), get_config(arch)
    ref = jax.tree.leaves(ref_abstract_params(ref_tf.model_defs(rcfg),
                                              rcfg.param_dtype))
    port = tree_leaves(abstract_params(tf.model_defs(cfg), cfg.param_dtype))
    assert len(ref) == len(port)
    for r, p in zip(ref, port):
        assert p.device.type == "meta"
        assert tuple(p.shape) == r.shape
        assert str(p.dtype).split(".")[-1] == np.dtype(r.dtype).name
