"""Step builders + abstract input specs for every (arch x input shape).

Shapes (assigned):
  train_4k     seq 4,096   global_batch 256   -> fused S²FL round step
  prefill_32k  seq 32,768  global_batch 32    -> prefill (cache build)
  decode_32k   seq 32,768  global_batch 128   -> one-token serve step
  long_500k    seq 524,288 global_batch 1     -> one-token serve step
                                                 (sub-quadratic archs only)

Each builder returns ``(step, in_placements, out_placements,
abstract_args)``: the step function, the DTensor placements of its
arguments and results on ``mesh`` (trees of placement lists, from the
sharding specs), and its arguments as tensors on the ``meta`` device.
The steps take and return DTensors laid out so (``shard_params``,
``distribute_tensor``); plain tensors the model makes on the way count
as replicated.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.round_step import (make_s2fl_train_step,
                                         train_step_shardings)
from repro_torch.core.split import default_plan
from repro_torch.models import transformer as tf_mod
from repro_torch.models.frontends import frontend_embed_shape
from repro_torch.models.params import DTYPES, abstract_params
from repro_torch.models.sharding import (batch_spec, cache_specs, data_axes,
                                        data_shards, map_specs,
                                        model_param_specs, placements_of,
                                        to_placements)

SHAPES = {
    "train_4k": {"seq": 4096, "batch": 256, "kind": "train"},
    "prefill_32k": {"seq": 32768, "batch": 32, "kind": "prefill"},
    "decode_32k": {"seq": 32768, "batch": 128, "kind": "decode"},
    "long_500k": {"seq": 524288, "batch": 1, "kind": "decode"},
}

# S²FL defaults at pod scale: 16 cohorts (one per data shard), 4 balance
# groups, one of the plan's split points.
DEFAULT_GROUPS = 4


def long_context_ok(cfg) -> bool:
    """long_500k runs for SSM/hybrid and sliding-window dense archs; pure
    full-attention archs are skipped."""
    return cfg.arch_type in ("ssm", "hybrid") or cfg.sliding_window > 0


def shape_applicable(cfg, shape: str) -> bool:
    if shape == "long_500k":
        return long_context_ok(cfg)
    return True


def default_split(cfg) -> int:
    return default_plan(cfg.n_layers).split_points[-1]


# ---------------------------------------------------------------------------
# abstract inputs (meta tensors)
# ---------------------------------------------------------------------------
def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _prefix(cfg, batch: int):
    return _meta(frontend_embed_shape(cfg, batch), DTYPES[cfg.dtype])


def train_inputs(cfg, *, batch: int, seq: int):
    specs = {"tokens": _meta((batch, seq), torch.int32),
             "labels": _meta((batch, seq), torch.int32),
             "perm": _meta((batch,), torch.int32)}
    if cfg.frontend:
        specs["prefix"] = _prefix(cfg, batch)
    return specs


def prefill_inputs(cfg, *, batch: int, seq: int):
    specs = {"tokens": _meta((batch, seq), torch.int32)}
    if cfg.frontend:
        specs["prefix"] = _prefix(cfg, batch)
    return specs


def decode_inputs(cfg, *, batch: int, seq: int):
    return {"token": _meta((batch, 1), torch.int32),
            "index": _meta((), torch.int32),
            "caches": tf_mod.init_caches(cfg, batch, seq, device="meta")}


def input_specs(cfg, shape: str, *, batch=None, seq=None):
    """The shape's abstract inputs; ``batch`` / ``seq`` in place of the
    shape's global batch and sequence (a step cut to fit one card)."""
    s = SHAPES[shape]
    fn = {"train": train_inputs, "prefill": prefill_inputs,
          "decode": decode_inputs}[s["kind"]]
    return fn(cfg, batch=batch or s["batch"], seq=seq or s["seq"])


def abstract_model_params(cfg):
    return abstract_params(tf_mod.model_defs(cfg), cfg.param_dtype)


# ---------------------------------------------------------------------------
# step builders
# ---------------------------------------------------------------------------
def train_config(cfg, mesh, *, remat: bool = True, scan_layers=None,
                 remat_policy=None):
    """The config the train step runs: remat forced (unless ``remat`` is
    False), and for MoE shard-local dispatch over the data axes."""
    repl = {}
    if remat and not cfg.remat:
        repl["remat"] = True
    if scan_layers is not None and scan_layers != cfg.scan_layers:
        repl["scan_layers"] = scan_layers
    if remat_policy is not None:
        repl["remat_policy"] = remat_policy
    if cfg.n_experts and not cfg.moe_dispatch_shards:
        repl["moe_dispatch_shards"] = data_shards(mesh)
        repl["moe_dispatch_axes"] = tuple(data_axes(mesh))
    return dataclasses.replace(cfg, **repl) if repl else cfg


def build_train_step(cfg, mesh, *, split=None, n_groups: int = DEFAULT_GROUPS,
                     lr: float = 0.01, shape: str = "train_4k",
                     remat: bool = True, scan_layers=None,
                     remat_policy=None, batch=None, seq=None):
    """The fused S²FL round step over ``mesh``; ``scan_layers`` is carried
    into the config and not read (an XLA compile-time knob). ``batch`` /
    ``seq``: as in ``input_specs``."""
    cfg = train_config(cfg, mesh, remat=remat, scan_layers=scan_layers,
                       remat_policy=remat_policy)
    split = split if split is not None else default_split(cfg)
    step = make_s2fl_train_step(
        cfg, split, n_groups, lr, dp_axes=data_axes(mesh),
        group_members=max(1, data_shards(mesh) // n_groups))
    batch_abs = input_specs(cfg, shape, batch=batch, seq=seq)
    in_pl, out_pl = train_step_shardings(cfg, mesh, batch_abs)
    return step, in_pl, out_pl, (abstract_model_params(cfg), batch_abs)


def _batch_placements(mesh, batch_abs: dict) -> dict:
    return {k: to_placements(batch_spec(mesh, v.ndim,
                                        batch_size=v.shape[0]), mesh)
            for k, v in batch_abs.items()}


def _index(i) -> int:
    """The decode position, from an int or a 0-dim (D)Tensor."""
    if hasattr(i, "full_tensor"):
        i = i.full_tensor()
    return int(i)


def _new_caches(cfg, mesh, cspecs, batch: int, max_len: int):
    """``init_caches`` laid out by ``cspecs`` on ``mesh``, each rank
    making only its own shards. Each leaf is one constant
    (``cache_fill``), so no tensor is read here: the step also runs on
    fake tensors."""
    from torch.distributed.tensor import full
    shapes = tf_mod.init_caches(cfg, batch, max_len, device="meta")
    return [{k: full(tuple(m.shape), tf_mod.cache_fill(k), dtype=m.dtype,
                     device_mesh=mesh,
                     placements=to_placements(specs[k], mesh))
             for k, m in layer.items()}
            for layer, specs in zip(shapes, cspecs)]


def build_prefill_step(cfg, mesh, *, shape: str = "prefill_32k",
                       max_len=None, batch=None, seq=None):
    """Prefill a prompt of the shape's batch and seq into caches of
    ``max_len`` (the seq, plus the frontend's prefix) laid out by
    ``cache_specs`` on ``mesh``. A decode shape gives the prefill that
    builds its caches. ``batch`` / ``seq``: as in ``input_specs``."""
    s = SHAPES[shape]
    batch, seq = batch or s["batch"], seq or s["seq"]
    # modality prefix tokens occupy cache slots too
    max_len = max_len or (seq + (cfg.n_frontend_tokens if cfg.frontend
                                 else 0))
    caches_abs = tf_mod.init_caches(cfg, batch, max_len, device="meta")
    cspecs = cache_specs(cfg, mesh, caches_abs, batch)

    def step(params, batch_in):
        from torch.distributed.tensor.experimental import (
            implicit_replication)
        tokens = batch_in["tokens"]
        caches = _new_caches(cfg, mesh, cspecs, tokens.shape[0], max_len)
        with implicit_replication():
            logits, caches, _ = tf_mod.prefill(cfg, params, tokens, max_len,
                                               batch_in.get("prefix"),
                                               caches=caches)
        return logits, caches

    batch_abs = prefill_inputs(cfg, batch=batch, seq=seq)
    pspecs = placements_of(model_param_specs(cfg, mesh), mesh)
    out_pl = (to_placements(batch_spec(mesh, 3, batch_size=batch), mesh),
              placements_of(cspecs, mesh))
    return (step, (pspecs, _batch_placements(mesh, batch_abs)), out_pl,
            (abstract_model_params(cfg), batch_abs))


def build_decode_step(cfg, mesh, *, shape: str = "decode_32k", batch=None,
                      seq=None):
    """One decode step; the caches are updated in place and returned.
    ``batch`` / ``seq`` (the caches' length): as in ``input_specs``."""
    s = SHAPES[shape]
    batch = batch or s["batch"]

    def step(params, batch_in):
        from torch.distributed.tensor.experimental import (
            implicit_replication)
        with implicit_replication():
            return tf_mod.decode_step(cfg, params, batch_in["token"],
                                      batch_in["caches"],
                                      _index(batch_in["index"]))

    batch_abs = input_specs(cfg, shape, batch=batch, seq=seq)
    pspecs = placements_of(model_param_specs(cfg, mesh), mesh)
    cpl = placements_of(cache_specs(cfg, mesh, batch_abs["caches"], batch),
                        mesh)
    in_batch = {
        "token": to_placements(batch_spec(mesh, 2, batch_size=batch), mesh),
        "index": to_placements((), mesh),
        "caches": cpl,
    }
    out_pl = (to_placements(batch_spec(mesh, 3, batch_size=batch), mesh), cpl)
    return (step, (pspecs, in_batch), out_pl,
            (abstract_model_params(cfg), batch_abs))


def build_step(cfg, mesh, shape: str, **kw):
    kind = SHAPES[shape]["kind"]
    if kind == "train":
        return build_train_step(cfg, mesh, shape=shape, **kw)
    if kind == "prefill":
        return build_prefill_step(cfg, mesh, shape=shape, **kw)
    return build_decode_step(cfg, mesh, shape=shape, **kw)
