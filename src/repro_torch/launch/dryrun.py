"""Production-mesh dry-run: trace every (arch x input shape) step on the
production mesh and report its FLOPs, bytes, collectives and memory per
rank, and the roofline terms they give on an H100.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu \\
      --arch internlm2-1.8b --shape train_4k [--multi-pod] [--all] \\
      [--json out.json]

The reference lowers and compiles each step for 512 fake XLA host
devices and reads XLA's analyses. Here one process joins a fake process
group (``torch.distributed``'s ``fake`` backend: collectives that move
nothing) of 256 ranks, or 512 with ``--multi-pod``, as rank 0, builds
the (16, 16) or (2, 16, 16) mesh on it, and runs the step once on fake
tensors (``FakeTensorMode``: shapes, dtypes and devices, no storage), at
full width and depth, under the counting modes of
``repro_torch.utils.hlo``. What rank 0 runs on its local shards is what
every rank of an SPMD step runs. ``lower_s`` is the trace's time;
``compile_s`` is 0 (nothing is compiled).

The reference corrects XLA's cost of a scanned layer stack, which counts
a loop body once (``_scan_corrected_cost``). An eager trace runs every
layer, and ``scan_layers`` is carried and not read, so there is nothing
to correct: ``flops_estimated`` is always False.

``--device`` defaults to ``cuda`` (the fake tensors carry the card's
device, and nothing runs on it) and raises without a card. A process
joins one process group in its life, so each world size (a mesh of 256
ranks, of 512, or a ``--mesh`` of another size) needs its own process.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
import traceback

import torch

from repro_torch.configs import get_config, list_configs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import SHAPES, build_step, shape_applicable
from repro_torch.utils import hlo as hlo_util
from repro_torch.utils.device import resolve_device
from repro_torch.utils.flops import model_flops_6nd
from repro_torch.utils.tree import tree_flatten, tree_leaves, tree_unflatten

_MESHES = {}


def start_fake_group(world: int) -> None:
    """Join a fake process group of ``world`` ranks as rank 0 (a
    ``HashStore``: no port, no environment). Once a process: a group
    already up must be a fake one of this size."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_backend() != "fake" or dist.get_world_size() != world:
            raise RuntimeError(
                f"this process is in a {dist.get_backend()} group of "
                f"{dist.get_world_size()} ranks; the dry-run needs a fake "
                f"group of {world} (one world size a process)")
        return
    # registers the ``fake`` backend's creator with torch.distributed
    import torch.testing._internal.distributed.fake_pg  # noqa: F401
    dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                            world_size=world)


def fake_mesh(shape: tuple, names: tuple, *, device: str = "cuda"):
    """A mesh of ``shape`` over a fake group of its size (started here
    if need be); one mesh a (shape, names, device) a process."""
    key = (tuple(shape), tuple(names), str(device))
    if key not in _MESHES:
        start_fake_group(math.prod(shape))
        from torch.distributed.device_mesh import init_device_mesh
        _MESHES[key] = init_device_mesh(device, tuple(shape),
                                        mesh_dim_names=tuple(names))
    return _MESHES[key]


def production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """``make_production_mesh`` over a fake group of 256 (512) ranks."""
    key = ("production", multi_pod, str(device))
    if key not in _MESHES:
        start_fake_group(512 if multi_pod else 256)
        _MESHES[key] = make_production_mesh(multi_pod=multi_pod,
                                            device=device)
    return _MESHES[key]


def _is_placements(x) -> bool:
    from torch.distributed.tensor.placement_types import Placement
    return isinstance(x, list) and bool(x) and all(
        isinstance(p, Placement) for p in x)


def _distribute(abstract, placements, mesh, device):
    """Fake tensors of ``abstract``'s shapes and dtypes on ``device``,
    laid out on ``mesh`` by the matching tree of placement lists (each
    rank's shard its own storage). Call under ``FakeTensorMode``."""
    from torch.distributed.tensor import distribute_tensor
    leaves, skel = tree_flatten(abstract)
    pls = tree_flatten(placements, is_leaf=_is_placements)[0]
    if len(leaves) != len(pls):
        raise ValueError(f"{len(leaves)} tensors, {len(pls)} placements")
    return tree_unflatten(skel, [
        distribute_tensor(torch.empty(t.shape, dtype=t.dtype, device=device),
                          mesh, pl) for t, pl in zip(leaves, pls)])


def _locals(tree) -> list:
    return [t.to_local() if hasattr(t, "to_local") else t
            for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def dryrun_step(cfg, mesh, shape: str, *, device: str = "cuda",
                batch=None, seq=None, verbose: bool = True,
                multi_pod: bool = False, **step_kw) -> dict:
    """Trace ``shape``'s step of ``cfg`` on ``mesh`` (a mesh over a fake
    group) -> the record. ``batch`` / ``seq`` cut the shape's global
    batch and sequence (the mesh's placements follow them)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    s = dict(SHAPES[shape])
    s["batch"] = batch or s["batch"]
    s["seq"] = seq or s["seq"]
    n_chips = math.prod(tuple(mesh.shape))
    t0 = time.time()
    step, (p_pl, b_pl), _, (params_abs, batch_abs) = build_step(
        cfg, mesh, shape, batch=s["batch"], seq=s["seq"], **step_kw)
    flops, traffic = hlo_util.FlopCount(), hlo_util.BytesAndMemory()
    coll = hlo_util.CollectiveBytes()
    with FakeTensorMode():
        params = _distribute(params_abs, p_pl, mesh, device)
        if s["kind"] == "decode":
            # the position is a host int (the step reads it with int());
            # the last slot of the cache
            batch_abs = {k: v for k, v in batch_abs.items() if k != "index"}
            b_pl = {k: v for k, v in b_pl.items() if k != "index"}
        batch_in = _distribute(batch_abs, b_pl, mesh, device)
        if s["kind"] == "decode":
            batch_in["index"] = s["seq"] - 1
        args = _locals(params) + _locals(batch_in)
        arg_bytes = hlo_util.storage_bytes(args)
        with hlo_util.local_ops_only(), flops, traffic, coll:
            traffic.track(args)
            del args
            out = step(params, batch_in)
        out_bytes = hlo_util.storage_bytes(_locals(out))
    t_trace = time.time() - t0
    n_tokens = s["batch"] * (s["seq"] if s["kind"] != "decode" else 1)
    mf = model_flops_6nd(cfg, n_tokens)
    if s["kind"] != "train":
        mf /= 3.0                                  # fwd only (no bwd)
    roof = hlo_util.analyze(flops, traffic, coll, arch=cfg.name, shape=shape,
                            n_chips=n_chips, model_flops=mf)
    rec = roof.row()
    rec["flops_estimated"] = False
    rec.update({
        "multi_pod": multi_pod,
        "lower_s": round(t_trace, 1), "compile_s": 0.0,
        "bytes_per_device": traffic.peak - arg_bytes,
        "argument_bytes": arg_bytes,
        "output_bytes": out_bytes,
        "peak_bytes": traffic.peak,
        "coll_counts": roof.coll_detail["_counts"],
        "mesh": dict(zip(mesh.mesh_dim_names, tuple(mesh.shape))),
        "batch": s["batch"], "seq": s["seq"],
    })
    if verbose:
        print(f"== {cfg.name} x {shape} ({'multi' if multi_pod else 'single'}"
              f"-pod, {n_chips} ranks, mesh {rec['mesh']}) ==")
        print("memory: argument=%d output=%d peak=%d temp=%d" % (
            arg_bytes, out_bytes, traffic.peak, rec["bytes_per_device"]))
        print("cost: flops=%.3e bytes=%.3e" %
              (rec["hlo_flops"], rec["hlo_bytes"]))
        print("collectives:", rec["coll_counts"],
              "bytes=%.3e" % rec["coll_bytes"])
        print("roofline: compute=%.4fs memory=%.4fs collective=%.4fs "
              "dominant=%s useful=%.2f trace=%.1fs" %
              (rec["t_compute_s"], rec["t_memory_s"], rec["t_collective_s"],
               rec["dominant"], rec["useful_ratio"], t_trace), flush=True)
    return rec


def dryrun_one(arch: str, shape: str, *, multi_pod: bool = False,
               device: str = "cuda", verbose: bool = True, mesh=None,
               batch=None, attn_impl=None, **step_kw):
    """``shape``'s step of ``arch`` at full width on the production mesh
    -> the record (the reference's keys), or a skip record where the
    shape does not apply. ``mesh`` ("DATAxMODEL"), ``batch`` and
    ``attn_impl`` trace a step one card can run in its place."""
    import dataclasses
    cfg = get_config(arch)
    if attn_impl:
        cfg = dataclasses.replace(cfg, attn_impl=attn_impl)
    if not shape_applicable(cfg, shape):
        return {"arch": arch, "shape": shape, "skipped": True,
                "reason": "long-context not applicable (full attention)"}
    resolve_device(device)
    if mesh:
        dims = tuple(int(n) for n in mesh.lower().split("x"))
        m = fake_mesh(dims, ("data", "model"), device=device)
    else:
        m = production_mesh(multi_pod=multi_pod, device=device)
    return dryrun_step(cfg, m, shape, device=device, batch=batch,
                       verbose=verbose, multi_pod=multi_pod, **step_kw)


def lm_archs() -> list:
    return [a for a in list_configs()
            if getattr(get_config(a), "arch_type", "cnn") != "cnn"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="all (arch x shape) pairs")
    ap.add_argument("--split", type=int, default=None)
    ap.add_argument("--groups", type=int, default=None)
    ap.add_argument("--remat-policy", default=None, choices=["dots"],
                    help="selective remat (train shapes)")
    ap.add_argument("--json", default=None)
    ap.add_argument("--device", default="cuda",
                    help="device the fake tensors carry (cuda or cpu)")
    ap.add_argument("--mesh", default=None,
                    help="DATAxMODEL: a (data, model) mesh over a fake "
                         "group of that size, in place of the production "
                         "mesh (with --batch: a step one card can run, to "
                         "hold the dry-run against it)")
    ap.add_argument("--batch", type=int, default=None,
                    help="global batch in place of the shape's")
    ap.add_argument("--attn-impl", default=None, choices=["xla", "pallas"],
                    help="in place of the config's attn_impl")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    if args.all:
        pairs = [(a, s) for a in lm_archs() for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        pairs = [(args.arch, args.shape)]

    kw = {}
    if args.split is not None:
        kw["split"] = args.split
    if args.groups is not None:
        kw["n_groups"] = args.groups
    if args.remat_policy is not None:
        kw["remat_policy"] = args.remat_policy

    out = []
    for arch, shape in pairs:
        skw = dict(kw) if SHAPES[shape]["kind"] == "train" else {}
        try:
            rec = dryrun_one(arch, shape, multi_pod=args.multi_pod,
                             device=args.device, mesh=args.mesh,
                             batch=args.batch, attn_impl=args.attn_impl,
                             **skw)
        except Exception as e:                       # noqa: BLE001
            rec = {"arch": arch, "shape": shape, "error": repr(e)[:500]}
            traceback.print_exc()
            print(f"!! {arch} x {shape} FAILED: {rec['error']}",
                  file=sys.stderr, flush=True)
        out.append(rec)
        if args.json:                    # after every pair: crash-safe
            with open(args.json, "w") as f:
                json.dump(out, f, indent=1, default=str)
    n_err = sum(1 for r in out if "error" in r)
    print(f"\n{len(out)} pairs, {n_err} errors")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
