"""The SPMD steps on real two-rank device meshes (``gloo`` on the CPU):
the fused S²FL train step built by ``build_train_step`` on ``data=2,
model=1`` and on ``data=1, model=2`` (tensor-parallel placements from
``model_param_specs``), and the prefill and a decode step built by
``build_prefill_step`` / ``build_decode_step`` on ``data=2``, each
against the same step on plain, unsharded tensors.

Each case starts its two ranks as subprocesses of this file (run as a
script: ``python test_torch_spmd_gloo.py <case> <rank> <store>``), with a
file store in the test's temp dir and a time limit, so a hang fails the
test and no process-group state reaches the test process."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 420
TOL = 1e-5

# case -> (data, model, [(arch, attn_impl)])
CASES = {
    "train_data2": (2, 1, [("internlm2-1.8b", "xla"),
                           ("deepseek-v2-lite-16b", "xla")]),
    "train_model2": (1, 2, [("internlm2-1.8b", "xla")]),
    "serve_data2": (2, 1, [("zamba2-1.2b", "xla"), ("zamba2-1.2b", "pallas"),
                           ("deepseek-v2-lite-16b", "pallas")]),
    # four ranks (tests/test_torch_spmd_mesh2d.py): batch and heads (or
    # experts) sharded at once; kv heads that do not divide the model dim
    "train_data2_model2": (2, 2, [("internlm2-1.8b", "xla"),
                                  ("zamba2-1.2b", "xla"),
                                  ("deepseek-v2-lite-16b", "xla")]),
    "train_model4": (1, 4, [("internlm2-1.8b", "xla")]),
    # a modality frontend: the vocab-sharded embedding's partial sum is
    # reduced before the prefix is concatenated
    "train_frontend_data2_model2": (2, 2, [("internvl2-1b", "xla")]),
    "serve_data2_model2": (2, 2, [("zamba2-1.2b", "xla"),
                                  ("deepseek-v2-lite-16b", "xla")]),
    "serve_model4": (1, 4, [("internlm2-1.8b", "xla")]),
    # the kernels' wrappers (their plain versions here) on each rank's
    # own rows and heads, or experts
    "serve_pallas_data2_model2": (2, 2, [("zamba2-1.2b", "pallas"),
                                         ("deepseek-v2-lite-16b",
                                          "pallas")]),
}


# ------------------------------------------------------------ one rank
def _train(cfg, mesh, torch):
    """Two steps of the mesh step from the same params against two of the
    plain step; -> readings (collectives run on every rank)."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.core.round_step import make_s2fl_train_step
    from repro_torch.launch.steps import build_train_step, train_config
    from repro_torch.models import SplitModel
    from repro_torch.models.frontends import synth_frontend_embeds
    from repro_torch.models.sharding import model_param_specs, shard_params
    from repro_torch.utils.tree import tree_leaves
    step, (_, bpl), _, _ = build_train_step(cfg, mesh, split=1, n_groups=2,
                                            lr=0.05)
    tcfg = train_config(cfg, mesh)
    plain = make_s2fl_train_step(tcfg, 1, 2, 0.05, group_members=1)
    params = SplitModel(tcfg).init(0, device="cpu")
    sharded = shard_params(params, model_param_specs(tcfg, mesh), mesh)
    placements = [t.placements for t in tree_leaves(sharded)]
    gen = torch.Generator().manual_seed(1)
    out = {"remat": tcfg.remat, "dispatch": tcfg.moe_dispatch_shards,
           "loss_rel": [], "params_abs": 0.0, "kept": True,
           "sharded_leaves": sum(any(p.is_shard() for p in pl)
                                 for pl in placements)}
    for _ in range(2):
        B, S = 8, 16
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                         generator=gen, dtype=torch.int32),
                 "labels": torch.randint(0, cfg.vocab_size, (B, S),
                                         generator=gen, dtype=torch.int32),
                 "perm": torch.randperm(B, generator=gen).to(torch.int32)}
        if cfg.frontend:
            batch["prefix"] = synth_frontend_embeds(cfg, gen, B,
                                                    device="cpu")
        params, loss = plain(params, batch)
        sharded, dloss = step(sharded, {k: distribute_tensor(v, mesh, bpl[k])
                                        for k, v in batch.items()})
        dl = float(dloss.full_tensor())
        out["loss_rel"].append(abs(dl - float(loss)) / abs(float(loss)))
        for a, b, pl in zip(tree_leaves(sharded), tree_leaves(params),
                            placements):
            out["kept"] &= tuple(a.placements) == tuple(pl)
            out["params_abs"] = max(out["params_abs"], float(
                (a.full_tensor() - b).abs().max()))
    return out


def _serve(cfg, mesh, torch):
    """The mesh prefill and two decode steps against the plain ones,
    both fed the plain run's greedy tokens."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.launch.steps import build_decode_step, build_prefill_step
    from repro_torch.models import SplitModel
    from repro_torch.models import transformer as tf
    from repro_torch.models.sharding import model_param_specs, shard_params
    B, S, steps = 2, 64, 2
    params = SplitModel(cfg).init(0, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (B, S), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(1))
    pstep, (_, pin), _, _ = build_prefill_step(cfg, mesh, max_len=S + steps)
    dstep, (_, din), _, _ = build_decode_step(cfg, mesh)
    sharded = shard_params(params, model_param_specs(cfg, mesh), mesh)
    out = {"prefill_abs": 0.0, "decode_abs": [], "logit_scale": 0.0}
    with torch.no_grad():
        ref, rc, n = tf.prefill(cfg, params, tokens, S + steps)
        logits, caches = pstep(sharded, {"tokens": distribute_tensor(
            tokens, mesh, pin["tokens"])})
        out["prefill_abs"] = float((logits.full_tensor() - ref).abs().max())
        out["logits_placements"] = [str(p) for p in logits.placements]
        out["logit_scale"] = float(ref.abs().max())
        for t in range(steps):
            tok = torch.argmax(ref[:, -1, :cfg.vocab_size], -1)[:, None]
            tok = tok.to(torch.int32)
            ref, rc = tf.decode_step(cfg, params, tok, rc, n + t)
            logits, caches = dstep(sharded, {
                "token": distribute_tensor(tok, mesh, din["token"]),
                "index": distribute_tensor(torch.tensor(n + t,
                                                        dtype=torch.int32),
                                           mesh, din["index"]),
                "caches": caches})
            out["decode_abs"].append(float(
                (logits.full_tensor() - ref).abs().max()))
    return out


def _rank_main(case: str, rank: int, store: str):
    import dataclasses

    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    data, model, runs = CASES[case]
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=data * model)
    try:
        from repro_torch.configs import get_config, make_reduced
        from repro_torch.launch.mesh import make_host_mesh
        mesh = make_host_mesh(data, model, device="cpu")
        results = []
        for arch, impl in runs:
            cfg = dataclasses.replace(make_reduced(get_config(arch)),
                                      attn_impl=impl)
            run = _train if case.startswith("train") else _serve
            results.append({"arch": arch, "impl": impl,
                            **run(cfg, mesh, torch)})
        if rank == 0:
            print("RESULT " + json.dumps(results), flush=True)
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------- the test
def _run(case: str, tmp_path) -> list:
    """Every rank of ``case``; their output goes to files (a full pipe
    would stall a rank inside a collective)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    store = tmp_path / "store"
    world = CASES[case][0] * CASES[case][1]
    logs = [(tmp_path / f"rank{r}.out", tmp_path / f"rank{r}.err")
            for r in range(world)]
    procs = []
    for r, (out, err) in enumerate(logs):
        with open(out, "w") as fo, open(err, "w") as fe:
            procs.append(subprocess.Popen(
                [sys.executable, __file__, case, str(r), str(store)],
                env=env, stdout=fo, stderr=fe))
    try:
        for p in procs:
            p.wait(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        pytest.fail(f"{case}: a rank did not finish in {TIMEOUT_S} s")
    for p, (_, err) in zip(procs, logs):
        assert p.returncode == 0, err.read_text()[-3000:]
    line = [ln for ln in logs[0][0].read_text().splitlines()
            if ln.startswith("RESULT ")]
    assert len(line) == 1, logs[0][1].read_text()[-3000:]
    return json.loads(line[0][len("RESULT "):])


@pytest.mark.parametrize("case", ["train_data2", "train_model2"])
def test_train_step_on_two_ranks_equals_unsharded(case, tmp_path):
    """Losses and params within 1e-5 of the plain step over two steps;
    the new params keep their placements (a replicated weight's
    gradient is summed over the data axis, the E=1 aggregation); remat
    is on, as the builder forces it, and MoE dispatch is shard-local."""
    for r in _run(case, tmp_path):
        assert r["remat"] is True
        assert max(r["loss_rel"]) <= TOL, r
        assert r["params_abs"] <= TOL, r
        assert r["kept"], r
        if case == "train_model2":
            assert r["sharded_leaves"] > 0        # tensor parallel
        if r["arch"].startswith("deepseek"):
            assert r["dispatch"] == 2


def test_prefill_and_decode_on_two_ranks_equal_unsharded(tmp_path):
    """Batch-sharded prefill and decode steps (the kernels' wrappers run
    each rank's rows) within 1e-5 of the plain ones, relative to the
    logits' scale; the logits come back batch-sharded."""
    for r in _run("serve_data2", tmp_path):
        tol = TOL * max(1.0, r["logit_scale"])
        assert r["prefill_abs"] <= tol, r
        assert len(r["decode_abs"]) == 2 and max(r["decode_abs"]) <= tol, r
        assert r["logits_placements"][0] == "S(0)", r


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), sys.argv[3])
