"""The SPMD steps on real four-rank device meshes (``gloo`` on the CPU),
each against the same step on plain, unsharded tensors, as
``test_torch_spmd_gloo.py`` holds the two-rank ones (its harness runs
the ranks): ``data=2, model=2`` shards the batch and the heads (or
experts) at once, so DTensor flattens two sharded dims into one (a
strided shard) in the attention, SSD and expert products, which run on
each rank's local shards; ``model=4`` gives reduced internlm2's 2 kv
heads a mesh dim they do not divide (each rank then attends one q head
and takes its kv head from the whole k and v in training, and its
decode caches are sharded over the head dim). internvl2's frontend
concatenates its prefix to the embedding of a vocab-sharded table, and
the ``pallas`` serve case runs the kernels' wrappers (their plain
versions on the CPU) on each rank's own rows and heads, or experts."""
import pytest

from test_torch_spmd_gloo import TOL, _run


@pytest.mark.parametrize("case", ["train_data2_model2", "train_model4",
                                  "train_frontend_data2_model2"])
def test_train_step_on_four_ranks_equals_unsharded(case, tmp_path):
    """Losses and params within 1e-5 of the plain step over two steps;
    the new params keep their placements; some weights are sharded over
    ``model``."""
    for r in _run(case, tmp_path):
        assert r["remat"] is True
        assert max(r["loss_rel"]) <= TOL, r
        assert r["params_abs"] <= TOL, r
        assert r["kept"], r
        assert r["sharded_leaves"] > 0, r
        if r["arch"].startswith("deepseek"):
            assert r["dispatch"] == 2


@pytest.mark.parametrize("case", ["serve_data2_model2", "serve_model4",
                                  "serve_pallas_data2_model2"])
def test_prefill_and_decode_on_four_ranks_equal_unsharded(case, tmp_path):
    """Prefill and two decode steps within 1e-5 of the plain ones,
    relative to the logits' scale."""
    for r in _run(case, tmp_path):
        tol = TOL * max(1.0, r["logit_scale"])
        assert r["prefill_abs"] <= tol, r
        assert len(r["decode_abs"]) == 2 and max(r["decode_abs"]) <= tol, r
