"""The port's step accounting (``repro_torch.utils.hlo``) against what
it must count: the collectives DTensor issues on a fake (4, 2) group,
byte for byte; the FLOPs of the local products only (not the global
product DTensor's sharding propagation runs to learn a shape); bytes
moved and live storages on plain tensors; and ``Roofline`` against the
reference's on the same counts, with each package's hardware constants.

A process-group case runs in a subprocess with a time limit: a process
joins one group in its life."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.utils import hlo as ref_hlo
from repro_torch.utils import hlo

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 300


def run_fake_group(code: str) -> dict:
    """``code`` in a fresh interpreter that has started a fake group of 8
    ranks (rank 0) and a (4, 2) ``data`` x ``model`` mesh on the CPU as
    ``mesh``; -> the dict it prints after ``RESULT``."""
    head = ("from repro_torch.launch.dryrun import fake_mesh\n"
            "mesh = fake_mesh((4, 2), ('data', 'model'), device='cpu')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", head + code], env=env,
                         capture_output=True, text=True, timeout=TIMEOUT_S)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("RESULT ")]
    assert len(line) == 1, out.stdout[-2000:] + out.stderr[-2000:]
    return json.loads(line[0][len("RESULT "):])


COLLECTIVES = """
import json, torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.utils import hlo
coll, flops = hlo.CollectiveBytes(), hlo.FlopCount()
with FakeTensorMode():
    a = distribute_tensor(torch.empty(64, 32), mesh, [Replicate(), Shard(1)])
    b = distribute_tensor(torch.empty(32, 16), mesh, [Replicate(), Shard(0)])
    g = distribute_tensor(torch.empty(8, 4), mesh, [Shard(0), Replicate()])
    with hlo.local_ops_only(), flops, coll:
        c = (a @ b).redistribute(mesh, [Replicate(), Replicate()])
        whole = g.full_tensor()
print("RESULT " + json.dumps({"coll": coll.result(), "flops": flops.flops,
                              "c": [list(c.to_local().shape),
                                    [str(p) for p in c.placements]],
                              "whole": list(whole.shape)}))
"""


def test_collectives_and_flops_of_a_sharded_matmul_exact():
    """A ``Shard(1)`` x ``Shard(0)`` product over ``model`` is a partial
    sum: made whole, one all-reduce of the local (64, 16) f32 result,
    4096 bytes; a ``Shard(0)`` (8, 4) tensor made whole over ``data``:
    one all-gather whose output is the whole 128 bytes. The FLOPs are
    the local product's, 2 * 64 * 16 * 16: not the global (64, 32, 16)
    one DTensor runs on fake tensors to learn the output's shape."""
    r = run_fake_group(COLLECTIVES)
    assert r["coll"] == {
        "all-reduce": 4096, "all-gather": 128, "reduce-scatter": 0,
        "all-to-all": 0, "collective-permute": 0,
        "_counts": {"all-reduce": 1, "all-gather": 1, "reduce-scatter": 0,
                    "all-to-all": 0, "collective-permute": 0},
        "_total": 4224}
    assert r["flops"] == 2 * 64 * 16 * 16
    assert r["c"] == [[64, 16], ["R", "R"]]
    assert r["whole"] == [8, 4]


def test_bytes_and_memory_count_storages_not_views():
    """``x`` (4000 bytes) as an argument; ``y = x * 2`` adds a storage and
    moves 8000 bytes; a view of y adds neither; ``z = v + 1`` adds 4000
    more: the peak is 12000, and y's storage lives on in its view. When
    the last tensor of a storage goes, so do its bytes."""
    with FakeTensorMode():
        x = torch.empty(1000)
        mode = hlo.BytesAndMemory()
        with mode:
            assert mode.track([x]) == 4000
            y = x * 2
            v = y.view(10, 100)
            del y
            z = v + 1
            assert mode.live == 12000
            del v
            assert mode.live == 8000
            del z
        assert mode.live == 4000
    assert mode.peak == 12000
    assert mode.bytes == 16000


def test_flops_count_matmuls_only():
    """FlopCounterMode's formulas: a (8, 16) x (16, 4) product is 1024
    FLOPs, a batched one counts every batch, elementwise work none."""
    with FakeTensorMode():
        a, b = torch.empty(8, 16), torch.empty(16, 4)
        with hlo.FlopCount() as f:
            (a @ b).relu()
            torch.bmm(torch.empty(3, 8, 16), torch.empty(3, 16, 4))
    assert f.flops == 1024 * 4


@pytest.mark.parametrize("counts", [
    dict(hlo_flops=4e15, hlo_bytes=1e9, coll_bytes=1e6),
    dict(hlo_flops=1e9, hlo_bytes=5e13, coll_bytes=1e6),
    dict(hlo_flops=1e9, hlo_bytes=1e9, coll_bytes=2e11),
])
def test_roofline_against_the_reference(counts):
    """The same counts in both packages' ``Roofline``: each time term is
    the reference's times the ratio of the two packages' constants (the
    H100's here, the TPU v5e's there), ``dominant`` (one term far ahead
    in both) and ``useful_ratio`` are equal, and ``row`` has the same
    keys."""
    kw = dict(arch="internlm2-1.8b", shape="train_4k", n_chips=256,
              model_flops=5e17, **counts)
    port, ref = hlo.Roofline(**kw), ref_hlo.Roofline(**kw)
    assert port.t_compute == pytest.approx(
        ref.t_compute * ref_hlo.PEAK_FLOPS / hlo.PEAK_FLOPS, rel=1e-12)
    assert port.t_memory == pytest.approx(
        ref.t_memory * ref_hlo.HBM_BW / hlo.HBM_BW, rel=1e-12)
    assert port.t_collective == pytest.approx(
        ref.t_collective * ref_hlo.ICI_BW / hlo.LINK_BW, rel=1e-12)
    assert port.dominant == ref.dominant
    assert port.useful_ratio == ref.useful_ratio
    assert port.row().keys() == ref.row().keys()


def test_constants_are_the_h100s():
    assert (hlo.PEAK_FLOPS, hlo.HBM_BW, hlo.LINK_BW) == (989.4e12, 3.35e12,
                                                         50e9)
