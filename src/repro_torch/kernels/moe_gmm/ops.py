"""Public wrapper: the expert FFN on capacity-bucketed inputs."""
from __future__ import annotations

from repro_torch.kernels import _build
from repro_torch.kernels.moe_gmm.kernel import moe_gmm


def expert_ffn(p, exp_in, act: str = "silu"):
    """p: moe param dict with w_gate/w_up/w_down (E, ...); exp_in (E, C, d).

    The reference picks its F tile from d here (a VMEM budget of the
    TPU); the Hopper kernel's tiles do not depend on d. On a device mesh
    (DTensor inputs) each rank runs its own experts
    (``_build.on_batch_shards``: the experts are independent)."""
    return _build.on_batch_shards(
        lambda x, wg, wu, wd: moe_gmm(x, wg, wu, wd, act=act),
        (exp_in, p["w_gate"], p["w_up"], p["w_down"]), (True,) * 4)
