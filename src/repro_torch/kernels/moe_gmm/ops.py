"""Public wrapper: the expert FFN on capacity-bucketed inputs."""
from __future__ import annotations

from repro_torch.kernels.moe_gmm.kernel import moe_gmm


def expert_ffn(p, exp_in, act: str = "silu"):
    """p: moe param dict with w_gate/w_up/w_down (E, ...); exp_in (E, C, d).

    The reference picks its F tile from d here (a VMEM budget of the
    TPU); the Hopper kernel's tiles do not depend on d. Plain tensors
    only: on a device mesh ``moe._dispatch_local`` calls this on each
    rank's own experts."""
    return moe_gmm(exp_in, p["w_gate"], p["w_up"], p["w_down"], act=act)
