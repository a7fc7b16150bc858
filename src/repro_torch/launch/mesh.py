"""Device meshes over the ranks of the default process group. Functions,
not module constants, so importing touches no process group or device.

The caller starts the group (``torch.distributed.init_process_group``
with an explicit address, world size and rank: nothing here discovers a
cluster)."""
from __future__ import annotations

import torch.distributed as dist


def _world() -> int:
    if not dist.is_available() or not dist.is_initialized():
        return 1
    return dist.get_world_size()


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """The (16, 16) ``data`` x ``model`` mesh, or (2, 16, 16) with a
    ``pod`` axis in front; raises when the process group has fewer
    ranks than the mesh needs."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 1
    for n in shape:
        need *= n
    if _world() != need:
        raise RuntimeError(
            f"the production mesh {dict(zip(axes, shape))} needs a process "
            f"group of world size {need}; this one has {_world()}")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device, shape, mesh_dim_names=axes)


def make_host_mesh(data: int = 1, model: int = 1, *, device: str = "cuda"):
    """A small (data, model) mesh over the ranks there are (tests, one
    card): each size is clamped to what the world holds, as the
    reference's does. Needs an initialised process group."""
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs an initialised process "
                           "group (torch.distributed.init_process_group)")
    n = _world()
    data = min(data, n)
    model = max(1, min(model, n // data))
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device, (data, model),
                            mesh_dim_names=("data", "model"))
