"""Device selection for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """-> a torch.device for ``device`` ('cuda', 'cuda:0', 'cpu', ...).

    A CUDA device that is not there raises: nothing falls back to the
    CPU. On CUDA, TF32 is switched off for convolutions and matrix
    products, because the reference computes in full fp32 and TF32
    would make the card run a different experiment."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} asked for, but CUDA is not available "
                f"(pass device='cpu' to run on the CPU)")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: cuda or cpu")
    return dev
