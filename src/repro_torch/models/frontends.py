"""Modality frontend STUBS (the one carve-out to "build everything").

For the [audio] and [vlm] configs only the transformer BACKBONE is
modelled: the EnCodec conv feature extractor (audio) and the InternViT
vision encoder + projector (vlm) are stubs whose role is to provide
precomputed frame/patch embeddings of the right shape.
"""
from __future__ import annotations

import torch

from repro_torch.models.params import DTYPES


def frontend_embed_shape(cfg, batch: int):
    if not cfg.frontend:
        raise ValueError(f"{cfg.name} has no modality frontend")
    return (batch, cfg.n_frontend_tokens, cfg.d_model)


def synth_frontend_embeds(cfg, gen: torch.Generator, batch: int, *, device):
    """Stand-in for InternViT patch embeddings / EnCodec frame embeddings,
    drawn on the CPU from ``gen`` and moved to ``device``."""
    e = torch.randn(frontend_embed_shape(cfg, batch), generator=gen,
                    dtype=torch.float32) * 0.02
    return e.to(DTYPES[cfg.dtype]).to(device)
