"""Basic layers: RMSNorm, MLPs, embeddings, rotary embeddings, the LM
cross-entropy.

Parameters are the reference's leaves in the reference's layouts
(``(d_in, d_out)`` weights, ``x @ w``), so a tree carries across leaf
for leaf. Two hazards of the translation: ``jax.nn.gelu`` is the tanh
approximation (``F.gelu`` defaults to erf), and the reference's rope
rotates the two *halves* of the head dim, not interleaved pairs.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.params import ParamDef


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------
def rmsnorm_defs(d_model: int):
    return {"scale": ParamDef((d_model,), ("embed",), init="ones")}


def rmsnorm(params, x, eps: float = 1e-5):
    """Computed in f32, returned in x's dtype."""
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * params["scale"].to(torch.float32)).to(dt)


# ---------------------------------------------------------------------------
# Gated MLP (swiglu / geglu)
# ---------------------------------------------------------------------------
def mlp_defs(d_model: int, d_ff: int, ff_axis: str = "ff"):
    return {
        "w_gate": ParamDef((d_model, d_ff), ("embed", ff_axis)),
        "w_up": ParamDef((d_model, d_ff), ("embed", ff_axis)),
        "w_down": ParamDef((d_ff, d_model), (ff_axis, "embed")),
    }


def activation(act: str):
    if act == "silu":
        return F.silu
    return lambda x: F.gelu(x, approximate="tanh")     # jax.nn.gelu


def mlp(params, x, act: str = "silu"):
    """On DTensors each rank runs its own rows against its own features
    (``on_local_shards``): weights sharded over ``ff`` give each rank
    a part of the output, summed over their mesh dim."""
    from repro_torch.models.sharding import on_local_shards
    actf = activation(act)

    def local(x, w_gate, w_up, w_down, *, starts):
        g = actf(x @ w_gate.to(x.dtype))
        u = x @ w_up.to(x.dtype)
        return (g * u) @ w_down.to(x.dtype)

    rows = {"rows": 0}
    return on_local_shards(
        local, (x, params["w_gate"], params["w_up"], params["w_down"]),
        (rows, {"ff": 1}, {"ff": 1}, {"ff": 0}),
        {"rows": 0, "partial": ("ff",)})


# ---------------------------------------------------------------------------
# Embedding / output head
# ---------------------------------------------------------------------------
def embed_defs(vocab_padded: int, d_model: int):
    return {"tok": ParamDef((vocab_padded, d_model), ("vocab", "embed"),
                            init="normal")}


def embed(params, tokens, compute_dtype):
    """The rows of the table (``F.embedding``: on a device mesh, a table
    sharded over vocab is looked up where it lies, as a partial sum)."""
    return F.embedding(tokens, params["tok"]).to(compute_dtype)


def head_defs(d_model: int, vocab_padded: int):
    return {"w": ParamDef((d_model, vocab_padded), ("embed", "vocab"))}


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, D) with positions (..., S) or (S,). Rotates the
    halves [x1, x2] of the head dim."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                 # (d/2,)
    ang = positions.to(torch.float32)[..., None] * freqs   # (..., S, d/2)
    ang = ang[..., None, :]                                # (..., S, 1, d/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def cross_entropy(logits, labels, vocab_size: int, *, mask=None):
    """Mean next-token CE in f32; labels == -100 or mask==0 are ignored.

    logits may be vocab-padded: positions >= vocab_size are masked out.
    On DTensors each rank takes its own rows' token losses
    (``on_local_shards``), the vocab whole: DTensor's rule for the label
    gather over a sharded dim mis-reduces, and its backward of a gather
    allocates the logits' gradient at the full batch.
    """
    from repro_torch.models.sharding import on_local_shards
    valid = labels >= 0
    if mask is not None:
        valid = valid & (mask > 0)
    labels_safe = torch.clamp(labels, 0, vocab_size - 1)

    def nll(logits, labels, *, starts):
        logits = logits.to(torch.float32)
        if logits.shape[-1] > vocab_size:
            logits = logits.clone()
            logits[..., vocab_size:] = -1e9
        logz = torch.logsumexp(logits, dim=-1)
        return logz - torch.gather(logits, -1, labels[..., None].long())[
            ..., 0]

    rows = {"batch": 0}
    nll = on_local_shards(nll, (logits, labels_safe), (rows, rows), rows)
    return (nll * valid).sum() / torch.clamp_min(valid.sum(), 1)
