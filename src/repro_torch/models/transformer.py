"""Composable decoder assembly.

Blocks are built from the config's (mixer, ffn) pattern; the stack exposes
range-application (``apply_blocks(lo, hi)``) which is what S²FL's sliding
split consumes: the client portion is ``embed + blocks[:s]``, the server
portion is ``blocks[s:] + final_norm + head``.

``cfg.remat`` recomputes each block in the backward pass
(``torch.utils.checkpoint``, non-reentrant), as the reference's
per-block ``jax.checkpoint`` does: in training (``train`` set, grad
mode on, no caches). ``cfg.remat_policy == "dots"`` saves the outputs
of matrix products without batch dims and recomputes the rest (JAX's
``dots_with_no_batch_dims_saveable``). The numbers are those of the
plain loop; only memory and time differ.

``torch.func`` transforms refuse saved-tensor hooks, which checkpoint
uses, so code that runs blocks under ``torch.func.grad`` / ``vmap`` (the
engine's multi-group server step) builds its model with ``remat`` off
(``without_remat``): the same numbers, a layer's activations each held.

``cfg.scan_layers`` (``lax.scan`` over identical blocks, an XLA
compile-time knob) has no eager counterpart; it is carried, not read.
"""
from __future__ import annotations

import dataclasses
import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (cross_entropy, embed, embed_defs,
                                       head_defs, mlp, mlp_defs, rmsnorm,
                                       rmsnorm_defs)
from repro_torch.models.params import DTYPES
from repro_torch.models.sharding import rows_only


# ---------------------------------------------------------------------------
# defs
# ---------------------------------------------------------------------------
def _block_defs(cfg, mixer: str, ffn: str):
    d = cfg.d_model
    defs = {"norm1": rmsnorm_defs(d)}
    if mixer == "ssm":
        defs["mixer"] = ssm_mod.ssm_defs(cfg)
    elif mixer in ("attn", "swa"):
        defs["mixer"] = attn_mod.attn_defs(cfg)
    elif mixer != "shared_attn":               # shared: cfg-level slot
        raise ValueError(mixer)
    if ffn == "dense":
        defs["norm2"] = rmsnorm_defs(d)
        defs["ffn"] = mlp_defs(d, cfg.d_ff)
    elif ffn == "moe":
        defs["norm2"] = rmsnorm_defs(d)
        defs["ffn"] = moe_mod.moe_defs(cfg)
    return defs


def model_defs(cfg):
    defs = {
        "embed": embed_defs(cfg.vocab_padded, cfg.d_model),
        "blocks": [_block_defs(cfg, m, f) for m, f in cfg.pattern()],
        "final_norm": rmsnorm_defs(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        defs["head"] = head_defs(cfg.d_model, cfg.vocab_padded)
    if any(m == "shared_attn" for m, _ in cfg.pattern()):
        defs["shared_attn"] = {
            "mixer": attn_mod.attn_defs(cfg),
            "norm2": rmsnorm_defs(cfg.d_model),
            "ffn": mlp_defs(cfg.d_model, cfg.d_ff),
        }
    return defs


# ---------------------------------------------------------------------------
# forward pieces (split-aware)
# ---------------------------------------------------------------------------
def apply_embed(cfg, params, tokens, prefix_embeds=None):
    """tokens: (B,S) int; optional prefix_embeds (B,P,d) from a modality
    frontend stub. Returns hidden (B, P+S, d)."""
    # on a mesh the lookup of a vocab-sharded table is a partial sum,
    # reduced before anything else reads it
    h = rows_only(embed(params["embed"], tokens, DTYPES[cfg.dtype]))
    if prefix_embeds is not None:
        h = torch.cat([prefix_embeds.to(h.dtype), h], dim=1)
    return rows_only(h)


def _apply_block_kind(cfg, mixer, ffn, bp, shared, h, positions, cache,
                      cache_index):
    """One block of a given (mixer, ffn) kind with explicit params `bp`
    (and the config-level shared-attention params for zamba2-style
    blocks). Returns (h, cache, aux): aux is the MoE router loss, None
    for the other kinds (no device op on their path)."""
    aux = None
    if mixer == "shared_attn":
        sp = shared
        a, cache = attn_mod.attn_apply(cfg, "attn", sp["mixer"],
                                       rmsnorm(bp["norm1"], h, cfg.norm_eps),
                                       positions, cache, cache_index)
        h = h + a
        f = mlp(sp["ffn"], rmsnorm(sp["norm2"], h, cfg.norm_eps), cfg.act)
        return h + f, cache, aux

    if mixer == "ssm":
        a, cache = ssm_mod.ssm_apply(cfg, bp["mixer"],
                                     rmsnorm(bp["norm1"], h, cfg.norm_eps),
                                     cache)
    else:
        a, cache = attn_mod.attn_apply(cfg, mixer, bp["mixer"],
                                       rmsnorm(bp["norm1"], h, cfg.norm_eps),
                                       positions, cache, cache_index)
    h = h + a
    if ffn == "dense":
        h = h + mlp(bp["ffn"], rmsnorm(bp["norm2"], h, cfg.norm_eps), cfg.act)
    elif ffn == "moe":
        f, aux = moe_mod.moe_apply(cfg, bp["ffn"],
                                   rmsnorm(bp["norm2"], h, cfg.norm_eps))
        h = h + f
    return h, cache, aux


_MM, _BMM = torch.ops.aten.mm.default, torch.ops.aten.bmm.default


def _save_dots(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat_policy == "dots"``: keep the
    output of a matrix product with no batch dims (``mm``, or the
    batch-1 ``bmm`` that ``einsum`` runs a projection as); recompute the
    rest (attention's and the experts' batched products included)."""
    if op is _MM or (op is _BMM and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_kwargs(cfg) -> dict:
    """'' (or any other value, as in the reference) -> full recompute;
    'dots' -> the selective policy above."""
    if cfg.remat_policy == "dots":
        return {"context_fn": functools.partial(
            create_selective_checkpoint_contexts, _save_dots)}
    return {}


def without_remat(cfg):
    """``cfg`` with ``remat`` off (itself when it is off already): for
    blocks run under ``torch.func`` transforms, which refuse checkpoint's
    saved-tensor hooks."""
    return dataclasses.replace(cfg, remat=False) if cfg.remat else cfg


def apply_blocks(cfg, params, h, lo: int, hi: int, positions,
                 caches=None, cache_index=None, train: bool = False):
    """Apply blocks [lo, hi). caches: per-layer list (len n_layers) or None.
    Returns (h, caches, aux_sum); aux_sum adds up the blocks' MoE router
    losses, 0 without MoE layers. With ``train``, ``cfg.remat``, grad
    mode on and no caches, each block is checkpointed (see the module
    docstring)."""
    pat = cfg.pattern()
    shared = params.get("shared_attn")
    caches = list(caches) if caches is not None else None
    aux_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    remat = (train and cfg.remat and caches is None
             and torch.is_grad_enabled())
    kw = _remat_kwargs(cfg) if remat else {}
    for i in range(lo, hi):
        mixer, ffn = pat[i]
        c_i = caches[i] if caches is not None else None
        if remat:
            h, c_i, aux = checkpoint(
                _apply_block_kind, cfg, mixer, ffn, params["blocks"][i],
                shared, h, positions, None, None, use_reentrant=False, **kw)
        else:
            h, c_i, aux = _apply_block_kind(cfg, mixer, ffn,
                                            params["blocks"][i], shared, h,
                                            positions, c_i, cache_index)
        h = rows_only(h)
        if caches is not None:
            caches[i] = c_i
        if aux is not None:
            aux_sum = aux_sum + aux
    return h, caches, aux_sum


def apply_head(cfg, params, h):
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    if cfg.tie_embeddings:
        return h @ params["embed"]["tok"].to(h.dtype).T
    return h @ params["head"]["w"].to(h.dtype)


# ---------------------------------------------------------------------------
# whole-model entry points
# ---------------------------------------------------------------------------
def _positions(n: int, device):
    return torch.arange(n, dtype=torch.int32, device=device)


def forward(cfg, params, tokens, prefix_embeds=None, train: bool = False):
    """Full forward: logits (B, P+S, vocab_padded), aux loss."""
    h = apply_embed(cfg, params, tokens, prefix_embeds)
    h, _, aux = apply_blocks(cfg, params, h, 0, cfg.n_layers,
                             _positions(h.shape[1], h.device), train=train)
    return apply_head(cfg, params, h), aux


def lm_loss(cfg, params, batch, train: bool = True):
    """batch: {'tokens': (B,S), 'labels': (B,S), optional 'prefix': (B,P,d)}.
    labels[i] is the target for position i (already shifted); -100 ignored."""
    logits, aux = forward(cfg, params, batch["tokens"],
                          batch.get("prefix"), train=train)
    P = logits.shape[1] - batch["tokens"].shape[1]
    if P:
        logits = logits[:, P:]
    ce = cross_entropy(logits, batch["labels"], cfg.vocab_size)
    return ce + aux, {"ce": ce, "aux": aux}


def init_caches(cfg, batch: int, max_len: int, *, device):
    dtype = DTYPES[cfg.dtype]
    caches = []
    for mixer, _ in cfg.pattern():
        if mixer == "ssm":
            caches.append(ssm_mod.init_ssm_cache(cfg, batch, dtype, device))
        else:
            caches.append(attn_mod.init_attn_cache(cfg, mixer, batch,
                                                   max_len, dtype, device))
    return caches


def cache_fill(name: str) -> int:
    """The one value every element of ``init_caches``'s leaf ``name``
    starts at: ``EMPTY_SLOT`` in a window's slot positions, 0 in every
    other cache."""
    return attn_mod.EMPTY_SLOT if name == "slot_pos" else 0


def prefill(cfg, params, tokens, max_len: int, prefix_embeds=None,
            caches=None):
    """Run the prompt, build caches. Returns (last_logits, caches,
    n_prefill). ``caches``: zeroed caches of ``max_len`` to fill (laid
    out on a device mesh, say); None -> ``init_caches``."""
    h = apply_embed(cfg, params, tokens, prefix_embeds)
    S = h.shape[1]
    if caches is None:
        caches = init_caches(cfg, tokens.shape[0], max_len, device=h.device)
    h, caches, _ = apply_blocks(cfg, params, h, 0, cfg.n_layers,
                                _positions(S, h.device), caches=caches)
    logits = apply_head(cfg, params, h[:, -1:])
    return logits, caches, S


def decode_step(cfg, params, token, caches, index: int):
    """One decode step. token: (B,1) int, index: the current position.
    Returns (logits (B,1,V), caches); attention caches are updated in
    place."""
    h = apply_embed(cfg, params, token)
    positions = torch.tensor([int(index)], dtype=torch.int32,
                             device=h.device)
    h, caches, _ = apply_blocks(cfg, params, h, 0, cfg.n_layers, positions,
                                caches=caches, cache_index=int(index))
    return apply_head(cfg, params, h), caches
