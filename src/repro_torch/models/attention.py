"""Attention: grouped-query attention (full / sliding-window) and MLA
(DeepSeek latent attention), with train / prefill / decode paths and KV
caches.

``cfg.attn_impl == "pallas"`` sends train / prefill attention (S > 1)
through the flash attention kernel wrapper (``kernels/flash_attention``):
its CUDA kernel on a CUDA tensor, its plain version on a CPU tensor.
``"xla"`` runs the plain counterpart of the reference's XLA path: the
same masked-softmax arithmetic in f32 over q blocks, a plain loop where
the reference scans with a per-block ``jax.checkpoint`` (a memory knob
of its training path; the numbers are the same). Decode always takes
the plain path, as in the reference.

MLA's train / prefill attention goes the same way (through flash
under 'pallas', with q/k head dim nope + rope and v's own head dim);
its decode is the reference's absorbed form, plain f32 einsums over
the latent cache.

Cache layouts (batch-first, sequence second):
  full attn : {'k': (B, S, K, D), 'v': (B, S, K, D)}
  swa       : ring buffer {'k': (B, W, K, D), 'v': ..., 'slot_pos': (W,)}
  mla       : {'latent': (B, S, R), 'k_rope': (B, S, Dr)}
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.layers import apply_rope, rmsnorm
from repro_torch.models.params import ParamDef

NEG_INF = -1e30
EMPTY_SLOT = -1          # a window slot's position before it is written


# ---------------------------------------------------------------------------
# defs
# ---------------------------------------------------------------------------
def attn_defs(cfg):
    d, H = cfg.d_model, cfg.n_heads
    if cfg.mla:
        R, Dr, Dn, Dv = (cfg.kv_lora_rank, cfg.qk_rope_head_dim,
                         cfg.qk_nope_head_dim, cfg.v_head_dim)
        return {
            "wq": ParamDef((d, H, Dn + Dr), ("embed", "heads", "none")),
            "w_dkv": ParamDef((d, R), ("embed", "lora")),
            "w_kr": ParamDef((d, Dr), ("embed", "none")),
            "latent_norm": ParamDef((R,), ("lora",), init="ones"),
            "w_uk": ParamDef((R, H, Dn), ("lora", "heads", "none")),
            "w_uv": ParamDef((R, H, Dv), ("lora", "heads", "none")),
            "wo": ParamDef((H, Dv, d), ("heads", "none", "embed")),
        }
    K, D = cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": ParamDef((d, H, D), ("embed", "heads", "head_dim")),
        "wk": ParamDef((d, K, D), ("embed", "kv_heads", "head_dim")),
        "wv": ParamDef((d, K, D), ("embed", "kv_heads", "head_dim")),
        "wo": ParamDef((H, D, d), ("heads", "head_dim", "embed")),
    }


# ---------------------------------------------------------------------------
# core attention math (grouped, blockwise)
# ---------------------------------------------------------------------------
def _pick_q_block(S: int) -> int:
    for b in (1024, 512, 256, 128):
        if S % b == 0 and S > b:
            return b
    return S


def grouped_attention(q, k, v, q_pos, k_pos, *, window: int = 0,
                      causal: bool = True, impl: str = "xla"):
    """q: (B,S,H,Dq) k: (B,T,K,Dq) v: (B,T,K,Dv); GQA via H = K*G.

    Returns (B,S,H,Dv). Positions are 1-D int arrays (right-aligned, no
    padding semantics — masking is purely positional).

    On DTensors (a step on a device mesh) each rank attends its own
    batch rows and heads (``on_local_shards``), through the flash kernel
    under ``impl="pallas"`` (q of more than one position): the arithmetic
    of each (row, head) is that of the whole tensors. Where the kv heads do not
    divide the mesh dim that shards q's heads, k and v are whole there
    and each rank takes the kv heads its q heads read. Decode caches
    sharded over the sequence or the head dim stay so: DTensor's rules
    reduce the scores and the output over them, q's heads made whole
    where the kv heads do not divide.
    """
    from repro_torch.models.sharding import on_local_shards, unshard_dim
    heads = {"batch": 0, "heads": 2}
    n_heads, n_kv = q.shape[2], k.shape[2]
    flash = impl == "pallas" and q.shape[1] > 1
    if not flash and (_sharded_within_rows(k) or _sharded_within_rows(v)):
        if _sharded_within_rows(q, n_kv):
            q = unshard_dim(q, 2)
        if _sharded_on(k, 3) or _sharded_on(v, 3):
            return _attention_over_head_dim(q, k, v, q_pos, k_pos,
                                            window=window, causal=causal)
        return _attention_plain(q, k, v, q_pos, k_pos, window=window,
                                causal=causal)

    def attend(q, k, v, q_pos, k_pos, *, starts):
        if k.shape[2] == n_kv and q.shape[2] < n_heads:
            g = n_heads // n_kv                  # k, v whole: q's kv heads
            h0 = starts.get("heads", 0)
            k0, k1 = h0 // g, (h0 + q.shape[2] - 1) // g + 1
            k, v = k[:, :, k0:k1], v[:, :, k0:k1]
        if flash:
            from repro_torch.kernels.flash_attention import ops as fa_ops
            return fa_ops.flash_attention(q, k, v, q_pos, k_pos,
                                          window=window, causal=causal)
        return _attention_plain(q, k, v, q_pos, k_pos, window=window,
                                causal=causal)

    return on_local_shards(attend, (q, k, v, q_pos, k_pos),
                           (heads, heads, heads, {}, {}), heads)


def _sharded_within_rows(t, n_kv: int = 0) -> bool:
    """A DTensor sharded on a dim other than the batch (0) and the heads
    (2); with ``n_kv``, one whose heads are sharded over a mesh dim that
    ``n_kv`` kv heads do not divide."""
    from torch.distributed.tensor import DTensor
    if not isinstance(t, DTensor):
        return False
    sizes = tuple(t.device_mesh.shape)
    if n_kv:
        return any(p.is_shard(2) and n_kv % sizes[i]
                   for i, p in enumerate(t.placements))
    return any(p.is_shard() and p.dim % t.ndim not in (0, 2)
               for p in t.placements)


def _sharded_on(t, dim: int) -> bool:
    return hasattr(t, "placements") and any(p.is_shard(dim)
                                            for p in t.placements)


def _attention_over_head_dim(q, k, v, q_pos, k_pos, *, window: int,
                             causal: bool):
    """The plain attention of one query step over caches sharded on the
    head dim (decode, where the kv heads do not divide the model dim):
    each rank's slice of the head dim gives a part of the scores, which
    are summed over the ranks before the scale; the output keeps its
    slice until the heads are merged."""
    from repro_torch.models.sharding import on_local_shards, unshard_dim
    B, S, H, Dq = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    f32 = torch.float32

    def scores(q, k, *, starts):
        qg = q.reshape(q.shape[0], S, K, G, q.shape[3])
        return torch.einsum("bskgd,btkd->bkgst", qg.to(f32), k.to(f32))

    def weighted(w, v, *, starts):
        return torch.einsum("bkgst,btkd->bskgd", w, v)

    rows, dims = {"batch": 0}, {"batch": 0, "d": 3}
    s = on_local_shards(scores, (q, k), (dims, dims),
                        {"batch": 0, "partial": ("d",)})
    s = _summed(s) * (1.0 / math.sqrt(Dq))
    mask = _mask(q_pos, k_pos, window=window, causal=causal,
                 device=q.device)
    w = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
    o = on_local_shards(weighted, (w.to(v.dtype), v), (rows, dims),
                        {"batch": 0, "d": 4})
    return unshard_dim(o, 4).reshape(B, S, H, v.shape[-1])


def _mask(q_pos, k_pos, *, window: int, causal: bool, device):
    """(S, T) bool: the keys each query sees. Built out of place: k_pos
    may be a DTensor (a window's slot positions)."""
    mask = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                      device=device)
    if causal:
        mask = mask & (q_pos[:, None] >= k_pos[None, :])
    if window:
        mask = mask & (q_pos[:, None] - k_pos[None, :] < window)
    return mask & (k_pos[None, :] >= 0)


def _summed(x):
    """A DTensor's partial sums reduced (``Replicate`` where it was
    ``Partial``); anything else as it is."""
    from torch.distributed.tensor import Replicate
    if not hasattr(x, "placements"):
        return x
    pl = [Replicate() if p.is_partial() else p for p in x.placements]
    return x.redistribute(x.device_mesh, pl)


def _attention_plain(q, k, v, q_pos, k_pos, *, window: int, causal: bool):
    """The reference's masked-softmax attention in f32 over q blocks, on
    plain tensors."""
    B, S, H, Dq = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(Dq)
    qg = q.reshape(B, S, K, G, Dq)
    kf, vf = k.to(torch.float32), v

    def block(q_blk, qp_blk):
        s = torch.einsum("bskgd,btkd->bkgst", q_blk.to(torch.float32),
                         kf) * scale
        mask = _mask(qp_blk, k_pos, window=window, causal=causal,
                     device=q.device)
        s = torch.where(mask, s, NEG_INF)
        w = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgst,btkd->bskgd", w.to(vf.dtype), vf)
        return o.reshape(B, q_blk.shape[1], H, vf.shape[-1])

    qb = _pick_q_block(S)
    return torch.cat([block(qg[:, i:i + qb], q_pos[i:i + qb])
                      for i in range(0, S, qb)], dim=1)


# ---------------------------------------------------------------------------
# GQA paths
# ---------------------------------------------------------------------------
def init_attn_cache(cfg, kind: str, batch: int, max_len: int, dtype,
                    device):
    if cfg.mla:
        return {
            "latent": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                                  dtype=dtype, device=device),
            "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_head_dim),
                                  dtype=dtype, device=device),
        }
    K, D = cfg.n_kv_heads, cfg.head_dim
    L = min(max_len, cfg.sliding_window) if kind == "swa" else max_len
    cache = {"k": torch.zeros((batch, L, K, D), dtype=dtype, device=device),
             "v": torch.zeros((batch, L, K, D), dtype=dtype, device=device)}
    if kind == "swa":
        cache["slot_pos"] = torch.full((L,), EMPTY_SLOT, dtype=torch.int32,
                                       device=device)
    return cache


def gqa_apply(cfg, kind, p, x, positions, cache=None, cache_index=None):
    """x: (B,S,d). Train: cache None. Prefill: cache dict is filled and
    returned. Decode: S==1, cache_index = current position (int).

    Unlike the reference's functional updates, prefill and decode write
    the new keys and values into the cache tensors in place (a copy of
    the whole cache per step would cost its size in memory traffic); the
    returned cache is the one passed in, or the new ring buffer."""
    B, S, d = x.shape
    window = cfg.sliding_window if kind == "swa" else 0
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(x.dtype))
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if cache is None:                                   # train
        out = grouped_attention(q, k, v, positions, positions,
                                window=window, causal=True,
                                impl=cfg.attn_impl)
    elif S > 1:                                         # prefill
        if window and cache["k"].shape[1] < S:          # fill ring buffer
            # keep the last W positions, laid out so slot == pos % W (the
            # invariant decode appends rely on)
            W = cache["k"].shape[1]
            slots = positions[S - W:] % W
            order = torch.argsort(slots)
            cache = {"k": k[:, S - W:][:, order], "v": v[:, S - W:][:, order],
                     "slot_pos": positions[S - W:][order].to(torch.int32)}
        else:
            L = cache["k"].shape[1]
            cache = dict(cache)
            cache["k"][:, :S] = k
            cache["v"][:, :S] = v
            if "slot_pos" in cache:
                pos = positions.to(torch.int32)
                cache["slot_pos"] = (
                    torch.cat([pos, pos.new_full((L - S,), EMPTY_SLOT)])
                    if L > S else pos[:L])
        out = grouped_attention(q, k, v, positions, positions,
                                window=window, causal=True,
                                impl=cfg.attn_impl)
    else:                                               # decode, S == 1
        idx = int(cache_index)
        if window:
            W = cache["k"].shape[1]
            slot = idx % W
            cache["k"][:, slot] = k[:, 0]
            cache["v"][:, slot] = v[:, 0]
            cache["slot_pos"][slot] = idx
            k_pos = cache["slot_pos"]
        else:
            cache["k"][:, idx] = k[:, 0]
            cache["v"][:, idx] = v[:, 0]
            T = cache["k"].shape[1]
            ar = torch.arange(T, device=x.device)
            k_pos = torch.where(ar <= idx, ar, -1)
        out = grouped_attention(q, cache["k"], cache["v"], positions, k_pos,
                                window=window, causal=not window, impl="xla")

    out = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
    return out, cache


# ---------------------------------------------------------------------------
# MLA paths
# ---------------------------------------------------------------------------
def _mla_latent(cfg, p, x, positions):
    latent = x @ p["w_dkv"].to(x.dtype)
    latent = rmsnorm({"scale": p["latent_norm"]}, latent, cfg.norm_eps)
    k_rope = x @ p["w_kr"].to(x.dtype)                   # (B,S,Dr)
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]
    return latent, k_rope


def mla_apply(cfg, p, x, positions, cache=None, cache_index=None):
    """As ``gqa_apply``; the latent and rope-key caches are written in
    place."""
    B, S, d = x.shape
    H = cfg.n_heads
    Dn, Dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    q_nope, q_rope = q[..., :Dn], q[..., Dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    if cache is None or S > 1:                          # train / prefill
        latent, k_rope = _mla_latent(cfg, p, x, positions)
        k_nope = torch.einsum("btr,rhk->bthk", latent,
                              p["w_uk"].to(x.dtype))
        v = torch.einsum("btr,rhk->bthk", latent, p["w_uv"].to(x.dtype))
        # cat copies: k and q get the unit last stride the kernel reads
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, Dr)],
                      dim=-1)
        qq = torch.cat([q_nope, q_rope], dim=-1)
        out = grouped_attention(qq, k, v, positions, positions,
                                causal=True, impl=cfg.attn_impl)
        if cache is not None:
            cache["latent"][:, :S] = latent
            cache["k_rope"][:, :S] = k_rope
    else:                                               # decode (absorbed)
        idx = int(cache_index)
        latent, k_rope = _mla_latent(cfg, p, x, positions)
        cache["latent"][:, idx] = latent[:, 0]
        cache["k_rope"][:, idx] = k_rope[:, 0]
        T = cache["latent"].shape[1]
        scale = 1.0 / math.sqrt(Dn + Dr)
        f32 = torch.float32
        # absorb w_uk into the query: (B,1,H,R)
        q_lat = torch.einsum("bshk,rhk->bshr", q_nope,
                             p["w_uk"].to(x.dtype))
        s = (torch.einsum("bshr,btr->bhst", q_lat.to(f32),
                          cache["latent"].to(f32))
             + torch.einsum("bshk,btk->bhst", q_rope.to(f32),
                            cache["k_rope"].to(f32))) * scale
        valid = torch.arange(T, device=x.device) <= idx
        s = torch.where(valid, s, NEG_INF)
        w = torch.softmax(s, dim=-1)
        o_lat = torch.einsum("bhst,btr->bshr", w.to(x.dtype),
                             cache["latent"])
        out = torch.einsum("bshr,rhk->bshk", o_lat, p["w_uv"].to(x.dtype))

    out = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
    return out, cache


def attn_apply(cfg, kind, p, x, positions, cache=None, cache_index=None):
    if cfg.mla:
        return mla_apply(cfg, p, x, positions, cache, cache_index)
    return gqa_apply(cfg, kind, p, x, positions, cache, cache_index)
