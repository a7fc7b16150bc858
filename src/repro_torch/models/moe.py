"""Mixture-of-Experts FFN: top-k routing, shared experts, capacity-based
scatter dispatch with static shapes.

Positions-in-expert come from sort-based ranking, as in the reference:
a stable argsort of the (T*k,) expert assignments, ranks within runs
via searchsorted, then the inverse permutation. Dispatch and combine
are a scatter-add and a gather at (expert, slot). ``cfg.attn_impl ==
'pallas'`` sends the expert FFN through the ``moe_gmm`` kernel wrapper
(``kernels/moe_gmm``: its CUDA kernel on a CUDA tensor, its plain
version on a CPU tensor); ``'xla'`` runs the plain counterpart of the
reference's XLA path, which casts the weights to the activations'
dtype first.

The router's top-k is ``utils.topk.top_k``: ties go to the lower expert
index, as ``jax.lax.top_k`` breaks them (``torch.topk`` leaves them
open).
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.layers import activation, mlp
from repro_torch.models.params import ParamDef
from repro_torch.models.sharding import (constrain, laid_out,
                                        on_local_shards, whole)
from repro_torch.utils.topk import top_k


def moe_defs(cfg):
    d, E, F = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    defs = {
        "router": ParamDef((d, E), ("embed", "experts"), dtype="float32"),
        "w_gate": ParamDef((E, d, F), ("experts", "embed", "expert_ff")),
        "w_up": ParamDef((E, d, F), ("experts", "embed", "expert_ff")),
        "w_down": ParamDef((E, F, d), ("experts", "expert_ff", "embed")),
    }
    if cfg.n_shared_experts:
        Fs = cfg.moe_d_ff * cfg.n_shared_experts
        defs["shared"] = {
            "w_gate": ParamDef((d, Fs), ("embed", "ff")),
            "w_up": ParamDef((d, Fs), ("embed", "ff")),
            "w_down": ParamDef((Fs, d), ("ff", "embed")),
        }
    return defs


def _expert_ffn(p, x, act):
    """x: (E, C, d) -> (E, C, d), batched over experts."""
    actf = activation(act)
    g = actf(torch.einsum("ecd,edf->ecf", x, p["w_gate"].to(x.dtype)))
    u = torch.einsum("ecd,edf->ecf", x, p["w_up"].to(x.dtype))
    return torch.einsum("ecf,efd->ecd", g * u, p["w_down"].to(x.dtype))


def positions_in_expert(flat_e, E: int):
    """flat_e (G, N) expert ids -> (G, N) slot of each entry in its
    expert's bucket: 0, 1, ... in entry order within each row (a stable
    sort, run starts by searchsorted, the inverse permutation)."""
    flat_e = whole(flat_e)          # on a mesh: DTensor has no searchsorted
    G, N = flat_e.shape
    dev = flat_e.device
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    starts = torch.searchsorted(
        sorted_e, torch.arange(E, device=dev).expand(G, E).contiguous())
    rank_sorted = (torch.arange(N, device=dev)
                   - torch.gather(starts, 1, sorted_e))
    return torch.empty_like(flat_e).scatter(1, order, rank_sorted)


def _dispatch_combine(cfg, p, xt, *, capacity_factor: float):
    """Dispatch -> expert FFN -> combine for G token slabs xt (G, T, d),
    each bucketed on its own (capacity per slab, drops decided locally).
    Positions are first-come-first-served in token order (sort-based).
    Returns (out (G, T, d), aux (G,))."""
    G, T, d = xt.shape
    E, k = cfg.n_experts, cfg.top_k
    dev = xt.device

    logits = xt.to(torch.float32) @ p["router"]          # (G, T, E) f32
    gates = torch.softmax(logits, dim=-1)
    topw, topi = top_k(gates, k)                         # (G, T, k)
    topw = topw / torch.clamp_min(topw.sum(-1, keepdim=True), 1e-9)

    # load-balance aux loss (Switch-style): E * sum_e f_e * P_e
    # (a scatter-add of ones, as the reference's .at[].add: torch.func.vmap
    # has no batching rule for bincount)
    counts = torch.zeros((G, E), dtype=torch.float32, device=dev).scatter_add(
        1, topi.reshape(G, -1), torch.ones(topi.reshape(G, -1).shape,
                                           dtype=torch.float32, device=dev))
    density = counts / (T * k)
    aux = (E * torch.sum(density * gates.mean(1), dim=-1)
           * cfg.router_aux_coef)

    C = int(capacity_factor * k * T / E)
    C = max(8, math.ceil(C / 8) * 8)
    slabs = {"slabs": 0}
    experts = {"experts": 0}
    w = {n: p[n] for n in ("w_gate", "w_up", "w_down")}

    def local(xt, topw, topi, w_gate, w_up, w_down, *, starts):
        return _dispatch_local(
            cfg, xt, topw, topi, {"w_gate": w_gate, "w_up": w_up,
                                  "w_down": w_down},
            C, starts.get("experts", 0))

    out = on_local_shards(
        local, (xt, topw, topi, w["w_gate"], w["w_up"], w["w_down"]),
        (slabs, slabs, slabs, experts, experts, experts),
        {"slabs": 0, "partial": ("experts",)})
    return out, aux


def _dispatch_local(cfg, xt, topw, topi, w, C: int, e0: int):
    """Dispatch -> expert FFN -> combine on plain tensors, for the
    experts ``e0, e0 + 1, ...`` whose weights ``w`` holds (all of
    ``cfg.n_experts`` off a mesh): an entry routed elsewhere adds nothing
    here (on a device mesh another rank holds its expert, and the
    combines are summed over ranks)."""
    G, T, d = xt.shape
    E, k = cfg.n_experts, cfg.top_k
    n_local = w["w_gate"].shape[0]
    dev = xt.device
    flat_e = topi.reshape(G, -1)                         # (G, T*k)
    N = flat_e.shape[1]
    flat_pos = positions_in_expert(flat_e, E)
    keep = flat_pos < C                                  # overflow dropped
    safe_e = flat_e
    if n_local < E:                      # on a mesh: this rank's experts
        mine = (flat_e >= e0) & (flat_e < e0 + n_local)
        keep = keep & mine
        safe_e = torch.where(mine, flat_e - e0, 0)
    safe_pos = torch.where(keep, flat_pos, C - 1)
    g_idx = torch.arange(G, device=dev)[:, None].expand(G, N)
    x_rep = xt.repeat_interleave(k, dim=1)               # (G, T*k, d)
    # out of place: torch.func.vmap (the multi-group server step) cannot
    # scatter a batched source into this unbatched buffer in place
    exp_in = torch.zeros((G, n_local, C, d), dtype=xt.dtype,
                         device=dev).index_put(
        (g_idx, safe_e, safe_pos),
        torch.where(keep[..., None], x_rep, 0).to(xt.dtype), accumulate=True)

    # the slabs' buckets of one expert side by side: (E, G*C, d), one
    # expert FFN call for all slabs (rows are independent)
    exp_in = exp_in.transpose(0, 1).reshape(n_local, G * C, d)
    if cfg.attn_impl == "pallas":
        from repro_torch.kernels.moe_gmm import ops as gmm_ops
        exp_out = gmm_ops.expert_ffn(w, exp_in, cfg.act)
    else:
        exp_out = _expert_ffn(w, exp_in, cfg.act)
    exp_out = exp_out.reshape(n_local, G, C, d).transpose(0, 1)

    gathered = exp_out[g_idx, safe_e, safe_pos]          # (G, T*k, d)
    gathered = torch.where(keep[..., None], gathered, 0)
    wk = topw.reshape(G, -1).to(xt.dtype)
    return (gathered * wk[..., None]).reshape(G, T, k, d).sum(dim=2)


def moe_apply(cfg, p, x, *, capacity_factor: float = 1.25):
    """x: (B,S,d). Returns (out, aux_loss).

    When ``cfg.moe_dispatch_shards > 1`` (and divides the batch), tokens
    are bucketed per shard, as the reference's pod-scale dispatch does:
    the batch is viewed as (shards, T/shards, d) and the ranking,
    scatter and gather run over a leading shard dim, so capacity is per
    shard and drop decisions are local. On a device mesh the shard dim
    is laid over ``cfg.moe_dispatch_axes`` (where the reference pins it
    with ``with_sharding_constraint``); the numbers do not depend on it.
    """
    B, S, d = x.shape
    T = B * S
    shards = getattr(cfg, "moe_dispatch_shards", 0) or 1
    if shards > 1 and B % shards == 0:
        axes = tuple(getattr(cfg, "moe_dispatch_axes", ()))
        pin = ((lambda v: constrain(v, (axes, None, None))) if axes
               else (lambda v: v))
        out, aux = _dispatch_combine(
            cfg, p, pin(pin(x).reshape(shards, T // shards, d)),
            capacity_factor=capacity_factor)
        out, aux = _rows_of(pin(out).reshape(T, d), x), aux.mean()
    else:
        out, aux = _dispatch_combine(cfg, p, x.reshape(1, T, d),
                                     capacity_factor=capacity_factor)
        out, aux = out[0], aux[0]

    if cfg.n_shared_experts:
        out = out + mlp(p["shared"], _rows_of(x.reshape(T, d), x), cfg.act)
    return _rows_of(out, x).reshape(B, S, d), aux


def _rows_of(t, x):
    """Tokens ``t`` (T, d) of ``x`` (B, S, d), laid out as x is: the token
    dim sharded where x's batch dim is, d where x's d is, nothing else,
    and its gradient back as ``t`` is (``laid_out``). On a device mesh
    DTensor may shard the token dim over two mesh dims, which a view to
    or from (B, S, d) cannot split at B; this layout it can. Anything
    but a DTensor is returned as it is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(t, DTensor):
        return t
    keep = {0: Shard(0), 2: Shard(1)}
    pl = [keep.get(p.dim, Replicate()) if isinstance(p, Shard)
          else Replicate() for p in getattr(
              x, "placements", [Replicate()] * t.device_mesh.ndim)]
    return laid_out(t, pl)
