"""Plain PyTorch reference of the benchmark's decoder models: float32,
no kernels, no fusions, written from the model equations.

Weights are a params tree in the layout the benchmark draws them in
(``x @ w`` with ``w`` of shape ``(d_in, ..., d_out)``; attention
projections ``(d, heads, head_dim)``; experts stacked ``(E, d, F)``).
The configuration is read through its fields only.

``rnd`` is the precision knob of the control: the identity for the
reference itself; ``fp8`` rounds every matrix product's operands (and
the residual stream) to float8 e4m3 with a per-tensor scale, the step
below the bfloat16 activations the configurations state.

Equations (each layer): ``h += attn(rmsnorm(h))``, ``h += ffn(rmsnorm
(h))``; RMSNorm in f32 with a learned scale; rotary embedding on the two
halves of the head dim; causal softmax attention with grouped kv heads
(query head ``k * G + g`` reads kv head ``k``); DeepSeek's latent
attention (latent = RMSNorm(x W_dkv), one shared rotary key, k and v
from the latent); SwiGLU MLPs; MoE with a softmax router over all
experts, top-k (ties to the lower index), the top-k weights renormalised
to sum 1, a capacity of ``max(8, ceil8(int(1.25 k T / E)))`` entries an
expert filled first come first served in (token, slot) order over the
whole batch, overflow dropped, plus the shared experts; the head on the
final RMSNorm.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

F32 = torch.float32


def ident(x):
    return x


@contextlib.contextmanager
def exact_f32():
    """Float32 matrix products in float32, not TF32, while the block
    runs."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def fp8(x):
    """Round to float8 e4m3 with a per-tensor scale (amax to 448)."""
    x = x.to(F32)
    amax = x.detach().abs().max()
    scale = torch.where(amax > 0, amax / 448.0, torch.ones_like(amax))
    y = (x / scale).to(torch.float8_e4m3fn).to(F32) * scale
    return x + (y - x).detach()          # straight through for autograd


def _mm(rnd, a, w):
    return rnd(a) @ rnd(w.to(F32))


def rmsnorm(x, scale, eps):
    x = x.to(F32)
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) \
        * scale.to(F32)


def rope(x, positions, theta):
    """x (..., S, H, D); rotates the halves [x1, x2] of D."""
    D = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=F32,
                                          device=x.device) / D))
    ang = positions.to(F32)[:, None] * freqs              # (S, D/2)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _causal_attention(q, k, v, rnd, scale):
    """q (S,H,Dq), k (S,H,Dq), v (S,H,Dv) of one sequence -> (S,H,Dv)."""
    S = q.shape[0]
    s = torch.einsum("shd,thd->hst", rnd(q), rnd(k)) * scale
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("hst,thd->shd", rnd(p), rnd(v))


def gqa(cfg, p, x, positions, rnd):
    """-> (out (B,S,d), cache {'k', 'v'}: (B,S,K,D) after rope)."""
    B, S, _ = x.shape
    H, K, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = torch.einsum("bsd,dhk->bshk", rnd(x), rnd(p["wq"].to(F32)))
    k = torch.einsum("bsd,dhk->bshk", rnd(x), rnd(p["wk"].to(F32)))
    v = torch.einsum("bsd,dhk->bshk", rnd(x), rnd(p["wv"].to(F32)))
    q, k = rope(q, positions, cfg.rope_theta), rope(k, positions,
                                                    cfg.rope_theta)
    G = H // K
    rows = []
    for b in range(B):
        kb = k[b].repeat_interleave(G, dim=1)
        vb = v[b].repeat_interleave(G, dim=1)
        rows.append(_causal_attention(q[b], kb, vb, rnd,
                                      1.0 / math.sqrt(D)))
    o = torch.stack(rows)
    out = torch.einsum("bshk,hkd->bsd", rnd(o), rnd(p["wo"].to(F32)))
    return out, {"k": k, "v": v}


def mla(cfg, p, x, positions, rnd):
    """-> (out, cache {'latent': (B,S,R), 'k_rope': (B,S,Dr)})."""
    B, S, _ = x.shape
    H = cfg.n_heads
    Dn, Dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q = torch.einsum("bsd,dhk->bshk", rnd(x), rnd(p["wq"].to(F32)))
    q_nope, q_rope = q[..., :Dn], rope(q[..., Dn:], positions,
                                       cfg.rope_theta)
    latent = rmsnorm(_mm(rnd, x, p["w_dkv"]), p["latent_norm"],
                     cfg.norm_eps)
    k_rope = rope(_mm(rnd, x, p["w_kr"])[:, :, None, :], positions,
                  cfg.rope_theta)[:, :, 0, :]
    k_nope = torch.einsum("btr,rhk->bthk", rnd(latent),
                          rnd(p["w_uk"].to(F32)))
    v = torch.einsum("btr,rhk->bthk", rnd(latent), rnd(p["w_uv"].to(F32)))
    rows = []
    for b in range(B):
        kb = torch.cat([k_nope[b], k_rope[b][:, None, :].expand(S, H, Dr)],
                       dim=-1)
        qb = torch.cat([q_nope[b], q_rope[b]], dim=-1)
        rows.append(_causal_attention(qb, kb, v[b], rnd,
                                      1.0 / math.sqrt(Dn + Dr)))
    o = torch.stack(rows)
    out = torch.einsum("bshk,hkd->bsd", rnd(o), rnd(p["wo"].to(F32)))
    return out, {"latent": latent, "k_rope": k_rope}


def swiglu(p, x, rnd):
    g = F.silu(_mm(rnd, x, p["w_gate"]))
    u = _mm(rnd, x, p["w_up"])
    return _mm(rnd, g * u, p["w_down"])


def top_k_lower_first(gates, k):
    """Top-k along the last dim, ties to the lower index (a stable sort
    of the negated gates keeps equal gates in index order)."""
    order = torch.argsort(-gates, dim=-1, stable=True)
    idx = order[..., :k]
    return torch.gather(gates, -1, idx), idx


def moe(cfg, p, x, rnd, capacity_factor=1.25, stats=None):
    """x (B,S,d) -> (B,S,d); ``stats``, a dict, adds up the routed
    entries under 'entries' and those over capacity under 'dropped'."""
    B, S, d = x.shape
    T, E, k = B * S, cfg.n_experts, cfg.top_k
    xt = x.reshape(T, d)
    gates = torch.softmax(xt.to(F32) @ p["router"].to(F32), dim=-1)
    topw, topi = top_k_lower_first(gates, k)
    topw = topw / topw.sum(-1, keepdim=True).clamp_min(1e-9)
    C = int(capacity_factor * k * T / E)
    C = max(8, math.ceil(C / 8) * 8)
    flat_e = topi.reshape(-1)                      # (T*k,) in (token, slot)
    flat_w = topw.reshape(-1)
    tok = torch.arange(T * k, device=x.device) // k
    out = torch.zeros(T, d, dtype=F32, device=x.device)
    if stats is not None:
        load = torch.bincount(flat_e, minlength=E)
        stats["entries"] = stats.get("entries", 0) + T * k
        stats["dropped"] = stats.get("dropped", 0) + int(
            (load - C).clamp_min(0).sum())
    for e in range(E):
        entries = torch.nonzero(flat_e == e, as_tuple=True)[0][:C]
        if entries.numel() == 0:
            continue
        rows = tok[entries]
        w = {n: p[n][e] for n in ("w_gate", "w_up", "w_down")}
        y = swiglu(w, xt[rows], rnd)
        out = out.index_add(0, rows, y * flat_w[entries][:, None])
    if cfg.n_shared_experts:
        out = out + swiglu(p["shared"], xt, rnd)
    return out.reshape(B, S, d)


def block(cfg, params, i, h, positions, rnd, caches=None, moe_stats=None):
    """Layer i on the residual stream h (B,S,d) f32; ``caches``, a dict,
    receives its attention cache; ``moe_stats`` is handed to ``moe``."""
    pattern = list(zip(cfg.block_pattern or ("attn",) * cfg.n_layers,
                       cfg.ffn_pattern or ("dense",) * cfg.n_layers))
    mixer, ffn = pattern[i]
    if mixer != "attn":
        raise ValueError(f"no reference for mixer {mixer!r}")
    bp = params["blocks"][i]
    x = rmsnorm(h, bp["norm1"]["scale"], cfg.norm_eps)
    a, cache = (mla if cfg.mla else gqa)(cfg, bp["mixer"], x, positions,
                                         rnd)
    if caches is not None:
        caches[i] = cache
    h = rnd(h + a)
    x = rmsnorm(h, bp["norm2"]["scale"], cfg.norm_eps)
    if ffn == "dense":
        h = rnd(h + swiglu(bp["ffn"], x, rnd))
    elif ffn == "moe":
        h = rnd(h + moe(cfg, bp["ffn"], x, rnd, stats=moe_stats))
    return h


def blocks(cfg, params, h, lo, hi, positions, rnd, caches=None,
           record=None):
    """Layers [lo, hi) on the residual stream h (B,S,d) f32; ``caches``,
    a dict, receives each layer's attention cache, ``record``, a list,
    each layer's output. Under autograd each layer is recomputed in the
    backward pass (``torch.utils.checkpoint``): the same numbers, a
    layer's input held instead of its activations."""
    for i in range(lo, hi):
        if torch.is_grad_enabled() and h.requires_grad and caches is None:
            h = checkpoint(block, cfg, params, i, h, positions, rnd,
                           use_reentrant=False)
        else:
            h = block(cfg, params, i, h, positions, rnd, caches)
        if record is not None:
            record.append(h)
    return h


def embed(params, tokens):
    return params["embed"]["tok"][tokens].to(F32)


def head(cfg, params, h, rnd):
    x = rmsnorm(h, params["final_norm"]["scale"], cfg.norm_eps)
    w = (params["embed"]["tok"].T if cfg.tie_embeddings
         else params["head"]["w"])
    return _mm(rnd, x, w)


def prefill(cfg, params, tokens, rnd=ident, record=None):
    """-> (last position's logits (B, vocab_size) f32, {layer: cache});
    ``record``, a list, receives the embedding and each layer's
    output."""
    with torch.no_grad():
        S = tokens.shape[1]
        positions = torch.arange(S, device=tokens.device)
        caches = {}
        h = rnd(embed(params, tokens))
        if record is not None:
            record.append(h)
        h = blocks(cfg, params, h, 0, cfg.n_layers, positions, rnd, caches,
                   record)
        logits = last_logits(cfg, params, h, rnd)
    return logits, caches


def last_logits(cfg, params, h, rnd=ident):
    """The head at the last position: (B, vocab_size) f32."""
    return head(cfg, params, h[:, -1:], rnd)[:, 0, :cfg.vocab_size]


def cross_entropy(logits, labels, vocab_size):
    """Mean next-token CE over the first ``vocab_size`` logits."""
    lg = logits[..., :vocab_size].to(F32)
    return F.cross_entropy(lg.reshape(-1, vocab_size), labels.reshape(-1))
