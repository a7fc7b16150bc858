"""Mamba2 / SSD (state-space duality) block [arXiv:2405.21060].

Chunked dual form for train/prefill and O(1)-state recurrent decode.
``ssd_scan_ref`` here is the model's own oracle (the reference's pure-jnp
chunked scan, its ``lax.scan`` over chunks a loop, its state carried in
x's dtype); ``cfg.attn_impl == 'pallas'`` routes the core scan through
the SSD kernel wrapper (``kernels/ssd_scan``: its CUDA kernel on a CUDA
tensor, its plain version on a CPU tensor, state carried in f32).

Single-group SSD: in_proj split into separate z / x / B / C / dt
projections, as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import rmsnorm
from repro_torch.models.params import ParamDef


def ssm_defs(cfg):
    d, di, N, Hs = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    ck = cfg.ssm_conv
    return {
        "wz": ParamDef((d, di), ("embed", "ssm_inner")),
        "wx": ParamDef((d, di), ("embed", "ssm_inner")),
        "wB": ParamDef((d, N), ("embed", "ssm_state")),
        "wC": ParamDef((d, N), ("embed", "ssm_state")),
        "wdt": ParamDef((d, Hs), ("embed", "ssm_heads")),
        "conv_x": ParamDef((ck, di), ("conv_k", "ssm_inner"), init="normal",
                           scale=0.5),
        "conv_B": ParamDef((ck, N), ("conv_k", "ssm_state"), init="normal",
                           scale=0.5),
        "conv_C": ParamDef((ck, N), ("conv_k", "ssm_state"), init="normal",
                           scale=0.5),
        "A_log": ParamDef((Hs,), ("ssm_heads",), init="ssm_a", dtype="float32"),
        "D": ParamDef((Hs,), ("ssm_heads",), init="ones", dtype="float32"),
        "dt_bias": ParamDef((Hs,), ("ssm_heads",), init="ssm_dt",
                            dtype="float32"),
        "norm": ParamDef((di,), ("ssm_inner",), init="ones"),
        "wo": ParamDef((di, d), ("ssm_inner", "embed")),
    }


# ---------------------------------------------------------------------------
# causal depthwise conv
# ---------------------------------------------------------------------------
def _causal_conv(x, w, conv_state=None):
    """x: (B,S,C), w: (k,C) depthwise causal conv. conv_state (B,k-1,C) is
    the tail of the previous segment (decode); returns (y, new_state)."""
    k = w.shape[0]
    if conv_state is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                     # (B, S+k-1, C)
    S = x.shape[1]
    y = xp[:, 0:S] * w[0][None, None]
    for i in range(1, k):
        y = y + xp[:, i:i + S] * w[i][None, None]
    new_state = xp[:, -(k - 1):] if k > 1 else pad
    return y, new_state


# ---------------------------------------------------------------------------
# SSD chunked scan (the model's oracle)
# ---------------------------------------------------------------------------
def _segsum(x):
    """x: (..., L). Returns (..., L, L): out[k, j] = sum_{j < i <= k} x_i
    on and below the diagonal, -inf above."""
    L = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    return torch.where(mask, out, float("-inf"))


def ssd_scan_ref(x, dt, A, B, C, chunk: int, initial_state=None):
    """SSD chunked dual form.

    x:  (b, s, h, p)  inputs per head
    dt: (b, s, h)     softplus-ed step sizes (>0)
    A:  (h,)          negative decay rates
    B:  (b, s, n)     input projection (single group)
    C:  (b, s, n)     output projection
    Returns (y (b,s,h,p), final_state (b,h,p,n)).

    On DTensors each rank scans its own batch rows and heads
    (``_on_rows_and_heads``).
    """
    return _on_rows_and_heads(
        lambda *a: _ssd_scan_chunks(*a, chunk=chunk),
        x, dt, A, B, C, initial_state)


def _on_rows_and_heads(scan, x, dt, A, B, C, initial_state):
    """``scan(x, dt, A, B, C, initial_state)`` of plain tensors; on
    DTensors each rank runs it on its own batch rows and heads
    (``on_local_shards``): every (row, head) is scanned as in the whole
    tensors, B and C whole over the heads' mesh dim."""
    from repro_torch.models.sharding import on_local_shards
    rows = {"batch": 0}
    heads = {"batch": 0, "heads": 2}
    return on_local_shards(
        lambda *a, starts: scan(*a), (x, dt, A, B, C, initial_state),
        (heads, heads, {"heads": 0}, rows, rows, {"batch": 0, "heads": 1}),
        [heads, {"batch": 0, "heads": 1}])


def _ssd_scan_chunks(x, dt, A, B, C, initial_state, *, chunk: int):
    """``ssd_scan_ref`` on plain tensors."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    if s % chunk:
        raise ValueError(f"ssd_scan_ref: s={s} % chunk={chunk} != 0")
    c, l = s // chunk, chunk
    xc = x.reshape(b, c, l, h, p)
    dtc = dt.reshape(b, c, l, h)
    Bc = B.reshape(b, c, l, n)
    Cc = C.reshape(b, c, l, n)

    dA = dtc * A[None, None, None]                       # (b,c,l,h) <= 0
    dA_cs = torch.cumsum(dA, dim=2)                      # within-chunk cumsum

    # 1) intra-chunk (quadratic within chunk)
    L = torch.exp(_segsum(torch.movedim(dA, 2, -1)))     # (b,c,h,l,l)
    scores = torch.einsum("bcln,bcmn->bclm", Cc, Bc)     # (b,c,l,l)
    W = L * scores[:, :, None, :, :]                     # (b,c,h,l,m)
    y_diag = torch.einsum("bchlm,bcmh,bcmhp->bclhp", W.to(x.dtype),
                          dtc.to(x.dtype), xc)

    # 2) chunk states: state_c = sum_m exp(sum_{i>m} dA_i) * dt_m B_m x_m
    decay_tail = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)  # (b,c,l,h)
    states = torch.einsum("bclh,bcln,bclhp->bchpn",
                          (decay_tail * dtc).to(x.dtype), Bc, xc)

    # 3) inter-chunk recurrence over c (emits the PREVIOUS state)
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])          # (b,c,h)
    carry = (torch.zeros((b, h, p, n), dtype=x.dtype, device=x.device)
             if initial_state is None else initial_state)
    prev = []
    for ci in range(c):
        prev.append(carry)
        carry = (carry * chunk_decay[:, ci, :, None, None].to(x.dtype)
                 + states[:, ci])
    prev_states = torch.stack(prev, dim=1)               # (b,c,h,p,n)

    # 4) inter-chunk output: y_off = C_l . (exp(dA_cs_l) * prev_state)
    in_decay = torch.exp(dA_cs)                          # (b,c,l,h)
    y_off = torch.einsum("bcln,bchpn,bclh->bclhp", Cc, prev_states,
                         in_decay.to(x.dtype))

    y = (y_diag + y_off).reshape(b, s, h, p)
    return y, carry


def ssd_decode_step(x, dt, A, B, C, state):
    """One-token recurrence. x: (b,1,h,p), dt: (b,1,h), B/C: (b,1,n),
    state: (b,h,p,n). y = C . state' (the caller adds the D skip)."""
    dA = torch.exp(dt[:, 0] * A[None])                   # (b,h)
    upd = torch.einsum("bh,bn,bhp->bhpn", dt[:, 0].to(x.dtype), B[:, 0],
                       x[:, 0])
    state = state * dA[..., None, None].to(x.dtype) + upd
    y = torch.einsum("bn,bhpn->bhp", C[:, 0], state)[:, None]
    return y, state


# ---------------------------------------------------------------------------
# full block
# ---------------------------------------------------------------------------
def init_ssm_cache(cfg, batch: int, dtype, device):
    di, N, Hs, ck = (cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads,
                     cfg.ssm_conv)

    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)
    return {"state": z(batch, Hs, cfg.ssm_head_dim, N),
            "conv_x": z(batch, ck - 1, di), "conv_B": z(batch, ck - 1, N),
            "conv_C": z(batch, ck - 1, N)}


def ssm_apply(cfg, p, x_in, cache=None):
    """Mamba2 block. x_in: (B,S,d). Returns (out, new_cache)."""
    B_, S, d = x_in.shape
    Hs, P_ = cfg.n_ssm_heads, cfg.ssm_head_dim

    z = x_in @ p["wz"].to(x_in.dtype)
    x = x_in @ p["wx"].to(x_in.dtype)
    Bp = x_in @ p["wB"].to(x_in.dtype)
    Cp = x_in @ p["wC"].to(x_in.dtype)
    dt_raw = x_in @ p["wdt"].to(x_in.dtype)

    cs_x = cache["conv_x"] if cache else None
    cs_B = cache["conv_B"] if cache else None
    cs_C = cache["conv_C"] if cache else None
    x, ns_x = _causal_conv(x, p["conv_x"].to(x.dtype), cs_x)
    Bp, ns_B = _causal_conv(Bp, p["conv_B"].to(x.dtype), cs_B)
    Cp, ns_C = _causal_conv(Cp, p["conv_C"].to(x.dtype), cs_C)
    x, Bp, Cp = F.silu(x), F.silu(Bp), F.silu(Cp)

    dt = F.softplus(dt_raw.to(torch.float32)
                    + p["dt_bias"][None, None])           # (B,S,Hs) f32
    A = -torch.exp(p["A_log"])                           # (Hs,) negative
    xh = x.reshape(B_, S, Hs, P_)

    if cache is None or S > 1:
        pad = (-S) % cfg.ssm_chunk                       # zero-pad to chunks
        if pad:
            xh_p = F.pad(xh, (0, 0, 0, 0, 0, pad))
            dt_p = F.pad(dt, (0, 0, 0, pad))
            B_p = F.pad(Bp, (0, 0, 0, pad))
            C_p = F.pad(Cp, (0, 0, 0, pad))
        else:
            xh_p, dt_p, B_p, C_p = xh, dt, Bp, Cp
        init = cache["state"] if cache else None
        if cfg.attn_impl == "pallas":
            from repro_torch.kernels.ssd_scan import ops as ssd_ops
            y, state = _on_rows_and_heads(
                lambda x, dt, A, B, C, init: ssd_ops.ssd_scan(
                    x, dt, A, B, C, chunk=cfg.ssm_chunk,
                    initial_state=init),
                xh_p, dt_p, A, B_p, C_p, init)
        else:
            y, state = ssd_scan_ref(xh_p, dt_p, A, B_p, C_p,
                                    chunk=cfg.ssm_chunk, initial_state=init)
        y = y[:, :S]
    else:
        y, state = ssd_decode_step(xh, dt, A, Bp, Cp, cache["state"])

    y = y + xh * p["D"][None, None, :, None].to(y.dtype)
    y = y.reshape(B_, S, cfg.d_inner)
    y = rmsnorm({"scale": p["norm"]}, y, cfg.norm_eps) * F.silu(z)
    out = y @ p["wo"].to(y.dtype)

    new_cache = None
    if cache is not None:
        new_cache = {"state": state, "conv_x": ns_x, "conv_B": ns_B,
                     "conv_C": ns_C}
    return out, new_cache
