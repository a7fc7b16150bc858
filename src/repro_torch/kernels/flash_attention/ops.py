"""Model-layout adapter around the flash attention kernel."""
from __future__ import annotations

from repro_torch.kernels.flash_attention.kernel import flash_attention_bhsd


def flash_attention(q, k, v, q_pos=None, k_pos=None, *, window: int = 0,
                    causal: bool = True):
    """Model layout: q (B,S,H,D), k/v (B,T,K,D) -> (B,S,H,Dv).

    Assumes contiguous positions starting at 0 (train/prefill paths), as
    the reference's adapter does: ``q_pos`` / ``k_pos`` are not read.
    The heads keep the reference's (K, G) order, so q head k*G + g reads
    kv head k; the kernel reads the (B,S,H,D) tensors through strides.
    Plain tensors only (a kernel reads raw device pointers): on a device
    mesh ``attention.grouped_attention`` calls this on each rank's local
    rows and heads.
    """
    out = flash_attention_bhsd(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=causal,
                               window=window)
    return out.transpose(1, 2)
