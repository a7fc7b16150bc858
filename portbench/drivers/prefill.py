"""Batched prefill through ``repro_torch.models.transformer.prefill``
(the first step of ``launch/serve.py``'s ``generate``), a closed loop of
batches of prompts.

Set-up draws the weights and the window's prompt batches from the seed
and runs two prefills (the first builds the kernels). The window sends
batch after batch until the time is up; a request is one prompt, its
time to first token runs from its batch's dispatch to its last-position
logits on the host.

``correct``: one call among the window's first four, drawn from the
seed, keeps its caches and the residual stream between its layers (the
input of layer 0 and each layer's output, recorded as the port's layer
loop hands them on). After the window the plain reference checks that
call layer by layer from the port's own stream: the embedding of the
prompts, each layer's update of the stream and its cache, and the head's
logits of every request of the call. Where the mix sets
``whole_forward``, the reference also runs the whole forward from the
prompt tokens alone and holds the call's caches and logits to it. A mix
with an MoE layer does not: the router's top-k and capacity are
discontinuous, so at deepseek's depth a rounding difference of one layer
changes some tokens' experts and the difference grows through the later
layers, in float32 too. Its check logs the share of routed entries that
the reference drops over capacity, as the port's capacity rule drops
them.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import sys
import time

import numpy as np
import torch

from portbench import tracing, traffic, weights
from portbench.cell import Check, Outcome
from portbench.reference import lm as ref

RANGES = (
    ("repro_torch.models.transformer", "apply_embed", "embed"),
    ("repro_torch.models.attention", "attn_apply", "attention"),
    ("repro_torch.models.transformer", "mlp", "mlp"),
    ("repro_torch.models.moe", "moe_apply", "moe"),
    ("repro_torch.models.transformer", "apply_head", "head"),
)
CHECK_AMONG = 4          # the checked call is one of the window's first


def _recording_blocks(stream: list):
    """``_apply_block_kind`` of the port's transformer, wrapped to append
    its input (first layer only) and its output stream to ``stream``."""
    from repro_torch.models import transformer as tf
    inner = tf._apply_block_kind

    def wrapped(cfg, mixer, ffn, bp, shared, h, *a, **kw):
        if not stream:
            stream.append(h)
        out = inner(cfg, mixer, ffn, bp, shared, h, *a, **kw)
        stream.append(out[0])
        return out
    return inner, wrapped


def run(cell, cfg, seed, seconds, trace, device, t_process, *,
        break_step=None):
    """One run of the cell. ``break_step`` (tests and calibration only)
    wraps the prefill the window calls, to plant a fault in the timed
    path."""
    from repro_torch.models import transformer as tf
    mix = cell.mix
    cfg = dataclasses.replace(cfg, attn_impl=mix["attn_impl"],
                              param_dtype=mix["param_dtype"])
    B, S = mix["batch"], mix["prompt_len"]
    max_len = S + mix["decode_budget"]
    V = cfg.vocab_size
    params = weights.make_weights(tf.model_defs(cfg), seed, cfg.param_dtype,
                                  device)
    prompts = traffic.prompt_batches(mix, seed, V, device)
    checked = int(np.random.default_rng(seed).integers(0, CHECK_AMONG))
    prefill = tf.prefill if break_step is None else break_step(tf.prefill)

    def call(i):
        logits, caches, _ = prefill(cfg, params, prompts[i % len(prompts)],
                                    max_len)
        return logits[:, -1, :V].float().cpu(), caches

    with torch.no_grad():
        for i in range(2):                     # build and warm the kernels
            call(i)
        if device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()

        outs, ttft, kept = [], [], None
        with tracing.traced(trace, RANGES) as (rec, prof):
            with rec.span("window"):
                setup_s = time.perf_counter() - t_process
                t0 = time.perf_counter()
                i = 0
                while True:
                    stream = []
                    if i == checked:
                        inner, tf._apply_block_kind = \
                            _recording_blocks(stream)
                    with rec.span("request"):
                        ts = time.perf_counter()
                        last, caches = call(i)
                        te = time.perf_counter()
                    if i == checked:
                        tf._apply_block_kind = inner
                        kept = (caches, stream)
                    ttft += [te - ts] * B
                    outs.append(last)
                    del caches, stream
                    i += 1
                    if te - t0 >= seconds and i > checked:
                        break
                wall = time.perf_counter() - t0
    calls = len(outs)
    peak = (torch.cuda.max_memory_allocated() if device.type == "cuda"
            else 0)
    failed = sum(int((~torch.isfinite(o)).any(dim=1).sum()) for o in outs)
    trace_out = tracing.trace_of(prof, rec) if trace else None
    caches, stream = kept
    del kept
    if device.type == "cuda":
        torch.cuda.empty_cache()
    tokens = prompts[checked % len(prompts)]
    values = readings(cfg, params, tokens, outs[checked], caches, stream,
                      whole_forward=mix.get("whole_forward", False))
    del caches, stream
    gc.collect()
    return Outcome(
        e2e={"prefill_tokens_per_s": calls * B * S / wall,
             "ttft_p90_ms": 1e3 * p90(ttft)},
        setup_s=setup_s, attempted=calls * B, failed=failed,
        checks=[Check(n, v, float(cell.limits[n])) for n, v in values],
        memory_peak_bytes=peak, trace=trace_out,
        context={"kind": "prefill", "cfg": cfg, "calls": calls, "batch": B,
                 "prompt_len": S, "wall_s": wall,
                 "steps_s": ttft[::B]})


def p90(values) -> float:
    """The 90th percentile by nearest rank: the smallest value that at
    least 90 % of the values do not exceed."""
    v = sorted(values)
    return v[max(0, math.ceil(0.9 * len(v)) - 1)]


def rel_err(a, b) -> float:
    """||a - b|| / ||b|| in float64; infinite where the shapes differ."""
    if a.shape != b.shape:
        return math.inf
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def worst_row_err(a, b) -> float:
    """The worst row's ||a_i - b_i|| / ||b_i|| of (rows, vocab) logits:
    each request's answer on its own."""
    if a.shape != b.shape:
        return math.inf
    a, b = a.double(), b.double()
    return float((torch.linalg.vector_norm(a - b, dim=-1)
                  / torch.linalg.vector_norm(b, dim=-1)).max())


def readings(cfg, params, tokens, logits, caches, stream, *,
             whole_forward=False) -> list:
    """[(name, value)] of one call, the reference following the port's
    stream layer by layer: the embedding's relative error; the worst
    layer's relative error of its update of the stream and of its cache
    tensors (over the prompt's positions); the worst request's relative
    error of its last-position logits. With ``whole_forward`` also the
    worst layer's cache tensor and the worst request's logits against
    the reference's whole forward from the prompt tokens."""
    S = tokens.shape[1]
    pos = torch.arange(S, device=tokens.device)
    stats = {}
    with ref.exact_f32(), torch.no_grad():
        embed = rel_err(stream[0].float(), ref.embed(params, tokens))
        layer = cache = 0.0
        for i in range(cfg.n_layers):
            h_in = stream[i].float()
            got = {}
            out = ref.block(cfg, params, i, h_in, pos, ref.ident, got,
                            moe_stats=stats)
            layer = max(layer, rel_err(stream[i + 1].float() - h_in,
                                       out - h_in))
            cache = max(cache, _cache_err(caches[i], got[i], S))
            del out, got
        head = ref.last_logits(cfg, params, stream[-1].float())
        logit = worst_row_err(logits, head.cpu())
        out = [("embed_err", embed), ("layer_err", layer),
               ("cache_err", cache), ("logits_err", logit)]
        if whole_forward:
            out += _whole_forward(cfg, params, tokens, logits, caches)
    if stats.get("entries"):
        print(f"moe: the reference drops {stats['dropped']} of "
              f"{stats['entries']} routed entries over capacity "
              f"({stats['dropped'] / stats['entries']!r} of them)",
              file=sys.stderr)
    return out


def _cache_err(port: dict, want: dict, S: int) -> float:
    """The worst relative error of one layer's cache tensors over the
    prompt's positions."""
    return max(rel_err(port[name][:, :S].float(), t)
               for name, t in want.items())


def _whole_forward(cfg, params, tokens, logits, caches) -> list:
    """The call's caches and logits against the reference's whole
    forward from the prompt tokens, layer by layer."""
    S = tokens.shape[1]
    pos = torch.arange(S, device=tokens.device)
    h = ref.embed(params, tokens)
    cache = 0.0
    for i in range(cfg.n_layers):
        got = {}
        h = ref.block(cfg, params, i, h, pos, ref.ident, got)
        cache = max(cache, _cache_err(caches[i], got[i], S))
        del got
    head = ref.last_logits(cfg, params, h)
    return [("fwd_cache_err", cache),
            ("fwd_logits_err", worst_row_err(logits, head.cpu()))]


def control_readings(cell, cfg, seed, device) -> list:
    """The control: the reference in float8 (e4m3, per-tensor scales) in
    the program's place, on the seed's weights and the window's first
    batch, judged as a run is."""
    from repro_torch.models.transformer import model_defs
    cfg = dataclasses.replace(cfg, attn_impl=cell.mix["attn_impl"],
                              param_dtype=cell.mix["param_dtype"])
    params = weights.make_weights(model_defs(cfg), seed, cfg.param_dtype,
                                  device)
    tokens = traffic.prompt_batches(cell.mix, seed, cfg.vocab_size,
                                    device)[0]
    stream = []
    with ref.exact_f32():
        logits, caches = ref.prefill(cfg, params, tokens, ref.fp8, stream)
    caches = [caches[i] for i in range(cfg.n_layers)]
    return readings(cfg, params, tokens, logits.cpu(), caches, stream,
                    whole_forward=cell.mix.get("whole_forward", False))
