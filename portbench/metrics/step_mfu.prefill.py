"""The window's useful prefill FLOPs (2·N_body a token, the causal
attention core, the head at the last position) over its device-trace
length, against the bf16 dense peak, %."""
from portbench import yardstick


def read(run):
    ctx, tr = run.context, run.trace
    if tr is None or not tr.kernels or not ctx.get("calls"):
        return None
    flops = ctx["calls"] * yardstick.prefill_flops(
        ctx["cfg"], ctx["batch"], ctx["prompt_len"])
    return yardstick.pct(flops / tr.window_s / yardstick.PEAK_BF16_FLOPS)
