"""The window's useful training FLOPs (the yardstick's 6·N·D over the
blocks and the head, plus three times the causal attention core) over
its device-trace length, against the bf16 dense peak, %."""
from portbench import yardstick


def read(run):
    ctx, tr = run.context, run.trace
    if tr is None or not tr.kernels or not ctx.get("tokens"):
        return None
    S = ctx["seq_len"]
    flops = yardstick.train_flops(ctx["cfg"], ctx["tokens"] // S, S)
    return yardstick.pct(flops / tr.window_s / yardstick.PEAK_BF16_FLOPS)
