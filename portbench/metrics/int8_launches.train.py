"""Launches of the int8 quantize and dequantize kernels a round, from
the kernels' own launch counters (an exact count)."""


def read(run):
    ctx = run.context
    n = ctx.get("launches", {})
    total = n.get("int8_quantize", 0) + n.get("int8_dequantize", 0)
    if not total or not ctx.get("rounds"):
        return None
    return total / ctx["rounds"]
