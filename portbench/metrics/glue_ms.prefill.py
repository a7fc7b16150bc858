"""Device ms a prefill in kernels that are neither cuBLAS's nor the
port's hand-written ones: norms, rotary, gates, casts, MoE dispatch."""
from portbench.metrics_common import glue_ms


def read(run):
    return glue_ms(run, "calls")
