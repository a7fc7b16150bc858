"""Device ms a round in kernels that are neither cuBLAS's nor the port's
hand-written ones: the round loop's parameter-tree glue."""
from portbench.metrics_common import glue_ms


def read(run):
    return glue_ms(run, "rounds")
